"""Spans and counters inside the port's frame.

``span(name)`` brackets a piece of work. It records its name, its parent
span (a stack per thread), the step it belongs to, its host start and end
by ``time.time_ns()`` (the clock on which ``torch.profiler`` stamps its
CPU events, so spans line up with a trace), and, on a CUDA device, a pair
of timing events recorded on the current stream. The events' elapsed time
is the span's stream ms: the time the stream took from finishing the work
queued before the span to finishing the span's own. On the CPU the work
is synchronous and the stream ms is the host's.

``step(device)`` opens a step: every span of one ``render_step`` call
shares its id. A span or a count outside any step is a step of its own.
Events are read without a synchronise: at each step's entry, the closed
steps whose end events report done (``query()``) are turned into
milliseconds. ``flush()`` resolves every closed step and may synchronise;
it is for readers that run after the work. The last WINDOW resolved steps
are kept (``steps()``), each with its records, a span's self stream ms
being its stream ms less its children's, and its counters; ``records()``
joins them with a profiler trace (``attribute``).

``count(name, n)`` adds ``n`` to the open step's counter ``name``. A
device whose event pool is spent keeps host times only, and the step's
counter ``spans_dropped`` counts the spans.

Recording is on by default; ``enable(False)`` leaves one flag check a
span. Nothing here emits a profiler range or marker: a trace holds only
the runtime's own ``cudaEventRecord`` calls.
"""

from __future__ import annotations

import bisect
import itertools
import threading
import time
from collections import deque
from typing import NamedTuple, Optional

import torch

# resolved steps kept
WINDOW = 64
# timing events a device may hold: a frame records about 80, and a step
# gives its events back once its work is done
POOL_EVENTS = 4096
# the CUDA runtime's calls that launch work, and those at which the host
# waits for the device
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaGraphLaunch")
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")


class Record(NamedTuple):
    """One resolved span. ``stream_ms`` is None where the pool was spent;
    ``self_ms`` is stream_ms less the children's."""

    name: str
    parent: Optional[str]
    step: int
    start_ns: int
    end_ns: int
    stream_ms: Optional[float]
    self_ms: Optional[float]

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6


class Step(NamedTuple):
    """One resolved step: its id, its spans' records in the order they
    opened, and its counters."""

    id: int
    records: list
    counters: dict


_enabled = True
_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count()
_pending: list = []
_history: deque = deque(maxlen=WINDOW)
_free: dict = {}
_made: dict = {}


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = bool(on)


def enabled() -> bool:
    return _enabled


def reset() -> None:
    """Forget every step (open steps record on; their events are not given
    back)."""
    with _lock:
        _pending.clear()
        _history.clear()


class _Step:
    __slots__ = ("id", "cuda", "spans", "stack", "counters")

    def __init__(self, device):
        self.id = next(_ids)
        self.cuda = _cuda_index(device)
        self.spans: list = []
        self.stack: list = []
        self.counters: dict = {}


def _cuda_index(device) -> Optional[int]:
    """The CUDA device index of ``device`` (None: the current CUDA device
    once CUDA is in use); None on the CPU."""
    if device is None:
        return torch.cuda.current_device() if torch.cuda.is_initialized() else None
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return device.index if device.index is not None else torch.cuda.current_device()


def _acquire(index: int, st: _Step):
    """Two timing events of device ``index`` from its pool, or None when
    the pool is spent (counted in ``st``)."""
    with _lock:
        free = _free.setdefault(index, [])
        if len(free) >= 2:
            return free.pop(), free.pop()
        if _made.get(index, 0) + 2 > POOL_EVENTS:
            st.counters["spans_dropped"] = st.counters.get("spans_dropped", 0) + 1
            return None
        _made[index] = _made.get(index, 0) + 2
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


class _Span:
    __slots__ = ("name", "device", "parent", "start_ns", "end_ns", "events",
                 "index", "step", "owns")

    def __init__(self, name: str, device):
        self.name = name
        self.device = device

    def __enter__(self):
        st = getattr(_local, "step", None)
        self.owns = st is None
        if self.owns:
            resolve()
            st = _local.step = _Step(self.device)
        self.step = st
        self.parent = st.stack[-1] if st.stack else None
        index = st.cuda if self.device is None else _cuda_index(self.device)
        self.index = index
        self.events = None if index is None else _acquire(index, st)
        self.start_ns = time.time_ns()
        if self.events is not None:
            self.events[0].record(torch.cuda.current_stream(index))
        st.stack.append(self)
        st.spans.append(self)
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(self.index))
        self.end_ns = time.time_ns()
        st = self.step
        st.stack.pop()
        if self.owns:
            _local.step = None
            _close(st)
        return False


class _Null:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def span(name: str, device=None):
    """A context manager that records the work inside it as the span
    ``name``. ``device``: where its events are recorded (default: the
    step's device)."""
    if not _enabled:
        return _NULL
    return _Span(name, device)


class _StepScope:
    __slots__ = ("device", "opened")

    def __init__(self, device):
        self.device = device

    def __enter__(self) -> Optional[int]:
        self.opened = None
        if not _enabled:
            return None
        st = getattr(_local, "step", None)
        if st is not None:
            return st.id
        resolve()
        self.opened = _local.step = _Step(self.device)
        return self.opened.id

    def __exit__(self, *exc):
        if self.opened is not None:
            _local.step = None
            _close(self.opened)
        return False


def step(device=None):
    """A context manager around one step on ``device``; gives the step's
    id (None while recording is off). A step opened inside an open step
    of the same thread joins it."""
    return _StepScope(device)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` (a host number) to the open step's counter ``name``."""
    if not _enabled:
        return
    with step():
        st = _local.step
        st.counters[name] = st.counters.get(name, 0) + n


def _close(st: _Step) -> None:
    if not st.spans and not st.counters:
        return
    with _lock:
        _pending.append(st)
    if all(s.events is None for s in st.spans):
        resolve()


def resolve(block: bool = False) -> None:
    """Turn the closed steps whose work is done into records;
    with ``block``, wait for every closed step's work."""
    with _lock:
        keep = []
        for st in _pending:
            ends = [s.events[1] for s in st.spans if s.events is not None]
            if block:
                for ev in ends:
                    ev.synchronize()
            elif not all(ev.query() for ev in reversed(ends)):
                keep.append(st)
                continue
            _finish(st)
        _pending[:] = keep


def flush() -> None:
    """Resolve every closed step (may synchronise)."""
    resolve(block=True)


def _finish(st: _Step) -> None:
    """The records of a done step; its events go back to the pool (under
    _lock)."""
    stream = {}
    for s in st.spans:
        if s.events is not None:
            stream[s] = s.events[0].elapsed_time(s.events[1])
            _free.setdefault(s.index, []).extend(s.events)
        elif st.cuda is None:
            stream[s] = (s.end_ns - s.start_ns) * 1e-6
        else:
            stream[s] = None
    children = {s: 0.0 for s in st.spans}
    for s in st.spans:
        if s.parent is not None:
            children[s.parent] += stream[s] or 0.0
    recs = [Record(s.name, s.parent.name if s.parent is not None else None,
                   st.id, s.start_ns, s.end_ns, stream[s],
                   None if stream[s] is None else stream[s] - children[s])
            for s in st.spans]
    _history.append(Step(st.id, recs, st.counters))


def steps() -> list:
    """The resolved steps held (the last WINDOW), oldest first."""
    with _lock:
        return list(_history)


def records() -> list:
    """The records of the resolved steps held, oldest first."""
    return [r for st in steps() for r in st.records]


def _innermost(records):
    """(times, names): from times[i] to times[i + 1] the innermost span
    open on the host is names[i] (None: none), the innermost being the
    shortest span open there."""
    times = sorted({r.start_ns for r in records} | {r.end_ns for r in records})
    names = []
    for t in times:
        open_ = [r for r in records if r.start_ns <= t < r.end_ns]
        names.append(min(open_, key=lambda r: r.end_ns - r.start_ns).name
                     if open_ else None)
    return times, names


def attribute(events, records, top: int = 10) -> dict:
    """Join a profiler's events with span records on the host clock they
    share. ``events``: (name, start_ns, end_ns, on_device) tuples, host
    and device alike. Returns {"spans": {span name: {"launches", "syncs"}}
    of the runtime calls (LAUNCHES, SYNCS) made while the span was the
    innermost open, "gaps": [[span name, ms], ...] the ``top`` longest
    idle gaps between the device's busy intervals (the union of its
    events), each named by the innermost span open at its midpoint,
    "busy_ms": that union's length}. Time outside every span goes under
    None."""
    times, names = _innermost(list(records))

    def at(t):
        i = bisect.bisect_right(times, t) - 1
        return names[i] if 0 <= i < len(names) else None

    spans: dict = {}
    busy = []
    for name, start, end, on_device in events:
        if on_device:
            if end > start:
                busy.append([start, end])
            continue
        kind = ("launches" if name in LAUNCHES else
                "syncs" if name in SYNCS else None)
        if kind is not None:
            row = spans.setdefault(at(start), {"launches": 0, "syncs": 0})
            row[kind] += 1
    merged: list = []
    for s, e in sorted(busy):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(merged, merged[1:])),
                  reverse=True)[:top]
    return {"spans": spans,
            "gaps": [[at((begin + end) // 2), length * 1e-6]
                     for length, begin, end in gaps],
            "busy_ms": sum(e - s for s, e in merged) * 1e-6}
