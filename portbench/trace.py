"""The reduction of a torch.profiler trace (CPU and CUDA activities) to
what the per-layer metrics read: host launches and host synchronisations
(the CUDA runtime's calls), the device's busy time as the union of its
kernel, copy and set intervals, device time by kernel, and the breakdown
of device operations and idle gaps that a traced run prints.
"""

from __future__ import annotations

import dataclasses
import re

# the runtime calls that launch work: one per kernel launch, one per graph
# replay
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaGraphLaunch")
# the runtime calls at which the host waits for the device
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")
TRAVERSAL = re.compile(r"\btrace_[a-z0-9]+_kernel\b")


@dataclasses.dataclass
class Summary:
    frames: int
    window_s: float
    launches: int
    syncs: int
    busy_s: float
    kernel_s: dict          # device seconds by kernel or copy name
    traverse_s: float       # device seconds of the trace_*_kernel kernels
    device_ops: list        # [[name, seconds]] the ten largest
    idle_gaps: list         # [[name, seconds]] the ten longest gaps

    @property
    def integrator_s(self) -> float:
        return sum(self.kernel_s.values()) - self.traverse_s


@dataclasses.dataclass
class _Ev:
    name: str
    start: int
    end: int
    device: bool


def _events(prof) -> list:
    """Every event of a finished profiler as _Ev (ns on one clock)."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        start = int(e.start_ns())
        end = start + int(e.duration_ns())
        dev = e.device_type() == DeviceType.CUDA
        out.append(_Ev(e.name(), start, end, dev))
    return out


def short(name: str, width: int = 160) -> str:
    """A kernel's or operator's name without its return type and argument
    list, at most ``width`` characters."""
    if name.startswith("void "):
        name = name[5:]
    name = name.replace("(anonymous namespace)", "{anonymous}")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name[:width]


def _union(intervals) -> list:
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(prof, frames: int, window_s: float, top: int = 10) -> Summary:
    """The trace of ``frames`` frames over ``window_s`` seconds of wall
    time."""
    evs = _events(prof)
    dev = [e for e in evs if e.device and e.end > e.start]
    host = [e for e in evs if not e.device]
    launches = sum(e.name in LAUNCHES for e in host)
    syncs = sum(e.name in SYNCS for e in host)
    kernel_s: dict = {}
    for e in dev:
        kernel_s[e.name] = kernel_s.get(e.name, 0.0) + (e.end - e.start) * 1e-9
    traverse_s = sum(s for n, s in kernel_s.items() if TRAVERSAL.search(n))
    busy = _union((e.start, e.end) for e in dev)
    busy_s = sum(e - s for s, e in busy) * 1e-9
    device_ops = sorted(([short(n), s] for n, s in kernel_s.items()),
                        key=lambda x: -x[1])[:top]
    return Summary(frames=frames, window_s=window_s, launches=launches,
                   syncs=syncs, busy_s=busy_s, kernel_s=kernel_s,
                   traverse_s=traverse_s, device_ops=device_ops,
                   idle_gaps=_gaps(busy, host, top))


def _gaps(busy, host, top) -> list:
    """The ``top`` longest idle gaps between device intervals, each named by
    what the host was doing in its middle: the innermost CPU operator (or
    runtime call) running then."""
    gaps = sorted(((busy[i + 1][0] - busy[i][1], busy[i][1], busy[i + 1][0])
                   for i in range(len(busy) - 1)), reverse=True)[:top]
    out = []
    for length, begin, end in gaps:
        mid = (begin + end) // 2
        around = [o for o in host if o.start <= mid <= o.end]
        if around:
            name = min(around, key=lambda o: o.end - o.start).name
        else:
            name = "host outside any operator"
        out.append([short(name), length * 1e-9])
    return out
