"""Every process a run starts has ended, and been waited for, before the
run prints its result.

The run's process makes itself a child subreaper (Linux ``prctl``), so a
process that a rank, a compiler or a helper leaves behind when its own
parent ends is handed to the run's process and not to init. ``stop_all``
then ends what is left among the run's children: every child but the
multiprocessing resource tracker, SIGTERM first and SIGKILL after a grace,
each waited for, until none is left; last the resource tracker that
spawning ranks starts (it ignores SIGTERM, and ends once the last holder
of its pipe has closed it). A rank calls ``die_with_parent`` so that it ends with the run's
process even where that is killed.
"""

from __future__ import annotations

import ctypes
import os
import signal
import sys
import time

PR_SET_PDEATHSIG = 1
PR_SET_CHILD_SUBREAPER = 36

# seconds a process is given to end before the next, harder, signal
GRACE_S = 5.0


def _prctl(option: int, arg: int) -> bool:
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        return libc.prctl(option, ctypes.c_ulong(arg), 0, 0, 0) == 0
    except (OSError, AttributeError):
        return False


def adopt_orphans() -> bool:
    """Make this process the reaper of its descendants whose parent ends."""
    return _prctl(PR_SET_CHILD_SUBREAPER, 1)


def die_with_parent() -> bool:
    """SIGKILL this process when the thread that started it ends."""
    return _prctl(PR_SET_PDEATHSIG, int(signal.SIGKILL))


def children(pid: int | None = None) -> dict:
    """{pid: command line} of the processes whose parent is ``pid`` (this
    process by default), zombies included."""
    pid = os.getpid() if pid is None else pid
    out = {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                stat = f.read()
            ppid = int(stat[stat.rindex(")") + 2:].split()[1])
            if ppid != pid:
                continue
            with open(f"/proc/{name}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace").strip()
        except (OSError, ValueError, IndexError):
            continue
        out[int(name)] = cmd or stat[stat.index("(") + 1:stat.rindex(")")]
    return out


def _reaped(pid: int) -> bool:
    try:
        done, _ = os.waitpid(pid, os.WNOHANG)
        return done == pid
    except ChildProcessError:
        return True


def _wait(pid: int, seconds: float) -> bool:
    """Whether ``pid`` ended, and was waited for, within ``seconds``."""
    t_end = time.monotonic() + seconds
    while not _reaped(pid):
        if time.monotonic() >= t_end:
            return False
        time.sleep(0.02)
    return True


def _end(pid: int) -> bool:
    """SIGTERM, then SIGKILL after the grace, until ``pid`` has ended and
    been waited for; False where it is still there after both."""
    for sig in (signal.SIGTERM, signal.SIGKILL):
        if _reaped(pid):
            return True
        try:
            os.kill(pid, sig)
        except ProcessLookupError:
            return True
        if _wait(pid, GRACE_S):
            return True
    return False


def _stop_resource_tracker(tracker) -> None:
    """Close this process's end of the resource tracker's pipe, so that it
    ends, and wait for it (SIGKILL after the grace)."""
    with tracker._lock:
        fd, pid = tracker._fd, tracker._pid
        if fd is None or pid is None:
            return
        os.close(fd)
        tracker._fd = tracker._pid = None
    if not _wait(pid, GRACE_S):
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        _wait(pid, GRACE_S)


def stop_all(report=sys.stderr) -> list:
    """End and wait for every child of this process, the resource tracker
    last (others may hold its pipe). Returns, and writes to ``report``,
    the command lines of those that were still running, the tracker not
    counted."""
    import multiprocessing

    multiprocessing.active_children()  # waits for ranks that have ended
    tracker = getattr(sys.modules.get("multiprocessing.resource_tracker"),
                      "_resource_tracker", None)
    keep = {getattr(tracker, "_pid", None)}
    left, tried = [], set()
    while True:
        found = {p: c for p, c in children().items()
                 if p not in keep and p not in tried}
        if not found:
            break
        for pid, cmd in found.items():
            tried.add(pid)
            if _reaped(pid):
                continue
            left.append(cmd)
            if report is not None:
                print(f"portbench: ended a process left running: pid {pid}: "
                      f"{cmd[:300]}", file=report, flush=True)
            _end(pid)
    if tracker is not None:
        _stop_resource_tracker(tracker)
    return left
