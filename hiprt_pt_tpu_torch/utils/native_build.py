"""Build-on-first-use of the port's native shared libraries.

Every library is compiled from sources in the package into
``hiprt_pt_tpu_torch/_build/`` (gitignored) and loaded with ctypes. A build
writes to a private temporary file and renames it into place, so processes
that build the same library at once never load a half-written file, and
threads of one process that ask for the same library wait for one build. A
failed build raises with the compiler's output; nothing falls back.
"""

from __future__ import annotations

import os
import subprocess
import tempfile
import threading

DEFAULT_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                                 "_build")
# where libraries are built and found (utils/precompile.py:
# enable_persistent_cache points it elsewhere)
BUILD_DIR = DEFAULT_BUILD_DIR
_locks_lock = threading.Lock()
# library path -> the lock its build holds
_locks: dict = {}


def build_shared(compiler_cmd: list, sources: list, lib_name: str,
                 timeout: float = 600.0, deps: tuple = ()) -> tuple[str, str]:
    """Compile ``sources`` into ``BUILD_DIR/<lib_name>`` unless a copy newer
    than the sources and ``deps`` (included headers) is there.
    ``compiler_cmd`` is the command without the sources and the ``-o``
    output. Returns (library path, compiler output; empty when the library
    was already built)."""
    build_dir = BUILD_DIR
    os.makedirs(build_dir, exist_ok=True)
    lib = os.path.join(build_dir, lib_name)
    with _locks_lock:
        lock = _locks.setdefault(lib, threading.Lock())
    with lock:
        return _build_locked(compiler_cmd, sources, lib, lib_name, timeout,
                             deps)


def _build_locked(compiler_cmd, sources, lib, lib_name, timeout, deps):
    newest_src = max(os.path.getmtime(s) for s in list(sources) + list(deps))
    if os.path.exists(lib) and os.path.getmtime(lib) >= newest_src:
        return lib, ""
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(lib))
    os.close(fd)
    try:
        proc = subprocess.run(
            list(compiler_cmd) + list(sources) + ["-o", tmp],
            capture_output=True, text=True, timeout=timeout,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {lib_name} failed ({proc.returncode}):\n"
                f"{' '.join(proc.args)}\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib, proc.stdout + proc.stderr
