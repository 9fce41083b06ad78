"""Keyed thread manager with dependency DAG — host concurrency utilities,
mirroring ``hiprt_pt_tpu.utils.threads``.

Role parity with the reference's ``ThreadManager`` (src/Threads/
ThreadManager.h:38-249): static keyed thread registry (start_thread /
join_threads / join_all_threads), inter-key dependency edges
(add_dependency — a key's threads only start after its dependencies have
joined), and a monothread mode that runs everything inline for serial
debugging (ThreadManager.h:62-68).

Used by the asset loader (assets/loader.py) to overlap texture decode and
the BVH build (reference: main.cpp:55-67 + SceneParser.cpp:344-360 texture
threads + GPURenderer.cpp:1041-1125 scene upload threads). The BVH build
runs in native code that releases the interpreter lock (ctypes), so the
texture thread's numpy work overlaps it.
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Any, Callable, Dict, List

# the keys the loader uses (reference: ThreadManager.h:41-59)
SCENE_TEXTURES_LOADING = "scene_textures_loading"
RENDERER_BUILD_BVH = "renderer_build_bvh"


class ThreadManager:
    """Keyed thread pools + dependency DAG, instantiable (the reference's is
    a static class; an instance keeps tests isolated)."""

    def __init__(self, monothread: bool = False):
        self._monothread = monothread
        self._threads: Dict[str, List[threading.Thread]] = defaultdict(list)
        self._deps: Dict[str, List[str]] = defaultdict(list)
        self._results: Dict[str, List[Any]] = defaultdict(list)
        self._errors: Dict[str, List[BaseException]] = defaultdict(list)
        self._lock = threading.Lock()

    def add_dependency(self, key: str, depends_on: str):
        """Threads of `key` start only after `depends_on` has joined
        (reference: ThreadManager.h:77-227 dependency DAG)."""
        with self._lock:
            self._deps[key].append(depends_on)

    def start_thread(self, key: str, fn: Callable, *args, **kwargs):
        """Launch fn on a thread registered under `key`; dependencies are
        joined first (on the worker, so the caller never blocks)."""

        def runner():
            try:
                for dep in list(self._deps.get(key, [])):
                    self.join_threads(dep)
                out = fn(*args, **kwargs)
                with self._lock:
                    self._results[key].append(out)
            except BaseException as e:  # noqa: BLE001 — surfaced at join
                with self._lock:
                    self._errors[key].append(e)

        if self._monothread:
            runner()
            return None
        t = threading.Thread(target=runner, daemon=True)
        with self._lock:
            self._threads[key].append(t)
        t.start()
        return t

    def join_threads(self, key: str):
        """Join every thread of `key`; re-raises the first worker error
        (reference hard-exits on load failures — callers decide)."""
        while True:
            with self._lock:
                ts = [t for t in self._threads.get(key, []) if t.is_alive()]
            if not ts:
                break
            for t in ts:
                t.join()
        errs = self._errors.get(key, [])
        if errs:
            raise errs[0]

    def join_all_threads(self):
        for key in list(self._threads.keys()):
            self.join_threads(key)

    def results(self, key: str) -> List[Any]:
        """Return values collected from `key`'s completed threads."""
        with self._lock:
            return list(self._results.get(key, []))
