"""Background warm-up of render-option permutations, mirroring
``hiprt_pt_tpu.utils.precompile`` (reference: the kernel-permutation
precompile sweep, src/Renderer/GPURenderer.cpp:773-897: background threads
compile common -D macro combinations into the shader cache).

The port has no compiled executable per option set. What a permutation
costs at its first use is the nvcc build and load of the CUDA libraries its
rays route to (ops/cuda_build.py) and the render state of its shape. A
warm-up job builds or loads those libraries, queries the routed kernels'
attributes (ops/cuda_traverse.py:routed_kernel_info) and builds the
permutation's ``init_render_state``; it counts ``compiled`` when all of that
succeeds and ``failed`` when any part raises. On the CPU, or with
``use_pallas_traversal`` off, no kernel runs and a job makes the state
alone. A failed warm-up changes nothing else: the render path builds again
at its first use and raises there. The build directory plays the shader
cache's role: it lasts across processes, and ``enable_persistent_cache``
points it elsewhere.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import itertools
import os
import threading
from typing import Iterable, Optional

from ..core.settings import (EnvmapSamplingStrategy, LightSamplingStrategy,
                             RenderOptions)


def common_permutations(base: RenderOptions) -> list[RenderOptions]:
    """The sweep set mirroring the reference's: direct-light strategies x
    envmap strategies (GPURenderer.cpp:807-845) + ReSTIR bias options
    (:847-884)."""
    out = []
    for dls, ess in itertools.product(
        (LightSamplingStrategy.MIS, LightSamplingStrategy.RIS_BSDF_LIGHT,
         LightSamplingStrategy.RESTIR_DI),
        (EnvmapSamplingStrategy.CDF_BINARY,
         EnvmapSamplingStrategy.ALIAS_TABLE),
    ):
        out.append(dataclasses.replace(base, direct_light_sampling=dls,
                                       envmap_sampling=ess))
    return out


def warm_permutation(renderer, opts: RenderOptions):
    """What one permutation needs before its first frame on ``renderer``'s
    scene: the routed kernels' libraries built, loaded and queried (on a
    CUDA device with the kernels on), and its render state. Raises where a
    part fails."""
    from ..core.state import init_render_state
    from ..ops import cuda_traverse

    if renderer.device.type == "cuda" and opts.use_pallas_traversal:
        cuda_traverse.routed_kernel_info(renderer.bvh)
    init_render_state(
        renderer.width, renderer.height, renderer.seed, renderer.device,
        with_restir=opts.direct_light_sampling
        == LightSamplingStrategy.RESTIR_DI)


class Precompiler:
    """Warm RenderOptions permutations on worker threads. The libraries'
    build holds one lock (ops/cuda_build.py), so the render loop and the
    workers wait for one build instead of racing."""

    def __init__(self, max_workers: int = 2):
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="precompile")
        self._futures = []
        self._lock = threading.Lock()
        self.compiled = 0
        self.failed = 0

    def warm(self, renderer, permutations: Optional[Iterable[RenderOptions]]
             = None, log=None):
        """Queue a warm-up (warm_permutation) of each option set for the
        renderer's scene and shape; returns the futures."""
        perms = list(permutations if permutations is not None
                     else common_permutations(renderer.options))
        total = len(perms)

        def job(opts):
            try:
                warm_permutation(renderer, opts)
                with self._lock:
                    self.compiled += 1
            except Exception:  # counted; the render path raises at first use
                with self._lock:
                    self.failed += 1
            if log:
                log.update_line(
                    "precompile", f"Precompiling option permutations... "
                    f"[{self.compiled + self.failed}/{total}]")

        for opts in perms:
            self._futures.append(self._pool.submit(job, opts))
        return self._futures

    def wait(self, timeout=None):
        concurrent.futures.wait(self._futures, timeout=timeout)

    def shutdown(self):
        self._pool.shutdown(wait=False, cancel_futures=True)


def enable_persistent_cache(cache_dir: str | None = None) -> str:
    """Point the kernels' build directory (utils/native_build.py:BUILD_DIR)
    at ``cache_dir`` (default: the package's gitignored ``_build/``), the
    counterpart of the JAX package's persistent XLA cache: libraries built
    there are reused by later processes. The libraries are loaded again
    from there at their next use. Returns the directory."""
    from . import native_build

    if cache_dir is None:
        cache_dir = native_build.DEFAULT_BUILD_DIR
    os.makedirs(cache_dir, exist_ok=True)
    native_build.BUILD_DIR = cache_dir
    return cache_dir
