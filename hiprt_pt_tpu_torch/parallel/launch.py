"""Start ranks on one host: ``launch(fn, nprocs, args)`` spawns ``nprocs``
processes, initialises a ``torch.distributed`` process group in each and
returns what ``fn(rank, *args)`` returned on each rank.

    from hiprt_pt_tpu_torch.parallel.launch import launch
    results = launch(my_job, 2, args=(spec,), backend="gloo")

Ranks are started with the ``spawn`` method (a parent that has touched
CUDA cannot fork) and meet through a file in a fresh temporary directory,
so that launches side by side never share a rendezvous. ``fn`` must be a
module-level function of a module that the ranks can import (for a
``torch.distributed`` program under ``torchrun``, call
``init_process_group`` yourself instead). The whole launch has a time
limit, which is also the group's collective timeout: a rank stuck in a
collective fails the launch instead of hanging it. A rank's exception is
raised again in the parent, and the other ranks are stopped.

The backend is the caller's choice: "nccl" with one rank per card, "gloo"
for several ranks on one card or on the CPU (parallel/mesh.py).
"""

from __future__ import annotations

import datetime
import os
import pickle
import queue as queue_mod
import shutil
import tempfile
import time
import traceback

import torch
import torch.multiprocessing as mp


# the environment variables that size a process's BLAS and OpenMP pools
_POOL_THREADS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


class RankError(RuntimeError):
    """A rank raised an exception that could not be sent to the parent as
    itself; the message holds its traceback."""


def _rank_main(fn, rank: int, nprocs: int, backend: str, init_file: str,
               timeout: float, args, results) -> None:
    import torch.distributed as dist

    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(nprocs), LOCAL_WORLD_SIZE=str(nprocs))
    torch.set_num_threads(1)
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", world_size=nprocs,
            rank=rank, timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception as e:  # reported: the parent raises it again
        tb = traceback.format_exc()
        try:
            pickle.dumps(e)
            err = e
        except Exception:
            err = None
        results.put((rank, False, (err, tb)))


def launch(fn, nprocs: int, args: tuple = (), backend: str = "gloo",
           timeout: float = 600.0) -> list:
    """Run ``fn(rank, *args)`` on ``nprocs`` spawned ranks of a new process
    group on ``backend``; returns their results in rank order. ``timeout``:
    seconds for the whole launch (and each collective). Each rank runs one
    torch thread and one-thread BLAS and OpenMP pools, since the ranks
    share the host's cores."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="hpt_rdzv_")
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        fn, rank, nprocs, backend, os.path.join(tmp, "rdzv"), timeout,
        args, results)) for rank in range(nprocs)]
    deadline = time.monotonic() + timeout
    got: dict = {}
    # a rank's BLAS and OpenMP pools are sized when the rank loads them,
    # so from the environment the ranks start with
    env = {k: "1" for k in _POOL_THREADS}
    saved = {k: os.environ.get(k) for k in env}
    try:
        os.environ.update(env)
        try:
            for p in procs:
                p.start()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        while len(got) < nprocs:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"launch of {nprocs} ranks passed its {timeout:g} s "
                    f"limit; ranks {sorted(set(range(nprocs)) - set(got))} "
                    f"had not finished")
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    raise RankError(f"rank {dead[0]} exited with code "
                                    f"{procs[dead[0]].exitcode} without a "
                                    f"result")
                continue
            if not ok:
                err, tb = out
                if err is None:
                    raise RankError(f"rank {rank} raised:\n{tb}")
                raise err from RankError(f"rank {rank} raised:\n{tb}")
            got[rank] = out
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
        return [got[r] for r in range(nprocs)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            if p.pid is not None:
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
