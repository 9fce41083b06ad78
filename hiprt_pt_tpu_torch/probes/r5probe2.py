"""The round-5 gather probes on the GPU: how fast can a traversal kernel fetch
leaf rows? The port of ``benchmarks/r5probe2.py``.

    python -m hiprt_pt_tpu_torch.probes.r5probe2               # on the GPU
    python -m hiprt_pt_tpu_torch.probes.r5probe2 --device cpu --shapes tiny

- Q1, P1 ``mm_probe_kernel`` (csrc/probes.cu; replaces ``_mm_kernel``):
  rows gathered by a one-hot matrix product on the tensor cores (``wgmma``,
  the one-hot operand built in registers, the table streamed through
  shared memory by TMA), the maximum of each gathered row, summed over the
  rows and the rounds:
  ``sum_r sum_j max_w tab[(idx[r % 8, j] + r) mod L, w]``. Five
  configurations: the stress interior's leaf table (L = 2731 rows) at the
  16-, 12- and 8-bit leaf widths, per group of 512 columns or fused, int8
  or bf16.
- Q2, P2 ``dg_probe_kernel`` (replaces ``_dg_kernel``): rows gathered lane
  by lane, the maximum over the S gathered rows of each lane, summed:
  ``sum_r sum_c sum_k max_s tab[(idx[s, k] + r) mod S, c * 128 + k]``. The
  table is staged once in strips of ``g`` lanes into the SMs' shared
  memory and every round gathers from there (``dg_plan`` picks ``g`` and
  the block size); a table whose narrowest strip does not fit a block's
  shared memory is gathered from device memory through the L2 by a second
  kernel. Two configurations (4 and 19 tiles of 128 lanes).
- Q3: the library's row gather (``tab[idx]``) at wavefront width, the
  yardstick both probes are read against; it has no kernel of its own.

Each kernel's wrapper launches it on CUDA tensors, runs its plain version
(``mm_probe_plain``, ``dg_probe_plain``) on CPU tensors, and never falls
back; their launches count in ``cuda_build.launch_counts["mm_probe"]`` and
``["dg_probe"]``. On the GPU every line carries the card's name and power
limit, the time per round (CUDA events after a warm-up) and the share of
the H100's dense peak (1,979 TOP/s int8, 989 TFLOP/s bf16). On the CPU
(``device="cpu"``) the plain versions run and no time is taken.

The probe's own inputs (``mm_inputs``, ``dg_inputs``, bit for bit the TPU
probe's) give a constant answer: every row of its P1 table holds 127, and
its P2 table is all ones. They measure, but they check nothing; the
``*_gate_inputs`` are seeded inputs whose answer is not constant.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess

import numpy as np
import torch

from ..core.device import cuda_ms, resolve_device
from ..ops import cuda_build
from ..ops.cuda_build import check_tensor

# the TPU probe's shapes (benchmarks/r5probe2.py:183-187)
TC = 128
W16 = -(-(18 * TC + 13) // 8) * 8      # 2320
W12 = -(-(14 * TC + 13) // 8) * 8      # 1808
W8 = -(-(9 * TC + 16) // 8) * 8        # 1168
L_STRESS = 2731
ROUNDS = 32
DG_LANES = 128
# P2: the strip widths its shared-memory kernel is built for, widest first;
# the shared memory a block can have on the H100 (227 KB) less the kernel's
# static share and the 1 KB the system keeps per block; the SM's shared
# memory; the card's SMs; the largest block (at the kernel's 58 or 59
# registers a thread an SM holds 1,024 threads: one such block, or two of 512)
DG_STRIPS = (4, 2)
DG_SMEM_BLOCK = 232448 - 2048
DG_SMEM_SM = 233472
DG_SMS = 132
DG_MAX_THREADS = 1024
# P1: the padded operand's columns (of L) and rows (of W) are multiples of
# these; the table types its kernel takes
MM_K_PAD, MM_M_PAD = 32, 16
MM_DTYPES = (torch.int8, torch.bfloat16)
# (label, L, W, NL, dtype, groups): Q1 of r5probe2.py:191-196
MM_CONFIGS = (
    ("per-group(now)", L_STRESS, W16, 4096, torch.int8, 8),
    ("fused", L_STRESS, W16, 4096, torch.int8, 1),
    ("12-bit", L_STRESS, W12, 4096, torch.int8, 1),
    ("8-bit", L_STRESS, W8, 4096, torch.int8, 1),
    ("bf16", L_STRESS, W16, 4096, torch.bfloat16, 1),
)
# (S, tiles): Q2 of :199-200
DG_CONFIGS = ((4096, 4), (4096, 19))
# (M, C, N, sort): Q3 of :203-205
GATHER_CONFIGS = ((259200, 32, 2 ** 21, False), (259200, 32, 2 ** 21, True),
                  (259200, 4, 2 ** 21, False))
# small shapes of the same kinds, for the host
TINY = {
    "mm": tuple((label, 67, w // 58, 128, dt, g)
                for label, _l, w, _n, dt, g in MM_CONFIGS),
    "dg": ((64, 1), (64, 2)),
    "gather": ((1000, 32, 4096, False), (1000, 32, 4096, True),
               (1000, 4, 4096, False)),
    "rounds": 4,
}
# H100 SXM dense tensor-core peaks (NVIDIA's data sheet), operations/s
PEAK_OPS = {torch.int8: 1979e12, torch.bfloat16: 989e12}

def _check_rounds(rounds: int) -> None:
    """P1 and P2's L2 kernel take a round per grid row (at most 65,535)."""
    if not 1 <= rounds <= 65535:
        raise ValueError(f"rounds must lie in [1, 65535], got {rounds}")


# --- inputs -----------------------------------------------------------------

def mm_inputs(L: int, W: int, NL: int, dtype=torch.int8, device=None):
    """P1's own table (L, W) and indices (8, NL) int32, bit for bit as
    r5probe2.py:82-86 builds them (its first index variant)."""
    device = resolve_device(device)
    flat = torch.arange(L * W, dtype=torch.int32) % 255 - 127
    tab = flat.to(dtype if dtype == torch.int8 else torch.float32).to(dtype)
    idx = torch.arange(8 * NL, dtype=torch.int32).reshape(8, NL) * 9973 % L
    return tab.reshape(L, W).to(device), idx.to(device)


def dg_inputs(S: int, tiles: int, device=None):
    """P2's own table (S, tiles * 128) f32 and indices (S, 128) int32, bit
    for bit as r5probe2.py:128-131 builds them (its first variant): ones,
    and each row's index broadcast over the lanes."""
    device = resolve_device(device)
    tab = torch.ones((S, tiles * DG_LANES), dtype=torch.float32)
    rows = (torch.arange(S, dtype=torch.int32) * 9973) % S
    idx = rows[:, None].expand(S, DG_LANES).contiguous()
    return tab.to(device), idx.to(device)


def mm_gate_inputs(L: int, W: int, NL: int, dtype=torch.int8, seed: int = 0,
                   device=None):
    """Seeded P1 inputs whose answer is not constant: each row's maximum is
    drawn from [-127, 127] and placed at a random column, the rest of the
    row is drawn below it (down to -128); the indices (8, NL) are drawn
    with replacement from [0, L)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    top = rng.integers(-127, 128, L)
    tab = rng.integers(-128, top[:, None], (L, W))
    tab[np.arange(L), rng.integers(0, W, L)] = top
    idx = rng.integers(0, L, (8, NL)).astype(np.int32)
    return (torch.from_numpy(tab).to(dtype).to(device),
            torch.from_numpy(idx).to(device))


def dg_gate_inputs(S: int, tiles: int, seed: int = 0, device=None,
                   per_lane: bool = True, integer: bool = True):
    """Seeded P2 inputs whose answer is not constant: a table of integers
    drawn from [-1000, 1000] (or, ``integer=False``, of floats drawn from
    [-1000, 1000)), and indices drawn with replacement from [0, S), one per
    (row, lane) or (``per_lane=False``) one per row broadcast over the
    lanes."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    shape = (S, tiles * DG_LANES)
    tab = (rng.integers(-1000, 1001, shape) if integer
           else rng.uniform(-1000.0, 1000.0, shape)).astype(np.float32)
    if per_lane:
        idx = rng.integers(0, S, (S, DG_LANES))
    else:
        idx = np.broadcast_to(rng.integers(0, S, (S, 1)), (S, DG_LANES))
    return (torch.from_numpy(tab).to(device),
            torch.from_numpy(np.ascontiguousarray(idx, dtype=np.int32)).to(device))


# --- plain versions ---------------------------------------------------------

def mm_probe_plain(tab, idx, rounds: int, groups: int = 1):
    """P1 without the product: each round gathers the rows, takes their
    maxima and adds them up, exactly (int64 for an int8 table, float64 for
    a bf16 one). ``groups`` splits the columns as the TPU probe does, which
    leaves the sum as it is. Returns a (1, 1) float64 tensor."""
    L = tab.shape[0]
    NL = idx.shape[1]
    if NL % groups:
        raise ValueError(f"NL = {NL} is not a multiple of groups = {groups}")
    acc_t = torch.int64 if tab.dtype == torch.int8 else torch.float64
    acc = torch.zeros((), dtype=acc_t, device=tab.device)
    for r in range(rounds):
        sl = torch.remainder(idx[r % 8].long() + r, L)
        acc = acc + tab[sl].amax(dim=1).to(acc_t).sum()
    return acc.to(torch.float64).reshape(1, 1)


def dg_probe_plain(tab, idx, rounds: int):
    """P2 with ``torch.gather``: per round and tile, the gathered (S, 128)
    block's maximum over the rows, summed in float64. Returns a (1, 1)
    float64 tensor."""
    S = tab.shape[0]
    tiles = tab.shape[1] // DG_LANES
    acc = torch.zeros((), dtype=torch.float64, device=tab.device)
    for r in range(rounds):
        rows = torch.remainder(idx.long() + r, S)
        for c in range(tiles):
            g = torch.gather(tab[:, c * DG_LANES:(c + 1) * DG_LANES], 0, rows)
            acc = acc + g.amax(dim=0).double().sum()
    return acc.reshape(1, 1)


# --- kernels ----------------------------------------------------------------

@dataclasses.dataclass
class MMTable:
    """P1's table, with the operand its kernel reads: ``tab_t``, the table
    transposed to (W, L), L contiguous (the K-major B operand of ``wgmma``),
    zero-padded to a multiple of 16 rows and 32 columns, which makes a row
    a multiple of the 16 bytes a TMA tensor map's stride must be. The
    kernel's tiles need no further padding: the tensor map ends at W rows
    and the padded columns, and TMA fills what a tile reaches past them
    with zeros. Made once by ``mm_table``: set-up, outside any timed
    call."""
    tab: torch.Tensor
    tab_t: torch.Tensor


def _padded_shape(L: int, W: int) -> tuple:
    return -(-W // MM_M_PAD) * MM_M_PAD, -(-L // MM_K_PAD) * MM_K_PAD


def mm_table(tab) -> MMTable:
    """The one-time set-up of P1's table (L, W) int8 or bf16."""
    if tab.dim() != 2:
        raise ValueError(f"tab must be 2-D, got shape {tuple(tab.shape)}")
    check_tensor("tab", tab, MM_DTYPES, tab.shape, tab.device)
    L, W = tab.shape
    tab_t = torch.zeros(_padded_shape(L, W), dtype=tab.dtype, device=tab.device)
    tab_t[:W, :L] = tab.t()
    return MMTable(tab=tab, tab_t=tab_t)


def mm_probe_kernel(table: MMTable, idx, rounds: int, groups: int = 1):
    """P1 (the port of _mm_kernel): on CUDA the one-hot product on the
    tensor cores, ``wgmma`` on table tiles that TMA streams through shared
    memory (csrc/probes.cu), a (1, 1) float32 tensor; on the CPU
    ``mm_probe_plain``."""
    tab = table.tab
    if tab.device.type == "cpu":
        return mm_probe_plain(tab, idx, rounds, groups)
    if tab.device.type != "cuda":
        raise ValueError(f"mm_probe_kernel runs on CUDA tensors, got {tab.device}")
    dev = tab.device
    L, W = tab.shape
    NL = idx.shape[-1]
    check_tensor("idx", idx, torch.int32, (8, NL), dev)
    check_tensor("tab_t", table.tab_t, MM_DTYPES, _padded_shape(L, W), dev)
    _check_rounds(rounds)
    if groups < 1 or NL % groups:
        raise ValueError(f"NL = {NL} is not a multiple of groups = {groups}")
    lib = cuda_build.load_libraries()["probes"]
    # one partial sum per block: a block takes hpt_mm_probe_rows() gathered
    # rows of one group and one round
    n_blocks = groups * -(-(NL // groups) // lib.hpt_mm_probe_rows())
    partial = torch.empty((rounds * n_blocks,), dtype=torch.float32, device=dev)
    out = torch.empty((1, 1), dtype=torch.float32, device=dev)
    w_pad, l_pad = table.tab_t.shape
    cuda_build.launch("mm_probe", dev, table.tab_t.data_ptr(), idx.data_ptr(),
                      L, W, w_pad, l_pad, NL, rounds, groups,
                      int(table.tab_t.dtype == torch.int8), partial.data_ptr(),
                      out.data_ptr())
    return out


def dg_plan(S: int, tiles: int, sms: int = DG_SMS) -> tuple:
    """(g, threads) of P2's launch on a table of S rows and ``tiles`` lane
    tiles, on a card of ``sms`` SMs: the strip width in lanes (a block
    stages S x g floats in shared memory) and the block size; g = 0 when
    even the narrowest strip does not fit a block's shared memory, and the
    L2 kernel runs. The widest strip that fits is taken: it reads the most
    of each 32-byte sector of the table and of the index rows (a strip of 8
    lanes would fill the sector, but at S = 4,096 it is 128 KB, one block an
    SM and 304 blocks for 132 SMs at 19 tiles; it is not built). A block has
    1,024 threads where an SM gets or holds only one strip (4 tiles: 128
    strips on 132 SMs), else 512, two blocks resident an SM (19 tiles: 608
    strips), as measured at both."""
    g = next((g for g in DG_STRIPS if S * g * 4 <= DG_SMEM_BLOCK), 0)
    if g == 0:
        return 0, 0
    strips = tiles * (DG_LANES // g)
    per_sm = min(-(-strips // sms), DG_SMEM_SM // (S * g * 4 + 2048))
    return g, DG_MAX_THREADS if per_sm <= 1 else DG_MAX_THREADS // 2


def dg_served_from(g: int) -> str:
    """Where a launch at strip width g gathers from, for the probe's line."""
    return "the L2" if g == 0 else f"shared memory, strips of {g} lanes"


def dg_probe_kernel(tab, idx, rounds: int, plan: tuple | None = None):
    """P2 (the port of _dg_kernel): on CUDA per-lane row gathers from
    strips of the table staged in shared memory, or from device memory when
    no strip fits (csrc/probes.cu), a (1, 1) float32 tensor; on the CPU
    ``dg_probe_plain``. ``idx`` is any (S, 128) array, as
    ``take_along_axis`` takes it. ``plan`` is (g, threads) as ``dg_plan``
    gives it for this table and card; a timing script may pass another."""
    if tab.device.type == "cpu":
        return dg_probe_plain(tab, idx, rounds)
    if tab.device.type != "cuda":
        raise ValueError(f"dg_probe_kernel runs on CUDA tensors, got {tab.device}")
    dev = tab.device
    S = tab.shape[0]
    if tab.dim() != 2 or tab.shape[1] % DG_LANES or tab.shape[1] == 0:
        raise ValueError(f"tab must be (S, tiles * 128), got {tuple(tab.shape)}")
    tiles = tab.shape[1] // DG_LANES
    check_tensor("tab", tab, torch.float32, (S, tiles * DG_LANES), dev)
    check_tensor("idx", idx, torch.int32, (S, DG_LANES), dev)
    if tab.data_ptr() % 16:
        raise ValueError("tab must start on a 16-byte boundary")
    _check_rounds(rounds)
    if plan is None:
        plan = dg_plan(S, tiles,
                       torch.cuda.get_device_properties(dev).multi_processor_count)
    g, threads = plan
    if g != 0 and (g not in DG_STRIPS or S * g * 4 > DG_SMEM_BLOCK
                   or threads % 32 or not 32 <= threads <= DG_MAX_THREADS):
        raise ValueError(f"dg_probe_kernel takes no plan {plan} at S = {S}")
    # one partial sum per (round, strip), or per (round, tile) from the L2
    strips = tiles * (DG_LANES // g) if g else tiles
    partial = torch.empty((rounds * strips,), dtype=torch.float32, device=dev)
    out = torch.empty((1, 1), dtype=torch.float32, device=dev)
    cuda_build.launch("dg_probe", dev, tab.data_ptr(), idx.data_ptr(), S,
                      tiles, rounds, g, threads, partial.data_ptr(),
                      out.data_ptr())
    return out


# --- the probe ----------------------------------------------------------------

def mm_ops(L: int, W: int, NL: int, rounds: int) -> int:
    """P1's operations as the probe counts them: a multiply and an add per
    (row, column, gathered row, round) of the one-hot product."""
    return 2 * L * W * NL * rounds


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def _gather_run(tab, idx):
    """Q3's body (r5probe2.py:168-173): 16 shifted gathers of N rows summed."""
    M = tab.shape[0]
    acc = torch.zeros((idx.shape[0], tab.shape[1]), dtype=tab.dtype,
                      device=tab.device)
    for r in range(16):
        acc = acc + tab[(idx + r) % M]
    return acc.sum()


def main(device=None, shapes: str = "probe") -> list:
    """Run Q1-Q3 and print one line per configuration. ``shapes``: "probe"
    (the TPU probe's) or "tiny". Returns the lines' numbers as dicts."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    sizes = {"probe": {"mm": MM_CONFIGS, "dg": DG_CONFIGS,
                       "gather": GATHER_CONFIGS, "rounds": ROUNDS},
             "tiny": TINY}[shapes]
    rounds = sizes["rounds"]
    where = card() if on_card else "cpu, plain versions, time not measured"
    results = []

    def timed(fn, reps=3):
        if on_card:
            return cuda_ms(fn, reps)
        return None, fn()

    print(f"Q1: one-hot matrix-product gather, max consumer, {rounds} rounds "
          f"[{where}]", flush=True)
    for label, L, W, NL, dtype, groups in sizes["mm"]:
        tab, idx = mm_inputs(L, W, NL, dtype, dev)
        table = mm_table(tab)
        ms, out = timed(lambda: mm_probe_kernel(table, idx, rounds, groups))
        ops = mm_ops(L, W, NL, rounds)
        res = {"probe": "P1", "label": label, "L": L, "W": W, "NL": NL,
               "dtype": str(dtype).split(".")[-1], "groups": groups,
               "rounds": rounds, "value": float(out.reshape(())), "ms": ms}
        line = (f"  {label:14s} L={L:6d} W={W:5d} NL={NL} {res['dtype']:8s} "
                f"g={groups}: value {res['value']:.1f}")
        if ms is not None:
            res["eff"] = ops / (ms * 1e-3) / PEAK_OPS[dtype]
            line += (f", {ms / rounds * 1e3:8.1f} us/round, "
                     f"{res['eff'] * 100:5.1f}% of {PEAK_OPS[dtype] / 1e12:,.0f} "
                     f"TOP/s [{where}]")
        print(line, flush=True)
        results.append(res)

    print(f"Q2: per-lane row gather, {rounds} rounds [{where}]", flush=True)
    for S, tiles in sizes["dg"]:
        tab, idx = dg_inputs(S, tiles, dev)
        ms, out = timed(lambda: dg_probe_kernel(tab, idx, rounds))
        res = {"probe": "P2", "S": S, "tiles": tiles, "rounds": rounds,
               "value": float(out.reshape(())), "ms": ms}
        line = f"  S={S:6d} tiles={tiles:2d} float32: value {res['value']:.1f}"
        if ms is not None:
            g, threads = dg_plan(
                S, tiles, torch.cuda.get_device_properties(dev).multi_processor_count)
            # every gathered element is four bytes
            res |= {"g": g, "threads": threads,
                    "gather_gbs": S * tiles * DG_LANES * rounds * 4 / ms / 1e6}
            line += (f", {ms / rounds * 1e3:8.1f} us/round, "
                     f"{ms * 1e6 / rounds / S / tiles:6.3f} ns/row/tile, "
                     f"{res['gather_gbs']:,.0f} GB/s of gathers served from "
                     f"{dg_served_from(g)} (blocks of {threads} threads) "
                     f"[{where}]")
        print(line, flush=True)
        results.append(res)

    print(f"Q3: library row gather (tab[idx]) at wavefront width [{where}]",
          flush=True)
    for M, C, N, sort in sizes["gather"]:
        tab = torch.ones((M, C), dtype=torch.float32, device=dev)
        idx = torch.from_numpy(np.random.default_rng(0).integers(0, M, N)).to(dev)
        if sort:
            idx = idx.sort().values
        ms, out = timed(lambda: _gather_run(tab, idx))
        res = {"probe": "Q3", "M": M, "C": C, "N": N, "sort": sort,
               "value": float(out), "ms": None if ms is None else ms / 16}
        line = f"  M={M} C={C} N={N} sort={sort}: value {res['value']:.1f}"
        if ms is not None:
            line += (f", {res['ms']:7.3f} ms per gather "
                     f"({N * C * 4 / (res['ms'] * 1e-3) / 1e9:7.1f} GB/s) [{where}]")
        print(line, flush=True)
        results.append(res)
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (plain versions, no times)")
    ap.add_argument("--shapes", choices=("probe", "tiny"), default=None,
                    help="the TPU probe's shapes (default on the GPU) or tiny "
                         "ones (default on the CPU)")
    args = ap.parse_args()
    main(args.device, args.shapes or ("tiny" if args.device == "cpu" else "probe"))
