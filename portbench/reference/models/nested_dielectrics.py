"""Nested dielectrics — fixed-size per-ray interior stack with priorities,
mirroring ``hiprt_pt_tpu.models.nested_dielectrics`` (reference:
NestedDielectrics.h, Schmidt & Budge 2002).

The stack is a pair of (N, K) int32 tensors; every query and update is a
compare-select over the small static K axis.
"""

from __future__ import annotations

import torch

EMPTY = -1


def empty_stack(n: int, k: int, device):
    """(mat (N,K) i32 = -1, priority (N,K) i32 = -1)."""
    return (
        torch.full((n, k), EMPTY, dtype=torch.int32, device=device),
        torch.full((n, k), EMPTY, dtype=torch.int32, device=device),
    )


def top_priority(stack_pri):
    """(N,) max priority among occupied slots (-1 if empty)."""
    return stack_pri.amax(dim=1)


def top_material(stack_mat, stack_pri):
    """(N,) material of the highest-priority entry (latest wins ties)."""
    best = top_priority(stack_pri)
    out = torch.full_like(best, EMPTY)
    for j in range(stack_pri.shape[1]):
        hit = (stack_pri[:, j] == best) & (stack_pri[:, j] >= 0)
        out = torch.where(hit, stack_mat[:, j], out)
    return out


def top_excluding(stack_mat, stack_pri, excl_mat):
    """Highest-priority entry ignoring ONE (the last) instance of excl_mat.
    Returns (mat (N,), priority (N,))."""
    k = stack_pri.shape[1]
    excl_done = torch.zeros_like(excl_mat, dtype=torch.bool)
    keep_cols = [None] * k
    for j in reversed(range(k)):
        is_excl = ((stack_mat[:, j] == excl_mat) & (stack_pri[:, j] >= 0)
                   & ~excl_done)
        keep_cols[j] = ~is_excl
        excl_done = excl_done | is_excl
    keep = torch.stack(keep_cols, dim=1)
    pri_masked = torch.where(keep, stack_pri, EMPTY)
    best = pri_masked.amax(dim=1)
    out = torch.full_like(best, EMPTY)
    for j in range(k):
        hit = (pri_masked[:, j] == best) & (pri_masked[:, j] >= 0)
        out = torch.where(hit, stack_mat[:, j], out)
    return out, best


def contains(stack_mat, stack_pri, mat):
    """(N,) bool — is material ``mat`` in any occupied slot?"""
    return ((stack_mat == mat[:, None]) & (stack_pri >= 0)).any(dim=1)


def push(stack_mat, stack_pri, mat, pri, mask):
    """Insert (mat, pri) into the first empty slot where mask (overflow drops
    the entry, like the reference's fixed-size stack)."""
    placed = ~mask
    cols_m, cols_p = [], []
    for j in range(stack_pri.shape[1]):
        do = mask & (stack_pri[:, j] < 0) & ~placed
        cols_m.append(torch.where(do, mat, stack_mat[:, j]))
        cols_p.append(torch.where(do, pri, stack_pri[:, j]))
        placed = placed | do
    return torch.stack(cols_m, dim=1), torch.stack(cols_p, dim=1)


def remove(stack_mat, stack_pri, mat, mask):
    """Remove the LAST occurrence of mat where mask."""
    k = stack_pri.shape[1]
    done = ~mask
    cols_m, cols_p = [None] * k, [None] * k
    for j in reversed(range(k)):
        hit = (stack_mat[:, j] == mat) & (stack_pri[:, j] >= 0) & ~done
        cols_m[j] = torch.where(hit, EMPTY, stack_mat[:, j])
        cols_p[j] = torch.where(hit, EMPTY, stack_pri[:, j])
        done = done | hit
    return torch.stack(cols_m, dim=1), torch.stack(cols_p, dim=1)
