"""Package-merge code lengths by rank: CUDA kernel + plain twin.

Replaces the Pallas kernel ``deflate_rs_tpu/ops/pm_kernel.py::_pm_kernel``
(entry ``package_merge_rows_tpu``).  Input: per row (one alphabet each) the
leaf frequencies sorted ascending, ``BIG`` for unused symbols.  Each of
``max_len - 1`` package levels pairs adjacent entries of the previous level
and merges the packages with the leaves; entries are packed
``value * 2 | kind`` (kind 1 = package), so equal-value leaves order before
packages.  A backward pass counts the leaves among the selected prefix of
each level; the code length of rank ``r`` is the number of levels whose
count exceeds ``r``.  The leaf sort and the unsort to symbol order stay in
``ops/package_merge.py``.

:func:`lengths_by_rank_plain` is the JAX package's XLA formulation
(``package_merge.package_merge_lengths``, a full sort per level) batched.
The CUDA kernel (``csrc/package_merge.cu``) gives one block to each row and
sizes the work by the row's live leaves: a level's list holds the leaves and
the packages below ``BIG`` of the level before, formed where they are read;
every thread merges a short run of consecutive places of the two sorted
lists, found by one binary search, and keeps their leaf flags as a bit word
for the backward pass.
"""

from __future__ import annotations

import ctypes

import torch

from ..runtime import cuda

BIG = 1 << 29  # value sentinel for padding; sums are clamped below it

_KERNEL = cuda.register("package_merge", [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # leaves, R, A, max_len
    ctypes.c_void_p,                                            # out
])


def lengths_by_rank_plain(leaf_vals: torch.Tensor, max_len: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`lengths_by_rank` (same output)."""
    R, A = leaf_vals.shape
    dev = leaf_vals.device
    leaf_packed = leaf_vals.long() * 2
    packed = torch.cat([leaf_packed, torch.full_like(leaf_packed, BIG * 2 + 1)], dim=1)
    cums = [torch.cumsum(1 - (packed & 1), dim=1)]
    for _ in range(max_len - 1):
        pair = torch.clamp((packed[:, 0::2] >> 1) + (packed[:, 1::2] >> 1), max=BIG)
        packed = torch.sort(torch.cat([leaf_packed, pair * 2 + 1], dim=1), dim=1).values
        cums.append(torch.cumsum(1 - (packed & 1), dim=1))
    m = (leaf_vals < BIG).sum(dim=1)
    rank = torch.arange(A, device=dev)
    lengths = torch.zeros((R, A), dtype=torch.int64, device=dev)
    n_sel = (2 * m - 2).clamp(min=0)
    for cum in reversed(cums):
        take = n_sel.clamp(0, 2 * A)
        got = cum.gather(1, (take - 1).clamp(min=0)[:, None])[:, 0]
        leaf_count = torch.where(take > 0, got, 0)
        lengths += rank[None, :] < leaf_count[:, None]
        n_sel = 2 * (take - leaf_count)
    return lengths.int()


def lengths_by_rank(leaf_vals: torch.Tensor, max_len: int) -> torch.Tensor:
    """Optimal length-limited code lengths by frequency rank.

    Args:
      leaf_vals: int32[R, A] per-row frequencies sorted ascending, ``BIG``
        for unused symbols; the live ones of a row sum to at most 2**25 + 1
        (``package_merge.MAX_ROW_SUM``), so no package reaches ``BIG``.
      max_len: depth limit (15 for litlen/dist, 7 for the clen alphabet).

    Returns int32[R, A]: code length of the r-th cheapest symbol.
    """
    if not leaf_vals.is_cuda:
        return lengths_by_rank_plain(leaf_vals, max_len)
    R, A = leaf_vals.shape
    if A > 512 or not 2 <= max_len <= 16:
        raise ValueError(f"package_merge: unsupported A={A}, max_len={max_len}")
    cuda.check_cuda(leaf_vals, "leaf_vals", torch.int32, (R, A))
    out = torch.empty((R, A), dtype=torch.int32, device=leaf_vals.device)
    if R:
        _KERNEL(leaf_vals.device, leaf_vals.data_ptr(), R, A, max_len, out.data_ptr())
    return out
