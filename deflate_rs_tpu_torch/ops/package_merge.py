"""Optimal length-limited Huffman code lengths via package-merge, batched.

Port of ``deflate_rs_tpu/ops/package_merge.py`` (the reference's
Moffat–Katajainen lengths plus repair, length_encode.rs:290-415, replaced by
package-merge, which is exactly optimal under the limit).  The leaves are
sorted by (frequency, symbol) here, the per-level work runs in
``ops/pm_kernel.py`` (CUDA kernel on the card, plain twin on the CPU), and
the lengths are scattered back to symbol order.
"""

from __future__ import annotations

import torch

from .pm_kernel import BIG, lengths_by_rank

# Sort key of an unused leaf, past the key ``f * 512 + sym`` of every used one.
_UNUSED = 1 << 40


def package_merge_rows(freqs: torch.Tensor, max_len: int) -> torch.Tensor:
    """Code lengths int32[R, A] for ``freqs`` int[R, A] (0 = unused).

    All-zero if a row uses no symbol; a single used symbol gets length 1.
    Frequencies must be at most 2**20 (one 1 MiB block).  Above that the
    int64 sort keys still order the leaves, but that the package sums stay
    below the ``BIG`` clamp is not proven there.

    Unused leaves sort past every used one whatever its frequency, so a
    symbol of frequency 2**20 (key 2**29 + sym) keeps its code.  The JAX
    package's XLA form sorts the unused symbols below such a symbol ahead
    of it and gives it length 0.
    """
    R, A = freqs.shape
    f = freqs.long()
    active = f > 0
    m = active.sum(dim=1, keepdim=True)
    sym = torch.arange(A, device=f.device)
    leaf_key = torch.where(active, f * 512 + sym, _UNUSED + sym)
    skey, perm = torch.sort(leaf_key, dim=1)  # keys are unique
    leaf_vals = torch.where(skey < _UNUSED, f.gather(1, perm), BIG).int()
    by_rank = lengths_by_rank(leaf_vals.contiguous(), max_len)
    lengths = torch.zeros_like(by_rank).scatter_(1, perm, by_rank)
    lengths = torch.where(m > 1, lengths, torch.where(m == 1, active.int(), 0))
    return torch.where(active, lengths, 0).int()


def package_merge_lengths(freqs: torch.Tensor, max_len: int) -> torch.Tensor:
    """Code lengths int32[A] for one alphabet's ``freqs`` int[A]: the row
    form of :func:`package_merge_rows`, on the device of ``freqs``."""
    return package_merge_rows(freqs[None], max_len)[0]
