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
# Largest sum of a row's frequencies that the lengths are proven at.
MAX_ROW_SUM = (1 << 24) + 1


def package_merge_rows(freqs: torch.Tensor, max_len: int) -> torch.Tensor:
    """Code lengths int32[R, A] for ``freqs`` int[R, A] (0 = unused).

    All-zero if a row uses no symbol; a single used symbol gets length 1.
    A row's frequencies must sum to at most ``MAX_ROW_SUM`` (a block of a
    16 MiB chunk: 2**24 symbols and EOB).  The int64 sort keys order any
    frequencies, and the package sums stay below the ``BIG`` clamp: the list
    of a level holds the leaves (their sum W) and packages made of disjoint
    pairs of the level below, so its values sum to at most W plus that
    level's sum, and a list ``max_len - 1`` levels up from the leaves sums
    to at most ``max_len * W``.  A package is part of the level above's list,
    so every package is at most ``15 * (2**24 + 1)`` = 251,658,255, under
    2**28 < ``BIG``; a leaf is at most the row's sum.

    Unused leaves sort past every used one whatever its frequency, so a
    symbol of frequency 2**20 or more (key 2**29 + sym and up) keeps its
    code.  The JAX package's XLA form sorts the unused symbols ahead of such
    a symbol (its int32 key passes their ``2**29 + s``, wraps below 0 at
    2**22 and to ``sym`` itself at 2**23 and 2**24) and gives it length 0,
    but where the wrap puts it first, a block of one symbol and EOB gets
    both lengths right.
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
