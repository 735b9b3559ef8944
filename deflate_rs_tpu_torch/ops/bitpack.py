"""Parallel LSB-first bit concatenation, batched over chunks.

Port of ``deflate_rs_tpu/ops/bitpack.py`` (the reference's sequential
``LsbWriter::write_bits``, bitstream.rs:76-86).  Every emitted quantity is a
(value, nbits) field; an exclusive prefix sum of the widths gives each
field's bit offset, hence its word ``off >> 5`` and phase ``off & 31``.
Fields are contiguous and at most 32 bits wide, so a field's low part lands
in its own word and its straddling high part in the next; the parts landing
in one word are bitwise disjoint, so adding them is OR-ing them.  Where the
JAX package compacts per-word boundary sums with a sort, this port adds the
parts into their words with one ``scatter_add`` — the same words.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def pack_fields(values: torch.Tensor, nbits: torch.Tensor, num_words: int):
    """Pack bit fields into little-endian 32-bit words.

    Args:
      values: int[B, F] field values (unsigned 32-bit; only the low
        ``nbits`` bits are used).
      nbits: int[B, F] field widths, 0..32.
      num_words: output words per row.

    Returns (words int64[B, num_words] holding uint32 values,
    total_bits int64[B]).
    """
    B, F = values.shape
    nb = nbits.long()
    vals = values.long() & ((1 << nb) - 1)
    ends = torch.cumsum(nb, dim=1)
    offs = ends - nb
    total_bits = ends[:, -1] if F else torch.zeros(B, dtype=torch.int64, device=values.device)
    word = offs >> 5
    sh = offs & 31
    lo = (vals << sh) & _M32
    hi = torch.where(sh == 0, 0, vals >> (32 - sh))
    words = torch.zeros((B, num_words + 2), dtype=torch.int64, device=values.device)
    words.scatter_add_(1, word.clamp(max=num_words), lo)
    words.scatter_add_(1, (word + 1).clamp(max=num_words + 1), hi)
    words = words[:, :num_words]
    widx = torch.arange(num_words, device=values.device)
    words = torch.where(widx * 32 < total_bits[:, None], words, 0)
    return words, total_bits


def words_to_bytes(words: torch.Tensor) -> torch.Tensor:
    """uint32 values in int[W] little-endian words -> uint8[4W] bytes, on the
    device of ``words``."""
    shifts = torch.arange(0, 32, 8, device=words.device)
    return ((words.long()[:, None] >> shifts) & 0xFF).to(torch.uint8).reshape(-1)
