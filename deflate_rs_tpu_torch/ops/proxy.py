"""The block-split entropy proxy, equal to the JAX package's float32 form.

The JAX encoder scores split compositions with per-symbol code lengths
``clip(ceil(log2(tot) - log2(f)), 1, 15)`` evaluated in float32
(``deflate_rs_tpu/ops/chunk_encode.py``, ``_proxy_bits``).  Away from exact
powers of two, ``log2(tot / f)`` lies far enough from an integer for float32
to round it the right way, so the exact integer count of
:func:`proxy_code_lengths` agrees.  Near ``tot == f << k`` it need not:

- at ``tot == f << k`` XLA's ``log2`` rounds up to ``k + 1`` for some pairs
  (f, k) and not for others;
- at ``tot == (f << k) - 1`` it gives ``k + 1`` for some pairs, and at
  ``tot == (f << k) + 1`` it gives ``k`` for some, where the exact counts
  are ``k`` and ``k + 1`` (none below a total of 647,681; none at two or
  more from ``f << k``).

Those pairs are held in committed tables, one bit per (k, f) with
``1 <= k <= 14`` and ``f << k <= TOT_MAX``, rows of increasing k, f from 1,
packed with ``numpy.packbits``: ``data/proxy_roundup.npy`` for the exact
ratios (a set bit says the JAX form gives ``k + 1`` at ``tot == f << k``),
``data/proxy_neighbours.npy`` for the two neighbours (two such rows of
bits: the JAX form gives ``k + 1`` at ``(f << k) - 1``, and ``k`` at
``(f << k) + 1``).  The tables were generated from the JAX expression
itself, in the encoder's ``[R, 286]`` jit form; ``tests/test_torch_proxy.py``
regenerates them and compares (run that file as a script to rewrite them).
The lookup is integer work, so every device gives the same lengths.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..constants import MAX_CODE_LENGTH

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
TABLE_PATH = os.path.join(DATA_DIR, "proxy_roundup.npy")
NEIGHBOURS_PATH = os.path.join(DATA_DIR, "proxy_neighbours.npy")
# Largest symbol total a range histogram reaches: the 1,048,576 tokens of the
# widest chunk the corpus engine takes (``parallel/corpus.py``:
# ``MAX_CHUNK_SIZE``), plus EOB, with margin.
TOT_MAX = 1048641
K_MAX = MAX_CODE_LENGTH - 1  # at k = 15 the clip hides any rounding


def table_rows() -> list:
    """(k, number of f values) per row of a table."""
    return [(k, TOT_MAX >> k) for k in range(1, K_MAX + 1)]


def table_size() -> int:
    """Entries of one table."""
    return sum(c for _, c in table_rows())


def row_offsets() -> np.ndarray:
    """int64[MAX_CODE_LENGTH + 1]: flat index of (k, f = 1) at entry k."""
    off = np.zeros(MAX_CODE_LENGTH + 1, np.int64)
    pos = 0
    for k, count in table_rows():
        off[k] = pos
        pos += count
    return off


def load_roundup_table() -> np.ndarray:
    """The exact-ratio table as a flat bool array (see the module docstring)."""
    return np.unpackbits(np.load(TABLE_PATH), count=table_size()).astype(bool)


def load_neighbour_tables() -> np.ndarray:
    """bool[2, table_size()]: the tables of ``(f << k) - 1`` and ``(f << k) + 1``."""
    packed = np.load(NEIGHBOURS_PATH)
    return np.stack([np.unpackbits(row, count=table_size()).astype(bool) for row in packed])


def load_tables() -> np.ndarray:
    """bool[3, table_size()]: the exact-ratio table, then the two neighbours'
    (the operand ``tables`` of :func:`proxy_code_lengths`)."""
    return np.concatenate([load_roundup_table()[None], load_neighbour_tables()])


def _on_table(tot, f, k, plane, tables, offsets):
    """Bit ``plane`` of ``tables`` at (k, f) where ``f << k == tot`` is an
    entry of the tables, else False."""
    kc = k.clamp(1, K_MAX)
    hit = (k >= 1) & (k <= K_MAX) & ((f << kc) == tot) & (tot <= TOT_MAX)
    flat = (offsets[kc] + f - 1).clamp(0, tables.shape[1] - 1)
    return hit & tables[plane][flat]


def proxy_code_lengths(tot: torch.Tensor, f: torch.Tensor, tables: torch.Tensor,
                       offsets: torch.Tensor) -> torch.Tensor:
    """Proxy code lengths of frequencies ``f`` in a histogram of total ``tot``.

    The exact ``clip(ceil(log2(tot / f)), 1, 15)`` (the count of k >= 0 with
    ``f << k < tot``), plus one where the JAX float32 form rounds an exact
    power-of-two ratio or the total just below it up, minus one where it
    rounds the total just above it down.  ``tables``/``offsets`` come from
    :func:`load_tables` / :func:`row_offsets`.
    """
    tot = tot.clamp(min=1)
    f = f.clamp(min=1)
    k = torch.zeros_like(f)
    for s in range(MAX_CODE_LENGTH):
        k += (f << s) < tot
    # tot == f << k, or tot == (f << k) - 1: the exact count is k.
    up = (_on_table(tot, f, k, 0, tables, offsets)
          | _on_table(tot + 1, f, k, 1, tables, offsets))
    # tot == (f << (k - 1)) + 1: the exact count is k.
    down = _on_table(tot - 1, f, k - 1, 2, tables, offsets)
    return (k + up.long() - down.long()).clamp(1, MAX_CODE_LENGTH)


def proxy_bits(freq: torch.Tensor, tables: torch.Tensor, offsets: torch.Tensor):
    """(token bits, used symbols, zero-run starts) of histograms ``freq``
    int64[..., A], summed over the last axis (``_proxy_bits``)."""
    lens = proxy_code_lengths(freq.sum(dim=-1, keepdim=True), freq, tables, offsets)
    bits = torch.where(freq > 0, freq * lens, 0).sum(dim=-1)
    used = freq > 0
    prev = torch.nn.functional.pad(used[..., :-1], (1, 0))
    return bits, used.sum(dim=-1), (prev & ~used).sum(dim=-1)
