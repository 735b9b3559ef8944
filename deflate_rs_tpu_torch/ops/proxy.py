"""The block-split entropy proxy, equal to the JAX package's float32 form.

The JAX encoder scores split compositions with per-symbol code lengths
``clip(ceil(log2(tot) - log2(f)), 1, 15)`` evaluated in float32
(``deflate_rs_tpu/ops/chunk_encode.py``, ``_proxy_bits``).  Away from exact
powers of two, ``log2(tot / f)`` lies far enough from an integer for float32
to round it the right way, so the exact integer count of
:func:`proxy_code_lengths` agrees.  At ``tot == f << k`` XLA's ``log2``
rounds up to ``k + 1`` for some pairs (f, k) and not for others.

Those pairs are held in a committed table, ``data/proxy_roundup.npy``: one
bit per (k, f) with ``1 <= k <= 14`` and ``f << k <= TOT_MAX``, rows of
increasing k, f from 1, packed with ``numpy.packbits``.  A set bit says the
JAX form gives ``k + 1`` at ``tot == f << k``.  The table was generated from
the JAX expression itself, in the encoder's ``[R, 286]`` jit form;
``tests/test_torch_proxy.py`` regenerates it and compares (run that file as
a script to rewrite it).  The lookup is integer work, so every device gives
the same lengths.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..constants import MAX_CODE_LENGTH

TABLE_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "data", "proxy_roundup.npy")
# Largest symbol total a range histogram reaches: the 262,144 tokens of the
# widest chunk the corpus engine takes, plus EOB, with margin.
TOT_MAX = 262209
K_MAX = MAX_CODE_LENGTH - 1  # at k = 15 the clip hides any round-up


def table_rows() -> list:
    """(k, number of f values) per row of the round-up table."""
    return [(k, TOT_MAX >> k) for k in range(1, K_MAX + 1)]


def row_offsets() -> np.ndarray:
    """int64[MAX_CODE_LENGTH + 1]: flat index of (k, f = 1) at entry k."""
    off = np.zeros(MAX_CODE_LENGTH + 1, np.int64)
    pos = 0
    for k, count in table_rows():
        off[k] = pos
        pos += count
    return off


def load_roundup_table() -> np.ndarray:
    """The committed table as a flat bool array (see the module docstring)."""
    total = sum(c for _, c in table_rows())
    return np.unpackbits(np.load(TABLE_PATH), count=total).astype(bool)


def proxy_code_lengths(tot: torch.Tensor, f: torch.Tensor, roundup: torch.Tensor,
                       offsets: torch.Tensor) -> torch.Tensor:
    """Proxy code lengths of frequencies ``f`` in a histogram of total ``tot``.

    The exact ``clip(ceil(log2(tot / f)), 1, 15)`` (the count of k >= 0 with
    ``f << k < tot``), plus one where the JAX float32 form rounds an exact
    power-of-two ratio up.  ``roundup``/``offsets`` come from
    :func:`load_roundup_table` / :func:`row_offsets`.
    """
    tot = tot.clamp(min=1)
    f = f.clamp(min=1)
    k = torch.zeros_like(f)
    for s in range(MAX_CODE_LENGTH):
        k += (f << s) < tot
    on_row = (k >= 1) & (k <= K_MAX)
    kc = k.clamp(1, K_MAX)
    hit = on_row & ((f << kc) == tot) & (tot <= TOT_MAX)
    flat = (offsets[kc] + f - 1).clamp(0, roundup.shape[0] - 1)
    up = hit & roundup[flat]
    return (k + up.long()).clamp(1, MAX_CODE_LENGTH)


def proxy_bits(freq: torch.Tensor, roundup: torch.Tensor, offsets: torch.Tensor):
    """(token bits, used symbols, zero-run starts) of histograms ``freq``
    int64[..., A], summed over the last axis (``_proxy_bits``)."""
    lens = proxy_code_lengths(freq.sum(dim=-1, keepdim=True), freq, roundup, offsets)
    bits = torch.where(freq > 0, freq * lens, 0).sum(dim=-1)
    used = freq > 0
    prev = torch.nn.functional.pad(used[..., :-1], (1, 0))
    return bits, used.sum(dim=-1), (prev & ~used).sum(dim=-1)
