"""The block-split entropy proxy, equal to the JAX package's float32 form.

The JAX encoder scores split compositions with per-symbol code lengths
``clip(ceil(log2(tot) - log2(f)), 1, 15)`` evaluated in float32
(``deflate_rs_tpu/ops/chunk_encode.py``, ``_proxy_bits``).  Away from exact
powers of two, ``log2(tot / f)`` lies far enough from an integer for float32
to round it the right way, so the exact integer count of
:func:`proxy_code_lengths` agrees.  Near ``tot == f << k`` it need not: the
exact count steps from ``k`` to ``k + 1`` between ``tot == f << k`` and
``tot == (f << k) + 1``, and the JAX form steps at ``tot == (f << k) + c``,
where the switch offset ``c`` of the pair (k, f) lies between -5 and 8:

- ``c <= 0``: the JAX form gives ``k + 1`` from ``-c`` below ``f << k``
  (``c == 0``: at the exact ratio alone, for some pairs at any total);
- ``c >= 2``: it gives ``k`` up to ``c - 1`` above ``f << k``.

How far the step moves grows with the total, float32's spacing at
``log2(tot)`` being fixed against a gap ``log2(1 + d / tot)`` that shrinks:
no pair has ``c`` outside 0..1 below a total of 647,681, and none outside
-1..2 up to 1,048,641.  Of the 3,145,536 pairs above 1,048,641 (k from 1
to 14, totals up to ``TOT_MAX``), 2,232,341 step elsewhere than the exact
count (``c != 1``), 927,200 of them two or more totals from it (``c <= -1``
or ``c >= 3``).

The offsets are held in one committed table, ``data/proxy_switch.npy``: one
entry per (k, f) with ``1 <= k <= 14`` and ``f << k <= TOT_MAX``, rows of
increasing k, f from 1, each ``c - C_MIN`` in four bits, two entries a byte
(the first in the low bits).  The JAX form is a step of ``tot`` at each
pair (checked at every total within 10 of ``f << k``); the table was
generated from the JAX expression itself, in the encoder's jit forms of a
range histogram (``[R, 286]`` and ``[R, 30]`` give the same lengths at every
total within 10 of ``f << k`` over the whole table);
``tests/test_torch_proxy.py`` regenerates it in both forms and compares (run
that file as a script to rewrite it).  The lookup is integer work, so every
device gives the same lengths.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..constants import MAX_CODE_LENGTH

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
TABLE_PATH = os.path.join(DATA_DIR, "proxy_switch.npy")
# Largest symbol total a range histogram reaches: the 4,194,304 tokens of the
# widest chunk the corpus engine takes (``parallel/corpus.py``:
# ``MAX_CHUNK_SIZE``), plus EOB, with a margin wider than any switch offset,
# so a total's nearest ``f << k`` above it is an entry of the table.
TOT_MAX = (1 << 22) + 65
K_MAX = MAX_CODE_LENGTH - 1  # at k = 15 the clip hides any rounding
C_MIN = -7  # switch offsets are stored as c - C_MIN, 0..15
# Token bits below this are exact in float32 whatever the order of the sum.
F32_EXACT_BITS = 1 << 24


def table_rows() -> list:
    """(k, number of f values) per row of the table."""
    return [(k, TOT_MAX >> k) for k in range(1, K_MAX + 1)]


def table_size() -> int:
    """Entries of the table."""
    return sum(c for _, c in table_rows())


def row_offsets() -> np.ndarray:
    """int64[MAX_CODE_LENGTH + 1]: flat index of (k, f = 1) at entry k."""
    off = np.zeros(MAX_CODE_LENGTH + 1, np.int64)
    pos = 0
    for k, count in table_rows():
        off[k] = pos
        pos += count
    return off


def pack_switch_table(c: np.ndarray) -> np.ndarray:
    """uint8 nibble pairs of the switch offsets ``c`` (the file's form)."""
    v = np.asarray(c, np.int64) - C_MIN
    if v.min() < 0 or v.max() > 15:
        raise ValueError(f"switch offsets {int(c.min())}..{int(c.max())} do not fit four bits")
    v = np.concatenate([v, np.zeros(len(v) % 2, np.int64)]).astype(np.uint8)
    return v[0::2] | (v[1::2] << 4)


def load_switch_table() -> np.ndarray:
    """int8[table_size()]: the switch offset ``c`` of every (k, f) (the
    operand ``table`` of :func:`proxy_code_lengths`)."""
    packed = np.load(TABLE_PATH)
    v = np.stack([packed & 15, packed >> 4], axis=1).reshape(-1)[: table_size()]
    return v.astype(np.int8) + np.int8(C_MIN)


def _switch_at(f, k, table, offsets):
    """(the switch offset of (k, f), whether (k, f) is an entry)."""
    kc = k.clamp(1, K_MAX)
    entry = (k >= 1) & (k <= K_MAX) & ((f << kc) <= TOT_MAX)
    flat = (offsets[kc] + f - 1).clamp(0, table.shape[0] - 1)
    return table[flat].long(), entry


def proxy_code_lengths(tot: torch.Tensor, f: torch.Tensor, table: torch.Tensor,
                       offsets: torch.Tensor) -> torch.Tensor:
    """Proxy code lengths of frequencies ``f`` in a histogram of total ``tot``.

    The exact ``clip(ceil(log2(tot / f)), 1, 15)`` (the count ``k`` of
    s >= 0 with ``f << s < tot``), plus one where ``tot`` lies at or past the
    JAX form's step below ``f << k``, minus one where it lies short of the
    JAX form's step above ``f << (k - 1)``.  ``table``/``offsets`` come from
    :func:`load_switch_table` / :func:`row_offsets`.
    """
    tot = tot.clamp(min=1)
    f = f.clamp(min=1)
    k = torch.zeros_like(f)
    for s in range(MAX_CODE_LENGTH):
        k += (f << s) < tot
    # f << (k - 1) < tot <= f << k (where 1 <= k <= 14).
    c_up, on_up = _switch_at(f, k, table, offsets)
    up = on_up & (tot - (f << k.clamp(max=K_MAX)) >= c_up)
    c_down, on_down = _switch_at(f, k - 1, table, offsets)
    down = on_down & (tot - (f << (k - 1).clamp(min=0)) < c_down)
    return (k + up.long() - down.long()).clamp(1, MAX_CODE_LENGTH)


def xla_f32_row_sum(x: torch.Tensor) -> torch.Tensor:
    """float32 sums over the last axis of ``x``, added in the order of the
    JAX package's reduction on the CPU: a row of more than 32 values (the
    litlen histograms' 286) is padded with zeros to whole windows of 32, half
    the padding before it, each window summed in order and then the windows
    in order (XLA's tree-reduction rewrite, ``reduce-window`` of 32 then a
    reduce); a shorter row (the distance histograms' 30) in order.  Every
    addition rounds to float32, as XLA's do."""
    A = x.shape[-1]
    if A > 32:
        pad = -A % 32
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2)).unflatten(-1, (-1, 32))
        acc = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
        for i in range(32):
            acc = acc + x[..., i]
        x = acc
    acc = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
    for i in range(x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def proxy_bits(freq: torch.Tensor, table: torch.Tensor, offsets: torch.Tensor, *,
               float32_sums: bool = False):
    """(token bits, used symbols, zero-run starts) of histograms ``freq``
    int64[..., A], summed over the last axis (``_proxy_bits``).

    The JAX form multiplies and sums the token bits in float32.  Where they
    stay below ``F32_EXACT_BITS`` (15 bits a symbol: totals up to 1,118,481,
    every chunk up to 1 MiB) that is the exact integer sum, taken here;
    ``float32_sums`` rounds the products and every addition to float32 in the
    JAX package's order instead (:func:`xla_f32_row_sum`), as wider chunks
    need."""
    lens = proxy_code_lengths(freq.sum(dim=-1, keepdim=True), freq, table, offsets)
    if float32_sums:
        bits = xla_f32_row_sum(torch.where(freq > 0, freq.float() * lens.float(), 0.0)).long()
    else:
        bits = torch.where(freq > 0, freq * lens, 0).sum(dim=-1)
    used = freq > 0
    prev = torch.nn.functional.pad(used[..., :-1], (1, 0))
    return bits, used.sum(dim=-1), (prev & ~used).sum(dim=-1)
