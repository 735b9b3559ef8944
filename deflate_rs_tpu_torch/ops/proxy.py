"""The block-split entropy proxy, equal to the JAX package's float32 form.

The JAX encoder scores split compositions with per-symbol code lengths
``clip(ceil(log2(tot) - log2(f)), 1, 15)`` evaluated in float32
(``deflate_rs_tpu/ops/chunk_encode.py``, ``_proxy_bits``).  Away from exact
powers of two, ``log2(tot / f)`` lies far enough from an integer for float32
to round it the right way, so the exact integer count of
:func:`proxy_code_lengths` agrees.  Near ``tot == f << k`` it need not: the
exact count steps from ``k`` to ``k + 1`` between ``tot == f << k`` and
``tot == (f << k) + 1``, and the JAX form steps at ``tot == (f << k) + c``,
where the switch offset ``c`` of the pair (k, f) lies between -62 and 81:

- ``c <= 0``: the JAX form gives ``k + 1`` from ``-c`` below ``f << k``
  (``c == 0``: at the exact ratio alone, for some pairs at any total);
- ``c >= 2``: it gives ``k`` up to ``c - 1`` above ``f << k``.

How far the step moves grows with the total, float32's spacing at
``log2(tot)`` being fixed against a gap ``log2(1 + d / tot)`` that shrinks:
no pair has ``c`` outside 0..1 below a total of 647,681, none outside
-1..2 up to 1,048,641, -5..8 up to 4,194,369 (4 MiB chunks), -11..16 up to
8,388,673, -31..40 up to 16,777,281 (16 MiB chunks) and -62..81 up to
``TOT_MAX``.  Past 2**24 float32 rounds the total itself (to an even
integer), and at k = 1 the frequency too, which moves the step but keeps it
a step (in the ``[R, 30]`` form at every total of the sweep below, at every
pair).

The offsets are held in one committed table, ``data/proxy_switch.i8.xz``:
one entry per (k, f) with ``1 <= k <= 14`` and ``f << k <= TOT_MAX``, rows
of increasing k, f from 1, each ``c`` one int8, the whole compressed with
lzma (33,552,511 entries in about 1.5 MB; unpacked once a process; an
encoder holds the pairs its chunk size can reach).  The
JAX form is a step of ``tot`` at each pair; the table was generated from
the JAX expression itself, in the encoder's jit forms of a range histogram
(``[R, 30]`` at every total from ``f << k`` - 64 to + 64, past 16,777,281
from - 128 to + 128, ``[R, 286]`` on both sides of each step; up to
4,194,369 both forms at every total within 10 of ``f << k``);
``tests/test_torch_proxy.py`` and
``tests/test_torch_proxy_wide_*.py`` hold it to both forms (run the first
as a script to rewrite it).  The lookup is integer work, so every device
gives the same lengths.
"""

from __future__ import annotations

import functools
import lzma
import os

import numpy as np
import torch

from ..constants import MAX_CODE_LENGTH

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
TABLE_PATH = os.path.join(DATA_DIR, "proxy_switch.i8.xz")
# Totals past a range's largest one whose pairs a table must hold: wider than
# any switch offset (at most 62 below ``f << k``), so that a total's nearest
# ``f << k`` above it is an entry.
SWITCH_MARGIN = 128
# Largest symbol total a range histogram reaches: the 33,554,432 tokens of
# the widest chunk the corpus engine takes (``parallel/corpus.py``:
# ``MAX_CHUNK_SIZE``), plus EOB; the table covers it with the margin.
TOT_MAX = (1 << 25) + 1 + SWITCH_MARGIN
K_MAX = MAX_CODE_LENGTH - 1  # at k = 15 the clip hides any rounding
# Token bits below this are exact in float32 whatever the order of the sum.
F32_EXACT_BITS = 1 << 24


def table_rows(tot_max: int = TOT_MAX) -> list:
    """(k, number of f values) per row of the table of the pairs with
    ``f << k <= tot_max``."""
    return [(k, tot_max >> k) for k in range(1, K_MAX + 1)]


def table_size(tot_max: int = TOT_MAX) -> int:
    """Entries of that table."""
    return sum(c for _, c in table_rows(tot_max))


def row_offsets(tot_max: int = TOT_MAX) -> np.ndarray:
    """int64[MAX_CODE_LENGTH + 1]: flat index of (k, f = 1) in that table at
    entry k, its size at entry ``K_MAX + 1``."""
    off = np.zeros(MAX_CODE_LENGTH + 1, np.int64)
    pos = 0
    for k, count in table_rows(tot_max):
        off[k] = pos
        pos += count
    off[K_MAX + 1] = pos
    return off


def pack_switch_table(c: np.ndarray) -> bytes:
    """The file's form of the switch offsets ``c``: int8, lzma-compressed."""
    c = np.asarray(c, np.int64)
    if c.size and (c.min() < -128 or c.max() > 127):
        raise ValueError(f"switch offsets {int(c.min())}..{int(c.max())} do not fit int8")
    return lzma.compress(c.astype(np.int8).tobytes(), preset=9 | lzma.PRESET_EXTREME)


@functools.lru_cache(maxsize=1)
def _table_bytes() -> bytes:
    with open(TABLE_PATH, "rb") as f:
        raw = lzma.decompress(f.read())
    if len(raw) != table_size():
        raise ValueError(f"{TABLE_PATH}: {len(raw)} entries, expected {table_size()}")
    return raw


def load_switch_table(tot_max: int = TOT_MAX) -> np.ndarray:
    """int8[table_size(tot_max)]: the switch offset ``c`` of every (k, f)
    with ``f << k <= tot_max`` (the operand ``table`` of
    :func:`proxy_code_lengths`, beside ``row_offsets(tot_max)``).  An encoder
    whose range totals stay at or below T needs the pairs up to
    ``T + SWITCH_MARGIN`` only."""
    if tot_max > TOT_MAX:
        raise ValueError(f"the switch table covers totals up to {TOT_MAX}, not {tot_max}")
    whole = np.frombuffer(_table_bytes(), np.int8)
    off = row_offsets()
    return np.concatenate([whole[off[k] : off[k] + count] for k, count in table_rows(tot_max)])


def _switch_at(f, k, table, offsets):
    """(the switch offset of (k, f), whether (k, f) is an entry)."""
    kc = k.clamp(1, K_MAX)
    entry = (k >= 1) & (k <= K_MAX) & (f <= offsets[kc + 1] - offsets[kc])
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
    JAX package's reduction on the CPU.  A row of more than 32 values (the
    litlen histograms' 286) is padded with zeros to whole windows of 32, half
    the padding before it, each window summed in order and then the windows
    in order (XLA's tree-reduction rewrite, ``reduce-window`` of 32 then a
    reduce).  A shorter row (the distance histograms' 30) is XLA's
    vectorized row reduction: 8 lanes, lane j summing values j, j + 8, ...
    of the first whole multiple of 8 in order, the lanes then added as a
    halving tree (lane j + lane j + 4, then + 2, then + 1), and the values
    past the last multiple of 8 added in order after it (measured against
    the JAX form at totals up to 2**25 + 1, where the order shows; below
    about 2**22 the sums in order agree with it).  Every addition rounds to
    float32, as XLA's do."""
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
    m = A // 8 * 8
    acc = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
    if m:
        lanes = x[..., :8]
        for i in range(8, m, 8):
            lanes = lanes + x[..., i : i + 8]
        while lanes.shape[-1] > 1:
            h = lanes.shape[-1] // 2
            lanes = lanes[..., :h] + lanes[..., h:]
        acc = lanes[..., 0]
    for i in range(m, A):
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
