"""The JAX package's block-split proxy lengths, measured for the port's
switch table (``deflate_rs_tpu_torch/ops/proxy.py``), shared by
``tests/test_torch_proxy.py`` and ``tests/test_torch_proxy_wide_*.py``.

The JAX encoder computes ``clip(ceil(log2(tot) - log2(f)), 1, 15)`` in
float32 (``deflate_rs_tpu/ops/chunk_encode.py:380-393``).  A pair (k, f) of
the table is measured on histogram rows with ``f`` in column 0 and the rest
of the total in column 1, in the encoder's two jit forms of a range
histogram, ``[R, 286]`` (litlen) and ``[R, 30]`` (distance), evaluated on
``[SLICE_ROWS, width]`` arrays.  Importing this module imports JAX.
"""

import numpy as np

import jax
import jax.numpy as jnp

from deflate_rs_tpu_torch.ops import proxy

NL = 286
ND = 30
MAXLEN = 15
SLICE_ROWS = 65536  # rows of one [R, width] evaluation; the last slice is padded
# The table's first form covered totals up to 262,209 (chunks up to 256 KiB),
# its second up to 4,194,369 (chunks up to 4 MiB), its third up to
# 16,777,281 (chunks up to 16 MiB).
NARROW_TOT_MAX = 262209
TOT_MAX_4MIB = (1 << 22) + 65
TOT_MAX_16MIB = (1 << 24) + 65
# Totals from f << k at which both forms are measured up to TOT_MAX_4MIB: the
# switch offsets there lie in -5..8, and from 8 on either side of f << k the
# exact count alone is right.
DELTAS = range(-10, 11)
# Totals from f << k at which the [R, 30] form is measured over the whole
# table: up to TOT_MAX_16MIB (offsets -31..40), and past it (offsets
# -62..81).
WIDE_DELTAS = range(-64, 65)
WIDER_DELTAS = range(-128, 129)
# Pairs measured at once while the whole table is generated (the lengths
# at every total of a sweep are held in memory until the step is checked).
BLOCK_PAIRS = 1 << 20


def jax_lengths(freq_r):
    """The expression of deflate_rs_tpu/ops/chunk_encode.py:382-386."""
    tot = jnp.sum(freq_r, axis=1, keepdims=True).astype(jnp.float32)
    f = freq_r.astype(jnp.float32)
    return jnp.clip(
        jnp.ceil(jnp.log2(jnp.maximum(tot, 1.0)) - jnp.log2(jnp.maximum(f, 1.0))),
        1.0, float(MAXLEN),
    )


def jax_proxy_bits(freq_r):
    """``_proxy_bits`` of deflate_rs_tpu/ops/chunk_encode.py:380-393."""
    lens = jax_lengths(freq_r)
    bits = jnp.sum(jnp.where(freq_r > 0, freq_r.astype(jnp.float32) * lens, 0.0), axis=1)
    used = freq_r > 0
    u = jnp.sum(used, axis=1)
    prev = jnp.concatenate([jnp.zeros((freq_r.shape[0], 1), bool), used[:, :-1]], axis=1)
    z = jnp.sum(prev & ~used, axis=1)
    return bits.astype(jnp.int32), u.astype(jnp.int32), z.astype(jnp.int32)


_jit_lengths = jax.jit(jax_lengths)


def table_pairs(tot_max: int = proxy.TOT_MAX):
    """(k, f) of every table entry with ``f << k <= tot_max``, in the
    table's order (rows of k, f from 1)."""
    ks, fs = [], []
    for k in range(1, proxy.K_MAX + 1):
        count = tot_max >> k
        ks.append(np.full(count, k, np.int64))
        fs.append(np.arange(1, count + 1, dtype=np.int64))
    return np.concatenate(ks), np.concatenate(fs)


def table_index(ks, fs) -> np.ndarray:
    """Flat index of the pairs (k, f) in the committed table."""
    return proxy.row_offsets()[ks] + fs - 1


def measured(base, d) -> np.ndarray:
    """Where a total of ``base + d`` (base = f << k) is measured: its exact
    count is k or k + 1, and its offset is within 10 of ``f << k`` or
    within a quarter of it (far from the steps of the pairs at ``base / 2``
    and ``2 base``)."""
    tot = base + d
    return (tot > base >> 1) & (tot <= base << 1) & ((abs(d) <= 10) | (4 * abs(d) <= base))


def column0_lengths(f, tot, width: int) -> np.ndarray:
    """int64[P]: the JAX lengths of column 0 of rows holding ``f`` and
    ``tot - f``, in the ``[R, width]`` jit form (the last slice padded with
    rows of f = 1 at total 2)."""
    out = np.empty(len(f), np.int64)
    rows = np.zeros((SLICE_ROWS, width), np.int32)
    rows[:, :2] = 1
    for lo in range(0, len(f), SLICE_ROWS):
        n = min(SLICE_ROWS, len(f) - lo)
        rows[:n, 0] = f[lo : lo + n]
        rows[:n, 1] = tot[lo : lo + n] - f[lo : lo + n]
        if n < SLICE_ROWS:
            rows[n:, :2] = 1
        out[lo : lo + n] = np.asarray(_jit_lengths(rows))[:n, 0]
    return out


def delta_lengths(ks, fs, delta: int, width: int) -> np.ndarray:
    """int8[P]: the JAX lengths at ``tot == (f << k) + delta`` for the pairs
    where that total is :func:`measured`, -1 elsewhere."""
    base = fs << ks
    keep = measured(base, delta)
    out = np.full(len(fs), -1, np.int8)
    out[keep] = column0_lengths(fs[keep], base[keep] + delta, width)
    return out


def switch_offsets(ks, fs, deltas, width: int, lengths=None) -> np.ndarray:
    """int64[P]: the switch offset c of every pair (k, f), the least d of
    ``deltas`` at which the JAX form gives k + 1 at tot == (f << k) + d
    (``deltas[-1] + 1`` where it gives k at every measured one).

    At every measured total the JAX form must be the step ``k + (d >= c)``,
    in the ``[R, width]`` jit form; ``lengths(delta)`` may supply the
    measured lengths (:func:`delta_lengths` by default)."""
    lengths = lengths or (lambda d: delta_lengths(ks, fs, d, width))
    c = np.full(len(fs), deltas[-1] + 1, np.int64)
    got = {}
    for d in deltas:
        got[d] = lengths(d).astype(np.int8)
        c = np.where((got[d] == ks + 1) & (c > d), d, c)
    for d, g in got.items():
        bad = (g >= 0) & (g != ks + (d >= c))
        assert not bad.any(), (d, int(bad.sum()))
    return c


def generate_whole_table() -> np.ndarray:
    """int64[table_size()]: the switch offsets of the whole table, measured
    in blocks of ``BLOCK_PAIRS`` pairs in the ``[R, 30]`` form (a step at
    every pair) at ``WIDE_DELTAS`` up to ``TOT_MAX_16MIB`` and at
    ``WIDER_DELTAS`` past it, then held on both sides of each step in the
    ``[R, 286]`` form, and up to ``TOT_MAX_4MIB`` at every total of
    ``DELTAS`` in both forms."""
    ks, fs = table_pairs()
    base = fs << ks
    c = np.empty(len(ks), np.int64)
    for lo, hi, deltas in ((0, TOT_MAX_16MIB, WIDE_DELTAS),
                           (TOT_MAX_16MIB, proxy.TOT_MAX, WIDER_DELTAS)):
        sel = np.flatnonzero((base > lo) & (base <= hi))
        for i in range(0, len(sel), BLOCK_PAIRS):
            idx = sel[i : i + BLOCK_PAIRS]
            c[idx] = switch_offsets(ks[idx], fs[idx], deltas, ND)
            assert deltas[0] < c[idx].min() and c[idx].max() <= deltas[-1]
    for side in (0, 1):
        d = c - 1 + side
        keep = measured(base, d)
        got = column0_lengths(fs[keep], base[keep] + d[keep], NL)
        assert (got == ks[keep] + side).all(), side
    narrow = base <= TOT_MAX_4MIB
    for width in (ND, NL):
        np.testing.assert_array_equal(
            switch_offsets(ks[narrow], fs[narrow], DELTAS, width), c[narrow])
    return c


# The table's entries past TOT_MAX_4MIB, in parts by the total f << k:
# (lowest total excluded, highest included, the sweep of offsets from f << k
# at which the [R, 30] form is measured, pinned (least, greatest switch
# offset), pairs whose offset is not 1, pairs two or more from it, pairs of
# the part, stride).  The sweeps pass the offsets by four on either side.
# Up to TOT_MAX_16MIB three parts of 4,194,048 pairs, each swept at every
# pair (stride 1); past it (chunks above 16 MiB up to 32 MiB) two parts of
# about 8.4 M pairs, swept at every 32nd pair and measured on both sides of
# the step and at the sweep's ends at every pair.
WIDE_PARTS = (
    (TOT_MAX_4MIB, (1 << 23) + 65, range(-15, 21), (-11, 16), 3_703_895, 2_763_874,
     4_194_048, 1),
    ((1 << 23) + 65, 3 * (1 << 22) + 65, range(-28, 35), (-24, 30), 3_981_914, 3_573_665,
     4_194_048, 1),
    (3 * (1 << 22) + 65, TOT_MAX_16MIB, range(-35, 45), (-31, 40), 4_052_770, 3_779_464,
     4_194_048, 1),
    (TOT_MAX_16MIB, 3 * (1 << 23) + 65, range(-53, 67), (-49, 62), 8_299_257, 7_915_347,
     8_388_096, 32),
    (3 * (1 << 23) + 65, proxy.TOT_MAX, range(-66, 86), (-62, 81), 8_325_996, 8_054_050,
     8_388_160, 32),
)


def part_pairs(part: int):
    """(k, f, flat index in the table) of the pairs of ``WIDE_PARTS[part]``."""
    lo, hi = WIDE_PARTS[part][:2]
    ks, fs = table_pairs(hi)
    keep = (fs << ks) > lo
    ks, fs = ks[keep], fs[keep]
    return ks, fs, table_index(ks, fs)


def port_lengths(tot, f) -> np.ndarray:
    """The port's proxy code lengths (``proxy.proxy_code_lengths``)."""
    import torch

    return proxy.proxy_code_lengths(
        torch.from_numpy(np.asarray(tot, np.int64)), torch.from_numpy(np.asarray(f, np.int64)),
        torch.from_numpy(proxy.load_switch_table()),
        torch.from_numpy(proxy.row_offsets())).numpy()


def check_wide_part(part: int) -> None:
    """The committed offsets of one part of ``WIDE_PARTS`` equal those
    measured in the ``[R, 30]`` form at every total of its sweep (where the
    JAX form is a step at each pair), at every pair or every stride-th; the
    ``[R, 286]`` form (and, where the sweep skips pairs, the ``[R, 30]``
    form) gives k at ``(f << k) + c - 1`` and k + 1 at ``(f << k) + c`` at
    every pair; the port's lengths equal the JAX form's there and at both
    ends of the sweep; and the offsets have the pinned range and counts."""
    lo, hi, sweep, (c_min, c_max), off_exact, off_by_two, n_pairs, stride = WIDE_PARTS[part]
    ks, fs, flat = part_pairs(part)
    assert len(ks) == n_pairs
    base = fs << ks
    assert measured(base, sweep[0]).all() and measured(base, sweep[-1]).all()
    c = proxy.load_switch_table()[flat].astype(np.int64)
    np.testing.assert_array_equal(
        switch_offsets(ks[::stride], fs[::stride], sweep, ND), c[::stride])
    assert (int(c.min()), int(c.max())) == (c_min, c_max)
    assert sweep[0] + 4 == c_min and c_max + 4 == sweep[-1]
    assert int((c != 1).sum()) == off_exact
    assert int(((c <= -1) | (c >= 3)).sum()) == off_by_two
    widths = (NL,) if stride == 1 else (NL, ND)
    for d, want in ((c - 1, ks), (c, ks + 1)):
        for width in widths:
            np.testing.assert_array_equal(column0_lengths(fs, base + d, width), want)
        np.testing.assert_array_equal(port_lengths(base + d, fs), want)
    for d in (sweep[0], sweep[-1]):
        want = ks + (d >= c)
        np.testing.assert_array_equal(port_lengths(base + d, fs), want)
        if stride > 1:
            np.testing.assert_array_equal(column0_lengths(fs, base + d, ND), want)


def hitting_rows(rng, R: int, part: int, width: int = NL) -> np.ndarray:
    """int64[R, width] histograms whose random column holds f at a total of
    (f << k) + d for pairs of ``WIDE_PARTS[part]``, d within the part's
    range of switch offsets: three
    quarters at a d where the JAX form leaves the exact count (at or past
    the switch offset below f << k, short of it above), the rest where it
    does not; the rest of the total spread over 1 to 39 other columns."""
    ks, fs, flat = part_pairs(part)
    c = proxy.load_switch_table()[flat].astype(np.int64)
    c_min, c_max = WIDE_PARTS[part][3]
    rows = np.zeros((R, width), np.int64)
    for r in range(R):
        delta = int(rng.integers(c_min + 1, c_max))
        off = (c <= delta) if delta <= 0 else (c > delta)
        cands = np.flatnonzero(off == (r < R - R // 4))
        p = int(rng.choice(cands))
        f, tot = int(fs[p]), int(fs[p] << ks[p]) + delta
        col = int(rng.integers(0, width))
        rows[r, col] = f
        others = rng.choice([x for x in range(width) if x != col],
                            int(rng.integers(1, min(40, width))), replace=False)
        cuts = np.sort(rng.integers(0, tot - f + 1, len(others) - 1))
        rows[r, others] = np.diff(np.concatenate([[0], cuts, [tot - f]]))
        assert rows[r].sum() == tot
    return rows
