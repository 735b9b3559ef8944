"""The port's block-split entropy proxy against the JAX package's float32 form.

The JAX encoder computes ``clip(ceil(log2(tot) - log2(f)), 1, 15)`` in
float32 (``deflate_rs_tpu/ops/chunk_encode.py:380-393``); near
``tot == f << k`` XLA's ``log2`` steps from ``k`` to ``k + 1`` up to a few
totals away from where the exact count does.  The port reproduces it with
exact integers plus a committed table of each pair's switch offset
(``deflate_rs_tpu_torch/data/proxy_switch.i8.xz``).  This file regenerates
the table's entries at totals up to 4,194,369 (chunks up to 4 MiB) from the
JAX expression in both of the encoder's jit forms, ``[R, 286]`` (the litlen
histograms') and ``[R, 30]`` (the distance histograms'), in slices of
``SLICE_ROWS`` rows, at every total within 10 of each ``f << k`` (each
(delta, width) evaluated once a process, ``_delta_lengths``), and compares
them with the committed ones; the exact-ratio entries of the table's first
form, which covered totals up to 262,209, are held to that form's digest.
The entries past 4,194,369 are held in ``tests/test_torch_proxy_wide_*.py``.
Run this file as a script to rewrite the whole table (about 14 minutes;
``torch_proxy_ref.generate_whole_table``):

    JAX_PLATFORMS=cpu python tests/test_torch_proxy.py
"""

import functools
import hashlib
import lzma
import os
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
# The suite runs several workers on one machine: one intra-op thread per
# worker keeps the port's many small ops from oversubscribing the cores.
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from deflate_rs_tpu_torch.ops import proxy  # noqa: E402
from torch_proxy_ref import (  # noqa: E402
    DELTAS, ND, NL, NARROW_TOT_MAX, TOT_MAX_4MIB, column0_lengths, generate_whole_table,
    jax_proxy_bits, measured, switch_offsets, table_index, table_pairs)

# The sha256 of the packed bits of the table's first form (totals up to
# 262,209), generated in one [262192, 286] array.
NARROW_SHA256 = "d522d233a7df52d6e854159225d2c71ad6a8e748a898b67dce43233fbb2ad087"
# Pairs above a total of 1,048,641 and up to 4,194,369 whose switch offset is
# not 1, and those of them two or more from it (the module docstring of
# ops/proxy.py).
WIDE_OFF_EXACT = 2_232_341
WIDE_OFF_BY_TWO = 927_200
# The pairs (k, f) this file measures, f << k <= 4,194,369, and their flat
# index in the committed table.
KS, FS = table_pairs(TOT_MAX_4MIB)
FLAT = table_index(KS, FS)


def _table_pairs(tot_max: int = TOT_MAX_4MIB):
    """(k, f) of every table entry with ``f << k <= tot_max``."""
    return (KS, FS) if tot_max == TOT_MAX_4MIB else table_pairs(tot_max)


@functools.lru_cache(maxsize=None)
def _delta_lengths(delta: int, width: int) -> np.ndarray:
    """int8[P]: the JAX lengths of column 0 at tot == (f << k) + delta for
    every pair (k, f) of ``KS, FS`` with tot >= f, in the ``[R, width]`` jit
    form; -1 at the other pairs.  Read-only: each (delta, width) is
    evaluated once a process and shared by the tests."""
    tot = (FS << KS) + delta
    keep = tot >= FS
    out = np.full(len(FS), -1, np.int8)
    out[keep] = column0_lengths(FS[keep], tot[keep], width)
    out.flags.writeable = False
    return out


def generate_table(width: int = NL) -> np.ndarray:
    """bool[P] over ``KS, FS``: the JAX form gives k + 1 at tot == f << k."""
    lens = _delta_lengths(0, width).astype(np.int64)
    assert set(np.unique(lens - KS)) <= {0, 1}
    return lens == KS + 1


def generate_neighbour_tables(width: int = NL) -> np.ndarray:
    """bool[2, P] over ``KS, FS``: the JAX form gives k + 1 at tot ==
    (f << k) - 1 (the exact count k), and k at tot == (f << k) + 1 (the
    exact count k + 1)."""
    below = _delta_lengths(-1, width).astype(np.int64)
    above = _delta_lengths(1, width).astype(np.int64)
    assert set(np.unique(below - KS)) <= {0, 1} and set(np.unique(above - KS)) <= {0, 1}
    return np.stack([below == KS + 1, above == KS])


def roundup_table() -> np.ndarray:
    """bool[P] over the whole table from the committed switch offsets: the
    JAX form gives ``k + 1`` at ``tot == f << k`` (the table's form up to
    1,048,641)."""
    return proxy.load_switch_table() <= 0


def neighbour_tables() -> np.ndarray:
    """bool[2, P] over the whole table from the committed switch offsets:
    the JAX form gives ``k + 1`` at ``(f << k) - 1``, and ``k`` at
    ``(f << k) + 1``."""
    c = proxy.load_switch_table()
    return np.stack([c <= -1, c >= 2])


def generate_switch_table(width: int = ND) -> np.ndarray:
    """int64[P] over ``KS, FS``: the switch offset c of every (k, f), the
    least d of ``DELTAS`` at which the JAX form gives k + 1 at tot ==
    (f << k) + d.

    Only totals whose exact count is k or k + 1 (``f << (k - 1) < tot <=
    f << (k + 1)``) are measured; at every one of them the JAX form must be
    the step ``k + (d >= c)``; in the ``[R, width]`` jit form."""
    base = FS << KS
    c = switch_offsets(KS, FS, DELTAS, width, lengths=lambda d: np.where(
        measured(base, d), _delta_lengths(d, width), -1))
    assert DELTAS[0] < c.min() and c.max() <= DELTAS[-1]
    return c


def narrow_entries(table: np.ndarray) -> np.ndarray:
    """The entries of ``table`` at every (k, f) with ``f << k <= 262,209``,
    in the order of the table's first form (rows of k, f from 1)."""
    off = proxy.row_offsets()
    return np.concatenate([table[off[k] : off[k] + (NARROW_TOT_MAX >> k)]
                           for k in range(1, proxy.K_MAX + 1)])


def _lengths(tot, f, table) -> np.ndarray:
    return proxy.proxy_code_lengths(torch.from_numpy(tot), torch.from_numpy(f),
                                    torch.from_numpy(table),
                                    torch.from_numpy(proxy.row_offsets())).numpy()


def _exact_lengths(tot, f) -> np.ndarray:
    """The port's lengths with every switch offset at 1: the exact integer
    count."""
    return _lengths(tot, f, np.ones(proxy.table_size(), np.int8))


def _port_bits(freq, table=None):
    """The port's proxy bits with float32 sums (the form of chunks above
    1 MiB); where a row's bits stay below 2**24 the exact sums equal them."""
    t = torch.from_numpy(np.asarray(freq, np.int64))
    table = torch.from_numpy(proxy.load_switch_table() if table is None else table)
    offsets = torch.from_numpy(proxy.row_offsets())
    got = [x.numpy() for x in proxy.proxy_bits(t, table, offsets, float32_sums=True)]
    exact = [x.numpy() for x in proxy.proxy_bits(t, table, offsets)]
    small = got[0] < proxy.F32_EXACT_BITS
    for g, e in zip(got, exact):
        np.testing.assert_array_equal(g[small], e[small])
    return got


def test_committed_table_equals_jax_generated():
    """The exact-ratio table (the pairs whose switch offset is 0 or less) up
    to a total of 4,194,369, regenerated slice by slice in both jit forms,
    equals the committed one; its 262,191 entries at totals up to 262,209
    are those of its first form, bit for bit (the digest of that form's
    packed bits)."""
    table = roundup_table()
    assert proxy.TOT_MAX == (1 << 25) + 129
    assert table.size == proxy.table_size()
    np.testing.assert_array_equal(generate_table(), table[FLAT])
    np.testing.assert_array_equal(generate_table(ND), table[FLAT])
    narrow = narrow_entries(table)
    assert narrow.size == 262_191
    assert hashlib.sha256(np.packbits(narrow).tobytes()).hexdigest() == NARROW_SHA256
    ks, fs = _table_pairs(NARROW_TOT_MAX)
    np.testing.assert_array_equal(narrow, table[proxy.row_offsets()[ks] + fs - 1])


def test_committed_neighbour_tables_equal_jax_generated():
    """Both neighbour tables (switch offsets -1 and less, 2 and more),
    up to a total of 4,194,369, regenerated slice by slice in both jit
    forms, equal the committed ones; none of their bits is set below a total
    of 647,681 (so chunks of up to 256 KiB never needed them)."""
    tables = neighbour_tables()[:, FLAT]
    np.testing.assert_array_equal(generate_neighbour_tables(), tables)
    np.testing.assert_array_equal(generate_neighbour_tables(ND), tables)
    ks, fs = _table_pairs()
    assert not tables[0][(fs << ks) - 1 < 647_681].any()
    assert not tables[1][(fs << ks) + 1 < 647_681].any()
    assert tables[0].any() and tables[1].any()


def test_committed_switch_table_equals_jax_generated():
    """The committed switch offsets up to a total of 4,194,369 equal those
    measured from the JAX form at every total within 10 of f << k, in the
    ``[R, 30]`` and the ``[R, 286]`` jit forms, where it is a step at each
    pair; the file is the packed form of the whole table."""
    c = proxy.load_switch_table()
    assert c.dtype == np.int8 and c.size == proxy.table_size()
    want = generate_switch_table()
    np.testing.assert_array_equal(c[FLAT], want)
    np.testing.assert_array_equal(c[FLAT], generate_switch_table(NL))
    with open(proxy.TABLE_PATH, "rb") as f:
        assert lzma.decompress(f.read()) == c.tobytes()
    assert lzma.decompress(proxy.pack_switch_table(c)) == c.tobytes()


def test_switch_offsets_move_with_the_total():
    """The offsets the module docstring states: 0..1 below a total of
    647,681, -1..2 up to 1,048,641, -5..8 up to 4,194,369, and how many
    pairs above 1,048,641 step off the exact count up to there."""
    c = proxy.load_switch_table().astype(np.int64)[FLAT]
    ks, fs = _table_pairs()
    tot = fs << ks
    assert set(np.unique(c[tot + 1 < 647_681])) == {0, 1}
    assert set(np.unique(c[tot <= 1_048_641])) == {-1, 0, 1, 2}
    assert (int(c.min()), int(c.max())) == (-5, 8)
    wide = c[tot > 1_048_641]
    assert int((wide != 1).sum()) == WIDE_OFF_EXACT
    assert int(((wide <= -1) | (wide >= 3)).sum()) == WIDE_OFF_BY_TWO


def test_neighbours_of_powers_of_two_need_no_table():
    """At tot = f * 2^k +- 1 up to a total of 262,209 (chunks of up to
    256 KiB) the JAX form equals the exact integer count, in both jit
    forms."""
    ks, fs = _table_pairs(NARROW_TOT_MAX)
    flat = np.searchsorted(FLAT, table_index(ks, fs))  # their place in KS, FS
    for delta in (-1, 1):
        tot = (fs << ks) + delta
        keep = tot - fs >= 0
        f, tot = fs[keep], tot[keep]
        exact = _exact_lengths(tot, f)
        for width in (NL, ND):
            np.testing.assert_array_equal(exact, _delta_lengths(delta, width)[flat[keep]])


@pytest.mark.parametrize("delta", [-3, -2, -1, 1, 2, 3] + [-10, -9, -8, -7, -6, -5, -4,
                                                             4, 5, 6, 7, 8, 9, 10])
def test_near_powers_of_two_equal_jax(delta):
    """At tot = f * 2^k + delta over the whole table the port equals the JAX
    form in both jit forms; at 8 and more from f * 2^k the exact count alone
    does."""
    ks, fs = _table_pairs()
    tot = (fs << ks) + delta
    keep = tot - fs >= 0
    f, tot = fs[keep], tot[keep]
    got = _lengths(tot, f, proxy.load_switch_table())
    exact = _exact_lengths(tot, f) if abs(delta) >= 8 else None
    for width in (NL, ND):
        want = _delta_lengths(delta, width)[keep]
        np.testing.assert_array_equal(got, want)
        if exact is not None:
            np.testing.assert_array_equal(exact, want)


def _hitting_rows(rng, R, lo_tot=0):
    """Histograms whose column c holds f at a total of f << k + d, for d from
    -5 to 7 and table entries at totals above ``lo_tot``, with random mass
    spread over other columns.  Three quarters of the rows sit where the JAX
    form leaves the exact count (d at or past the switch offset below f << k,
    short of it above), the rest where it does not."""
    ks, fs = _table_pairs()
    c = proxy.load_switch_table()[FLAT]
    cands = {}
    rows = np.zeros((R, NL), np.int64)
    for r in range(R):
        delta = int(rng.integers(-5, 8))
        want_off = r < R - R // 4
        if (delta, want_off) not in cands:
            off = (c <= delta) if delta <= 0 else (c > delta)
            cands[delta, want_off] = np.flatnonzero((off == want_off)
                                                    & ((fs << ks) + delta > lo_tot))
        p = int(rng.choice(cands[delta, want_off]))
        f, tot = int(fs[p]), int(fs[p] << ks[p]) + delta
        col = int(rng.integers(0, NL))
        rows[r, col] = f
        rest = tot - f
        others = rng.choice([x for x in range(NL) if x != col], int(rng.integers(1, 40)),
                            replace=False)
        cuts = np.sort(rng.integers(0, rest + 1, len(others) - 1))
        rows[r, others] = np.diff(np.concatenate([[0], cuts, [rest]]))
        assert rows[r].sum() == tot
    return rows


@pytest.mark.parametrize("R,lo_tot", [(1, 0), (10, 0), (36, 0), (400, 0),
                                      (10, NARROW_TOT_MAX), (400, NARROW_TOT_MAX),
                                      (10, 1_048_641), (400, 1_048_641)])
def test_proxy_bits_equal_jax_on_table_hits(R, lo_tot):
    """Totals anywhere in the table, only above 262,209 (chunks of more than
    256 KiB) and only above 1,048,641 (chunks of more than 1 MiB), where the
    JAX form leaves the exact count and where it does not."""
    rows = _hitting_rows(np.random.default_rng(R + lo_tot), R, lo_tot)
    assert (rows.sum(axis=1) > lo_tot).all()
    want = jax.jit(jax_proxy_bits)(jnp.asarray(rows, jnp.int32))
    got = _port_bits(rows)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_proxy_bits_equal_jax_on_random_histograms():
    rng = np.random.default_rng(7)
    rows = rng.integers(0, 3000, (300, NL))
    rows[rng.random((300, NL)) < 0.6] = 0
    rows[::7] = rng.integers(0, 3, (len(rows[::7]), NL))
    want = jax.jit(jax_proxy_bits)(jnp.asarray(rows, jnp.int32))
    got = _port_bits(rows)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("width", [NL, ND])
def test_proxy_bits_round_their_float32_sums_as_jax(width):
    """Rows of a block of up to 4,194,305 symbols spread over every column
    (up to 15 bits each): the JAX form's float32 products and sums of the
    token bits lose their low bits past 2**24, in its order of addition,
    and the port's float32 sums give its numbers; exact sums would not."""
    rng = np.random.default_rng(width)
    R = 256
    weights = rng.random((R, width))
    weights[rng.random((R, width)) < 0.2] = 0
    weights[:, 0] += 1e-3
    tot = rng.integers(3_500_000, (1 << 22) + 2, R)
    rows = np.floor(weights / weights.sum(axis=1, keepdims=True) * tot[:, None]).astype(np.int64)
    want = [np.asarray(w) for w in jax.jit(jax_proxy_bits)(jnp.asarray(rows, jnp.int32))]
    got = _port_bits(rows)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    exact = proxy.proxy_bits(torch.from_numpy(rows), torch.from_numpy(proxy.load_switch_table()),
                             torch.from_numpy(proxy.row_offsets()))[0].numpy()
    assert (want[0] >= proxy.F32_EXACT_BITS).sum() > R // 4
    assert (exact != want[0]).sum() > R // 8


def test_exact_count_alone_is_wrong_where_jax_rounds_up():
    """f = 3 of tot = 6: the JAX form gives 2-bit codes, the exact count
    1, so without the switch table the bits differ."""
    row = np.zeros((1, NL), np.int64)
    row[0, 0] = row[0, 1] = 3
    want = np.asarray(jax.jit(jax_proxy_bits)(jnp.asarray(row, jnp.int32))[0])
    assert int(want[0]) == 12
    exact = np.ones(proxy.table_size(), np.int8)
    assert int(_port_bits(row, exact)[0][0]) == 6
    assert int(_port_bits(row)[0][0]) == 12


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    c = generate_whole_table()
    os.makedirs(proxy.DATA_DIR, exist_ok=True)
    with open(proxy.TABLE_PATH, "wb") as f:
        f.write(proxy.pack_switch_table(c))
    ks, fs = table_pairs()
    wide = c[(fs << ks) > 1_048_641]
    print(f"wrote {proxy.TABLE_PATH}: switch offsets {int(c.min())}..{int(c.max())} over "
          f"{c.size} pairs; {int((c <= 0).sum())} round up at f << k; above a total of "
          f"1,048,641 {int((wide != 1).sum())} step off the exact count, "
          f"{int(((wide <= -1) | (wide >= 3)).sum())} by two or more")
