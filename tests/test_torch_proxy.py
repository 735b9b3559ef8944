"""The port's block-split entropy proxy against the JAX package's float32 form.

The JAX encoder computes ``clip(ceil(log2(tot) - log2(f)), 1, 15)`` in
float32 (``deflate_rs_tpu/ops/chunk_encode.py:380-393``); at some exact
power-of-two ratios XLA's ``log2`` rounds up.  The port reproduces it with
exact integers plus a committed round-up table
(``deflate_rs_tpu_torch/data/proxy_roundup.npy``).  This file regenerates
that table from the JAX expression in the encoder's ``[R, 286]`` jit form,
in slices of ``SLICE_ROWS`` rows (the whole table as one array would take
1.2 GB), and compares it with the committed one; the entries of the table's
first form, which covered totals up to 262,209, are held to that form's
digest.  Run it as a script to rewrite the table:

    JAX_PLATFORMS=cpu python tests/test_torch_proxy.py
"""

import hashlib
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

NL = 286
MAXLEN = 15
SLICE_ROWS = 65536  # rows of one [R, 286] evaluation; the last slice is padded
# The table's first form covered totals up to 262,209 (chunks up to 256 KiB):
# the sha256 of its packed bits, generated in one [262192, 286] array.
NARROW_TOT_MAX = 262209
NARROW_SHA256 = "d522d233a7df52d6e854159225d2c71ad6a8e748a898b67dce43233fbb2ad087"


def _jax_lengths(freq_r):
    """The expression of deflate_rs_tpu/ops/chunk_encode.py:382-386."""
    tot = jnp.sum(freq_r, axis=1, keepdims=True).astype(jnp.float32)
    f = freq_r.astype(jnp.float32)
    return jnp.clip(
        jnp.ceil(jnp.log2(jnp.maximum(tot, 1.0)) - jnp.log2(jnp.maximum(f, 1.0))),
        1.0, float(MAXLEN),
    )


def _jax_proxy_bits(freq_r):
    """``_proxy_bits`` of deflate_rs_tpu/ops/chunk_encode.py:380-393."""
    lens = _jax_lengths(freq_r)
    bits = jnp.sum(jnp.where(freq_r > 0, freq_r.astype(jnp.float32) * lens, 0.0), axis=1)
    used = freq_r > 0
    u = jnp.sum(used, axis=1)
    prev = jnp.concatenate([jnp.zeros((freq_r.shape[0], 1), bool), used[:, :-1]], axis=1)
    z = jnp.sum(prev & ~used, axis=1)
    return bits.astype(jnp.int32), u.astype(jnp.int32), z.astype(jnp.int32)


def _table_pairs(tot_max: int = proxy.TOT_MAX):
    """(k, f) of every table entry, in the table's order, for a table that
    covers totals up to ``tot_max``."""
    ks, fs = [], []
    for k in range(1, proxy.K_MAX + 1):
        count = tot_max >> k
        ks.append(np.full(count, k, np.int64))
        fs.append(np.arange(1, count + 1, dtype=np.int64))
    return np.concatenate(ks), np.concatenate(fs)


def _pair_rows(f, tot):
    """[P, 286] int32 histograms with f in column 0 and total tot."""
    rows = np.zeros((len(f), NL), np.int32)
    rows[:, 0] = f
    rows[:, 1] = tot - f
    return rows


_jit_lengths = jax.jit(_jax_lengths)


def _column0_lengths(f, tot) -> np.ndarray:
    """The JAX lengths of column 0 of ``_pair_rows(f, tot)``, evaluated on
    [SLICE_ROWS, 286] arrays (one compiled form; the last slice padded with
    rows of f = 1 at total 2)."""
    out = np.empty(len(f), np.int64)
    for lo in range(0, len(f), SLICE_ROWS):
        hi = min(lo + SLICE_ROWS, len(f))
        pad = SLICE_ROWS - (hi - lo)
        rows = _pair_rows(np.concatenate([f[lo:hi], np.ones(pad, np.int64)]),
                          np.concatenate([tot[lo:hi], np.full(pad, 2, np.int64)]))
        out[lo:hi] = np.asarray(_jit_lengths(rows))[: hi - lo, 0]
    return out


def generate_table() -> np.ndarray:
    """Flat bool table: the JAX form gives k + 1 at tot == f << k."""
    ks, fs = _table_pairs()
    lens = _column0_lengths(fs, fs << ks)
    assert set(np.unique(lens - ks)) <= {0, 1}
    return lens == ks + 1


def generate_neighbour_tables() -> np.ndarray:
    """bool[2, P]: the JAX form gives k + 1 at tot == (f << k) - 1 (the exact
    count k), and k at tot == (f << k) + 1 (the exact count k + 1)."""
    ks, fs = _table_pairs()
    below = _column0_lengths(fs, (fs << ks) - 1)
    above = _column0_lengths(fs, (fs << ks) + 1)
    assert set(np.unique(below - ks)) <= {0, 1} and set(np.unique(above - ks)) <= {0, 1}
    return np.stack([below == ks + 1, above == ks])


def narrow_entries(table: np.ndarray) -> np.ndarray:
    """The entries of ``table`` at every (k, f) with ``f << k <= 262,209``,
    in the order of the table's first form (rows of k, f from 1)."""
    off = proxy.row_offsets()
    return np.concatenate([table[off[k] : off[k] + (NARROW_TOT_MAX >> k)]
                           for k in range(1, proxy.K_MAX + 1)])


def _exact_lengths(tot, f) -> np.ndarray:
    """The port's lengths with every table empty: the exact integer count."""
    return proxy.proxy_code_lengths(
        torch.from_numpy(tot), torch.from_numpy(f), torch.zeros((3, 1), dtype=torch.bool),
        torch.zeros(MAXLEN + 1, dtype=torch.int64)).numpy()


def _port_bits(freq, tables=None):
    t = torch.from_numpy(np.asarray(freq, np.int64))
    tables = torch.from_numpy(proxy.load_tables() if tables is None else tables)
    return [x.numpy() for x in proxy.proxy_bits(t, tables, torch.from_numpy(proxy.row_offsets()))]


def test_committed_table_equals_jax_generated():
    """The whole exact-ratio table, regenerated slice by slice, equals the
    committed one; its 262,191 entries at totals up to 262,209 are those of
    its first form, bit for bit (the digest of that form's packed bits)."""
    table = proxy.load_roundup_table()
    assert proxy.TOT_MAX == (1 << 20) + 65
    assert table.size == proxy.table_size()
    np.testing.assert_array_equal(generate_table(), table)
    narrow = narrow_entries(table)
    assert narrow.size == 262_191
    assert hashlib.sha256(np.packbits(narrow).tobytes()).hexdigest() == NARROW_SHA256
    ks, fs = _table_pairs(NARROW_TOT_MAX)
    np.testing.assert_array_equal(narrow, table[proxy.row_offsets()[ks] + fs - 1])


def test_committed_neighbour_tables_equal_jax_generated():
    """Both neighbour tables, regenerated slice by slice, equal the committed
    ones; none of their bits is set below a total of 647,681 (so chunks of up
    to 256 KiB never needed them)."""
    tables = proxy.load_neighbour_tables()
    np.testing.assert_array_equal(generate_neighbour_tables(), tables)
    ks, fs = _table_pairs()
    assert not tables[0][(fs << ks) - 1 < 647_681].any()
    assert not tables[1][(fs << ks) + 1 < 647_681].any()
    assert tables[0].any() and tables[1].any()


def test_neighbours_of_powers_of_two_need_no_table():
    """At tot = f * 2^k +- 1 up to a total of 262,209 (chunks of up to
    256 KiB) the JAX form equals the exact integer count."""
    ks, fs = _table_pairs(NARROW_TOT_MAX)
    for delta in (-1, 1):
        tot = (fs << ks) + delta
        keep = tot - fs >= 0
        f, tot = fs[keep], tot[keep]
        np.testing.assert_array_equal(_exact_lengths(tot, f), _column0_lengths(f, tot))


@pytest.mark.parametrize("delta", [-3, -2, -1, 1, 2, 3])
def test_near_powers_of_two_equal_jax(delta):
    """At tot = f * 2^k + delta over the whole table the port equals the JAX
    form; at two and three from f * 2^k the exact count alone does."""
    ks, fs = _table_pairs()
    tot = (fs << ks) + delta
    keep = tot - fs >= 0
    f, tot = fs[keep], tot[keep]
    want = _column0_lengths(f, tot)
    got = proxy.proxy_code_lengths(torch.from_numpy(tot), torch.from_numpy(f),
                                   torch.from_numpy(proxy.load_tables()),
                                   torch.from_numpy(proxy.row_offsets())).numpy()
    np.testing.assert_array_equal(got, want)
    if abs(delta) > 1:
        np.testing.assert_array_equal(_exact_lengths(tot, f), want)


def _hitting_rows(rng, R, lo_tot=0):
    """Histograms whose column c holds f at a total of exactly f << k, or one
    off it, for table entries at totals above ``lo_tot``, with random mass
    spread over other columns.  Three quarters of the rows hit set bits."""
    ks, fs = _table_pairs()
    planes = [(0, proxy.load_roundup_table())]
    planes += list(zip((-1, 1), proxy.load_neighbour_tables()))
    rows = np.zeros((R, NL), np.int64)
    for r in range(R):
        delta, table = planes[int(rng.integers(0, 3))]
        want_set = r < R - R // 4
        cand = np.flatnonzero((table == want_set) & ((fs << ks) + delta > lo_tot))
        p = int(rng.choice(cand))
        f, tot = int(fs[p]), int(fs[p] << ks[p]) + delta
        c = int(rng.integers(0, NL))
        rows[r, c] = f
        rest = tot - f
        others = rng.choice([x for x in range(NL) if x != c], int(rng.integers(1, 40)),
                            replace=False)
        cuts = np.sort(rng.integers(0, rest + 1, len(others) - 1))
        rows[r, others] = np.diff(np.concatenate([[0], cuts, [rest]]))
        assert rows[r].sum() == tot
    return rows


@pytest.mark.parametrize("R,lo_tot", [(1, 0), (10, 0), (36, 0), (400, 0),
                                      (10, NARROW_TOT_MAX), (400, NARROW_TOT_MAX)])
def test_proxy_bits_equal_jax_on_table_hits(R, lo_tot):
    """Totals anywhere in the table, and only above 262,209 (chunks of more
    than 256 KiB), where JAX rounds up and where it does not."""
    rows = _hitting_rows(np.random.default_rng(R + lo_tot), R, lo_tot)
    assert (rows.sum(axis=1) > lo_tot).all()
    want = jax.jit(_jax_proxy_bits)(jnp.asarray(rows, jnp.int32))
    got = _port_bits(rows)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_proxy_bits_equal_jax_on_random_histograms():
    rng = np.random.default_rng(7)
    rows = rng.integers(0, 3000, (300, NL))
    rows[rng.random((300, NL)) < 0.6] = 0
    rows[::7] = rng.integers(0, 3, (len(rows[::7]), NL))
    want = jax.jit(_jax_proxy_bits)(jnp.asarray(rows, jnp.int32))
    got = _port_bits(rows)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_exact_count_alone_is_wrong_where_jax_rounds_up():
    """f = 3 of tot = 6: the JAX form gives 2-bit codes, the exact count
    1, so without the round-up table the bits differ."""
    row = np.zeros((1, NL), np.int64)
    row[0, 0] = row[0, 1] = 3
    want = np.asarray(jax.jit(_jax_proxy_bits)(jnp.asarray(row, jnp.int32))[0])
    assert int(want[0]) == 12
    no_table = np.zeros_like(proxy.load_tables())
    assert int(_port_bits(row, no_table)[0][0]) == 6
    assert int(_port_bits(row)[0][0]) == 12


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    table = generate_table()
    os.makedirs(proxy.DATA_DIR, exist_ok=True)
    np.save(proxy.TABLE_PATH, np.packbits(table))
    print(f"wrote {proxy.TABLE_PATH}: {int(table.sum())} of {table.size} pairs round up")
    neighbours = generate_neighbour_tables()
    np.save(proxy.NEIGHBOURS_PATH, np.stack([np.packbits(t) for t in neighbours]))
    print(f"wrote {proxy.NEIGHBOURS_PATH}: {int(neighbours[0].sum())} pairs round up at "
          f"(f << k) - 1, {int(neighbours[1].sum())} round down at (f << k) + 1")
