"""The port's block-split entropy proxy against the JAX package's float32 form.

The JAX encoder computes ``clip(ceil(log2(tot) - log2(f)), 1, 15)`` in
float32 (``deflate_rs_tpu/ops/chunk_encode.py:380-393``); at some exact
power-of-two ratios XLA's ``log2`` rounds up.  The port reproduces it with
exact integers plus a committed round-up table
(``deflate_rs_tpu_torch/data/proxy_roundup.npy``).  This file regenerates
that table from the JAX expression in the encoder's ``[R, 286]`` jit form
and compares it with the committed one.  Run it as a script to rewrite the
table:

    JAX_PLATFORMS=cpu python tests/test_torch_proxy.py
"""

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


def _table_pairs():
    ks, fs = [], []
    for k, count in proxy.table_rows():
        ks.append(np.full(count, k, np.int64))
        fs.append(np.arange(1, count + 1, dtype=np.int64))
    return np.concatenate(ks), np.concatenate(fs)


def _pair_rows(f, tot):
    """[P, 286] int32 histograms with f in column 0 and total tot."""
    rows = np.zeros((len(f), NL), np.int32)
    rows[:, 0] = f
    rows[:, 1] = tot - f
    return rows


def generate_table() -> np.ndarray:
    """Flat bool table: the JAX form gives k + 1 at tot == f << k."""
    ks, fs = _table_pairs()
    lens = np.asarray(jax.jit(_jax_lengths)(_pair_rows(fs, fs << ks)))[:, 0].astype(np.int64)
    assert set(np.unique(lens - ks)) <= {0, 1}
    return lens == ks + 1


def _port_bits(freq, roundup=None):
    t = torch.from_numpy(np.asarray(freq, np.int64))
    table = torch.from_numpy(proxy.load_roundup_table() if roundup is None else roundup)
    return [x.numpy() for x in proxy.proxy_bits(t, table, torch.from_numpy(proxy.row_offsets()))]


def test_committed_table_equals_jax_generated():
    np.testing.assert_array_equal(generate_table(), proxy.load_roundup_table())


def test_neighbours_of_powers_of_two_need_no_table():
    """At tot = f * 2^k +- 1 the JAX form equals the exact integer count."""
    ks, fs = _table_pairs()
    for delta in (-1, 1):
        tot = (fs << ks) + delta
        keep = tot - fs >= 0
        rows = _pair_rows(fs[keep], tot[keep])
        want = np.asarray(jax.jit(_jax_lengths)(rows))[:, 0].astype(np.int64)
        t = torch.from_numpy(rows.astype(np.int64))
        exact = proxy.proxy_code_lengths(
            t.sum(-1, keepdim=True), t, torch.zeros(1, dtype=torch.bool),
            torch.zeros(MAXLEN + 1, dtype=torch.int64))[:, 0].numpy()
        np.testing.assert_array_equal(exact, want)


def _hitting_rows(rng, R):
    """Histograms whose column c holds f at a total of exactly f << k, for
    table entries, with random mass spread over other columns."""
    ks, fs = _table_pairs()
    table = proxy.load_roundup_table()
    on = np.flatnonzero(table)
    off = np.flatnonzero(~table)
    picks = np.concatenate([rng.choice(on, R - R // 4), rng.choice(off, R // 4)])
    rows = np.zeros((R, NL), np.int64)
    for r, p in enumerate(picks):
        f, tot = int(fs[p]), int(fs[p] << ks[p])
        c = int(rng.integers(0, NL))
        rows[r, c] = f
        rest = tot - f
        others = rng.choice([x for x in range(NL) if x != c], int(rng.integers(1, 40)),
                            replace=False)
        cuts = np.sort(rng.integers(0, rest + 1, len(others) - 1))
        rows[r, others] = np.diff(np.concatenate([[0], cuts, [rest]]))
        assert rows[r].sum() == tot
    return rows


@pytest.mark.parametrize("R", [1, 10, 36, 400])
def test_proxy_bits_equal_jax_on_table_hits(R):
    rows = _hitting_rows(np.random.default_rng(R), R)
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
    no_table = np.zeros_like(proxy.load_roundup_table())
    assert int(_port_bits(row, no_table)[0][0]) == 6
    assert int(_port_bits(row)[0][0]) == 12


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    table = generate_table()
    os.makedirs(os.path.dirname(proxy.TABLE_PATH), exist_ok=True)
    np.save(proxy.TABLE_PATH, np.packbits(table))
    print(f"wrote {proxy.TABLE_PATH}: {int(table.sum())} of {table.size} pairs round up")
