"""The port's package-merge, header RLE and canonical codes against the JAX
package (vmapped XLA forms)."""

import functools

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
# The suite runs several workers on one machine: one intra-op thread per
# worker keeps the port's many small ops from oversubscribing the cores.
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deflate_rs_tpu.ops.canonical import canonical_codes as j_canon  # noqa: E402
from deflate_rs_tpu.ops.code_lengths import CL_CAP  # noqa: E402
from deflate_rs_tpu.ops.code_lengths import encode_code_lengths as j_rle  # noqa: E402
from deflate_rs_tpu.ops.package_merge import package_merge_lengths  # noqa: E402
from deflate_rs_tpu_torch.ops.canonical import canonical_codes  # noqa: E402
from deflate_rs_tpu_torch.ops.code_lengths import encode_code_lengths  # noqa: E402
from deflate_rs_tpu_torch.ops.package_merge import package_merge_rows  # noqa: E402


def _freq_rows(rng, R, A):
    f = np.zeros((R, A), np.int32)
    for r in range(R):
        kind = r % 5
        if kind == 0:
            f[r] = rng.integers(0, 1000, A)
        elif kind == 1:  # skewed: Fibonacci-like tail forces the length limit
            used = rng.choice(A, min(A, 25), replace=False)
            fib = [1, 1]
            while len(fib) < len(used):
                fib.append(fib[-1] + fib[-2])
            f[r, used] = fib[: len(used)]
        elif kind == 2:  # a single symbol
            f[r, rng.integers(0, A)] = int(rng.integers(1, 50))
        elif kind == 3:  # sparse
            used = rng.choice(A, max(2, A // 10), replace=False)
            f[r, used] = rng.integers(1, 60000, len(used))
        # kind 4: empty row
    return f


@pytest.mark.parametrize("max_len,A", [(15, 286), (7, 19), (15, 30)])
def test_package_merge_rows_equal(max_len, A):
    rng = np.random.default_rng(max_len * 100 + A)
    f = _freq_rows(rng, 40, A)
    want = jax.vmap(functools.partial(package_merge_lengths, max_len=max_len))(jnp.asarray(f))
    got = package_merge_rows(torch.from_numpy(f), max_len)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_encode_code_lengths_equal(seed):
    rng = np.random.default_rng(seed)
    R = 12
    cl = rng.integers(0, 16, (R, CL_CAP)).astype(np.int32)
    for r in range(R):  # long zero and repeat runs
        a = int(rng.integers(0, 200))
        cl[r, a : a + int(rng.integers(0, 150))] = 0
        b = int(rng.integers(0, 250))
        cl[r, b : b + int(rng.integers(0, 40))] = int(rng.integers(1, 16))
    hn = rng.integers(258, 317, R).astype(np.int32)
    want = jax.vmap(j_rle)(jnp.asarray(cl), jnp.asarray(hn))
    got = encode_code_lengths(torch.from_numpy(cl), torch.from_numpy(hn))
    for k in ("sym", "cnt", "n", "freq", "extra_bits", "extra_vals"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("max_len,A", [(15, 288), (7, 19)])
def test_canonical_codes_equal(max_len, A):
    rng = np.random.default_rng(A)
    f = _freq_rows(rng, 20, A)
    lengths = np.array(jax.vmap(functools.partial(package_merge_lengths, max_len=max_len))(
        jnp.asarray(f)))
    want = jax.vmap(functools.partial(j_canon, max_len=max_len))(jnp.asarray(lengths))
    got = canonical_codes(torch.from_numpy(lengths), max_len)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


def test_exact_scoring_chunk_encoder_equals_encode_chunk():
    """The exact-scoring branch (high, rle and huffman_only use it): every
    output field of ``ChunkEncoder`` equals JAX ``encode_chunk`` on the
    crafted 4 KiB-tier chunks, at nq = 8 (36 ranges, 72 package-merge rows
    per chunk)."""
    from test_torch_chunk_encode import EMIT, _buffers, _crafted

    from deflate_rs_tpu import CompressionOptions as JOpts
    from deflate_rs_tpu.ops.chunk_encode import get_chunk_encoder
    from deflate_rs_tpu_torch import CompressionOptions as TOpts
    from deflate_rs_tpu_torch.ops.chunk_encode import ChunkEncoder

    cases = _crafted()
    bufs, hist, ns, last = _buffers(cases)
    t_opts, j_opts = TOpts(split_scoring="exact"), JOpts(split_scoring="exact")
    assert t_opts.exact_split_scoring and t_opts.num_quarters == 8
    with torch.no_grad():
        got = ChunkEncoder(t_opts, EMIT)(torch.from_numpy(bufs), torch.from_numpy(hist),
                                         torch.from_numpy(ns), torch.from_numpy(last))
    jenc = get_chunk_encoder(j_opts, EMIT, with_checksums=False)
    btypes = set()
    for i in range(len(cases)):
        want = jenc(bufs[i], np.int32(hist[i]), np.int32(ns[i]), np.bool_(last[i]))
        for k in ("total_bits", "data_bits", "btype", "ntokens"):
            assert int(got[k][i]) == int(want[k]), (i, k)
        np.testing.assert_array_equal(got["words"][i].numpy(),
                                      np.asarray(want["words"]).astype(np.int64),
                                      err_msg=f"chunk {i}")
        btypes.add(int(want["btype"]))
    assert btypes == {0, 1, 2, 3}, btypes


# ---------------------------------------------------------------------------
# Adversarial operands (deflate_rs_tpu_torch/utils/kernel_cases.py): the JAX
# package against the port's plain twin, and a CPU model of the CUDA kernel's
# algorithm (rows sized by their live leaves, merged thread by thread) against
# the twin.
# ---------------------------------------------------------------------------

from deflate_rs_tpu.ops.pm_kernel import package_merge_rows_tpu  # noqa: E402
from deflate_rs_tpu_torch.ops.pm_kernel import BIG, lengths_by_rank_plain  # noqa: E402
from deflate_rs_tpu_torch.utils.kernel_cases import (  # noqa: E402
    FREQ_2P20_CASE, WIDE_LEAF_CASES, package_merge_cases, sorted_leaves)

PM_CASES = package_merge_cases()
PM_IDS = [c[0] for c in PM_CASES]
# (row, symbol) of the leaves of 2**20 and more that the XLA form gives
# length 0 and the port keeps; its rows are the port's everywhere else.  At
# 2**22 its int32 key wraps below every other and both agree; at 2**23,
# 2**24 and 2**25 it wraps to the symbol itself, which a row of one such
# leaf and EOB survives, but not the rows halving from 2**23 and from 2**24:
# there the XLA form also gives other lengths than the port
# (``XLA_MISRANKS``), and its code leaves part of Kraft's sum unused.
XLA_DROPS = {FREQ_2P20_CASE: [(1, 97)],
             WIDE_LEAF_CASES[0]: [(0, 0), (1, 97), (2, 97), (2, 32)],
             WIDE_LEAF_CASES[1]: [],
             WIDE_LEAF_CASES[2]: [(2, 101), (2, 116)],
             WIDE_LEAF_CASES[3]: [],
             WIDE_LEAF_CASES[4]: [(2, 116)]}
# {(row, symbol): length} the XLA form gives where its wrapped keys misrank
# the leaves (a nonzero length other than the port's).
XLA_MISRANKS = {WIDE_LEAF_CASES[2]: {
    (2, 0): 3, (2, 10): 4, (2, 32): 15, (2, 97): 15, (2, 200): 5, (2, 201): 6, (2, 202): 7,
    (2, 203): 8, (2, 204): 9, (2, 205): 10, (2, 206): 12, (2, 207): 12, (2, 208): 13},
    WIDE_LEAF_CASES[4]: {
    (2, 0): 2, (2, 10): 3, (2, 32): 15, (2, 97): 15, (2, 101): 15, (2, 200): 4, (2, 201): 5,
    (2, 202): 6, (2, 203): 7, (2, 204): 8, (2, 205): 9, (2, 206): 10, (2, 207): 12,
    (2, 208): 12, (2, 209): 14, (2, 210): 14}}


@pytest.mark.parametrize("name,freqs,max_len", PM_CASES, ids=PM_IDS)
def test_adversarial_package_merge_equals_jax(name, freqs, max_len):
    """Tolerance 0 (integers).  Up to 40 rows go through the Pallas kernel in
    interpret mode, larger batches through the vmapped XLA form.

    The rows with a leaf of 2**20 or more go through the XLA form: the
    Pallas wrapper drops such a leaf on any symbol (its sort key reaches
    ``BIG``).  The XLA form keeps a leaf of 2**20 on symbol 0 but not on 97,
    where the unused symbols below it sort ahead of it, drops every leaf of
    2**21 (and of 2**20 beside it), keeps a leaf of 2**22, 2**23, 2**24 and
    2**25 beside EOB alone, and misranks the rows halving from 2**23 and
    from 2**24; the port
    keeps them all, optimal (the recorded difference, ``XLA_DROPS`` and
    ``XLA_MISRANKS``, pinned here so that a reference that repairs it
    shows)."""
    if 0 < freqs.shape[0] <= 40 and name not in XLA_DROPS:
        want = package_merge_rows_tpu(jnp.asarray(freqs), max_len, interpret=True)
    else:
        want = jax.vmap(functools.partial(package_merge_lengths, max_len=max_len))(
            jnp.asarray(freqs))
    want = np.array(want)
    got = package_merge_rows(torch.from_numpy(freqs), max_len)
    for r, sym in XLA_DROPS.get(name, ()):
        assert want[r, sym] == 0 and got[r, sym] > 0
        want[r, sym] = got[r, sym]
    for (r, sym), n in XLA_MISRANKS.get(name, {}).items():
        assert want[r, sym] == n and 0 < got[r, sym] != n
        want[r, sym] = got[r, sym]
    assert got.shape == freqs.shape
    np.testing.assert_array_equal(got.numpy(), want)



def sized_by_m_model(leaf, max_len):
    """The CUDA kernel's algorithm for one row of leaves by rank."""
    A = len(leaf)
    lv = [int(v) for v in leaf]
    m = sum(v < BIG for v in lv)
    inf = (1 << 31) - 1
    threads = 32 if 2 * m <= 96 else 128  # threads that work on the row
    c = ((2 * m + threads - 1) // threads) | 1
    prev, n_prev = lv, m  # level 0 is the leaves alone
    nlist, nbig, bits = [m], [0], [None]
    for lvl in range(1, max_len):
        npk = n_prev >> 1
        N = m + npk

        def package(j):  # formed where it is read, clamped at BIG
            return min(prev[2 * j] + prev[2 * j + 1], BIG)

        cur, words, big = [None] * N, [0] * threads, 0
        for t in range(threads):
            q0 = t * c
            lo, hi = max(0, q0 - npk), min(q0, m)
            while lo < hi:  # leaves among the first q0 merged entries
                mid = (lo + hi) >> 1
                if lv[mid] <= package(q0 - mid - 1):
                    lo = mid + 1
                else:
                    hi = mid
            i, j = lo, q0 - lo
            for q in range(q0, min(q0 + c, N)):
                a = lv[i] if i < m else inf
                b = package(j) if j < npk else inf
                if a <= b:
                    cur[q] = a
                    words[t] |= 1 << (q - q0)
                    i += 1
                else:
                    cur[q] = b
                    j += 1
                big += cur[q] >= BIG
            assert words[t] < 1 << 16
        assert None not in cur and cur == sorted(cur)
        bits.append(words)
        nlist.append(N)
        nbig.append(big)
        prev, n_prev = cur, N
    n_sel = max(2 * m - 2, 0)
    lengths = np.zeros(A, np.int32)
    for lvl in range(max_len - 1, -1, -1):
        take = min(max(n_sel, 0), 2 * A)
        N = nlist[lvl] - nbig[lvl]  # entries below BIG
        tr = min(take, N)
        if lvl == 0:
            cnt = tr
        else:
            cnt = 0
            for t in range(threads):
                k = min(max(tr - t * c, 0), 32)
                cnt += bin(bits[lvl][t] & ((1 << k) - 1)).count("1")
        cnt += min(max(take - N, 0), A - m)
        lengths += np.arange(A) < cnt
        n_sel = 2 * (take - cnt)
    return lengths


@pytest.mark.parametrize("name,freqs,max_len", PM_CASES, ids=PM_IDS)
def test_sized_by_m_model_equals_plain(name, freqs, max_len):
    """The kernel's algorithm, modelled on the CPU, equals the plain twin
    (tolerance 0), on at most 48 rows of each case, spread over it."""
    leaf = sorted_leaves(freqs)
    R = leaf.shape[0]
    want = lengths_by_rank_plain(torch.from_numpy(leaf), max_len).numpy()
    assert want.shape == leaf.shape
    for r in range(0, R, max(1, R // 48)):
        np.testing.assert_array_equal(sized_by_m_model(leaf[r], max_len), want[r],
                                      err_msg=f"{name} row {r}")


@pytest.mark.parametrize("max_len,A", [(7, 286), (3, 30), (2, 19)])
def test_sized_by_m_model_past_the_limit(max_len, A):
    """More live leaves than 2**max_len: the selection runs past the real
    entries into the padding, which the model counts as the twin does."""
    rng = np.random.default_rng(A)
    f = rng.integers(1, 5000, (6, A)).astype(np.int32)
    f[1, ::2] = 0
    f[2, 5:] = 0
    # Leaves so heavy that every package is clamped at BIG and the selection
    # runs into them and the padding.
    f[3] = 0
    f[3, : 2 * A // 3] = rng.integers(1 << 28, 1 << 29, 2 * A // 3)
    leaf = sorted_leaves(f)
    want = lengths_by_rank_plain(torch.from_numpy(leaf), max_len).numpy()
    for r in range(len(leaf)):
        np.testing.assert_array_equal(sized_by_m_model(leaf[r], max_len), want[r])
