"""The adversarial operands of ``deflate_rs_tpu_torch/utils/kernel_cases.py``
for ``lr_measure`` and ``quarter_hist`` on the CPU.

The long-range cases go two ways.  As (buffer, harvest) through the JAX
package's ``longrange.local_dominant_lengths`` (a few small ones also through
``local_dominant_lengths_tpu``, the Pallas kernel in interpret mode) and the
port's ``local_dominant_lengths``.  As raw dominant rows through the port's
plain twin ``lr_measure_plain`` and a byte-by-byte numpy measurement written
here; a lane-for-lane numpy model of the CUDA kernel's algorithm is held
against the twin too.  The histogram cases go through the JAX package's
Pallas kernel in interpret mode, the port's twin and ``numpy.bincount``.
Every value is an integer: tolerance 0 everywhere.  The card-side checks (``chip_smoke.py``,
``tests/test_torch_cuda.py``) hold the CUDA kernels against the same twins
on the same operands.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
# The suite runs several workers on one machine: one intra-op thread per
# worker keeps the port's many small ops from oversubscribing the cores.
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deflate_rs_tpu.ops import longrange as jlr  # noqa: E402
from deflate_rs_tpu.ops.hist_kernel import quarter_histograms_batched  # noqa: E402
from deflate_rs_tpu_torch.ops import hist_kernel, lr_kernel  # noqa: E402
from deflate_rs_tpu_torch.ops import longrange as tlr  # noqa: E402
from deflate_rs_tpu_torch.utils import kernel_cases  # noqa: E402

HALO = 32768


def measure_bytewise(buf: np.ndarray, doms: np.ndarray, N: int):
    """One chunk's (run, dist, xor_next) [S, LW], byte by byte: the run from a
    word's first byte is the count of equal bytes up to the first unequal one
    (or the window's end); bytes outside the buffer are zero."""
    S, M = doms.shape
    L = N // S
    LW = kernel_cases.lr_window_words(N, S)
    padded = np.concatenate([np.zeros(HALO, np.uint8), buf, np.zeros(4 * LW + 8, np.uint8)])
    run = np.full((S, LW), -1, np.int64)
    dist = np.zeros((S, LW), np.int64)
    xn = np.zeros((S, LW), np.int64)
    at = np.arange(4 * LW)
    for s in range(S):
        a0 = HALO + s * L
        base = padded[a0 : a0 + 4 * LW]
        runs = np.full((M, LW), -1, np.int64)
        xors = np.zeros((M, LW), np.int64)
        for m in range(M):
            d = int(doms[s, m])
            if d <= 0:
                continue
            back = padded[a0 - d : a0 - d + 4 * LW]
            first_unequal = np.minimum.accumulate(np.where(base != back, at, 4 * LW)[::-1])[::-1]
            runs[m] = (first_unequal - at)[::4]
            xors[m] = (base ^ back).view("<u4")
        win = runs.argmax(axis=0)  # the first of the longest
        run[s] = runs.max(axis=0)
        dist[s] = np.where(run[s] >= 0, doms[s, win], 0)
        xn[s, :-1] = np.where(run[s, 1:] >= 0, xors[win[1:], np.arange(LW - 1)], 0)
    return run, dist, xn


@pytest.mark.parametrize("B,S,N,seed", kernel_cases.LR_CASES + kernel_cases.LR_CASES_WIDE)
def test_lr_measure_plain_equals_bytewise(B, S, N, seed):
    bufs, doms = kernel_cases.lr_measure_batch(B, S, N, seed)
    assert bufs.shape == (B, N + kernel_cases.LR_PAD) and doms.shape == (B, S, 48)
    for i in range(B):  # the rows are independent; one at a time keeps memory small
        got = lr_kernel.lr_measure(torch.from_numpy(bufs[i : i + 1]),
                                   torch.from_numpy(doms[i : i + 1]), N)
        want = measure_bytewise(bufs[i], doms[i], N)
        assert [g.dtype for g in got] == [torch.int32, torch.int32, torch.int64]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[0].numpy(), w)


def measure_walk_model(bufs: np.ndarray, b: int, doms: np.ndarray, N: int):
    """Row ``b``'s (run, dist, xor_next) by the CUDA kernel's algorithm
    (``csrc/lr_measure.cu``), modelled lane for lane in numpy: the rows of
    ``bufs`` lie back to back in memory and are read as aligned 32-bit words
    with the bytes outside the row masked off; a warp walks each live
    dominant's window from its last step of 128 words to its first, a lane on
    4 neighbouring words; winners are a maximum over run << 6 | (63 - slot)."""
    S, M = doms.shape
    L = N // S
    LW = kernel_cases.lr_window_words(N, S)
    W, SPAN = 4, 128
    steps = -(-LW // SPAN)
    padded = steps * SPAN
    none = 4 * LW
    row_len = bufs.shape[1]
    addr = b * row_len  # the row's address; memory starts 4-aligned
    r = addr & 3
    mem = np.concatenate([bufs.reshape(-1), np.full(8, 0xEE, np.uint8)]).astype(np.int64)

    def aligned_word(k):
        k = np.asarray(k, np.int64)
        lo = 4 * k - r
        ok = (lo > -4) & (lo < row_len)
        a = np.where(ok, addr - r + 4 * k, 0)
        v = mem[a] | (mem[a + 1] << 8) | (mem[a + 2] << 16) | (mem[a + 3] << 24)
        v = np.where(lo < 0, v & (0xFFFFFFFF << (8 * np.maximum(-lo, 0))) & 0xFFFFFFFF, v)
        over = np.clip(lo + 4 - row_len, 0, 3)
        return np.where(ok, v & (0xFFFFFFFF >> (8 * over)), 0)

    def funnel(lo, hi, sh):
        return ((lo | (hi << 32)) >> sh) & 0xFFFFFFFF

    def word_at(p):
        q = np.asarray(p, np.int64) + r
        return funnel(aligned_word(q >> 2), aligned_word((q >> 2) + 1), 8 * (q & 3))

    def low_bytes(x):
        return (((x & 0xFF) == 0).astype(np.int64) + ((x & 0xFFFF) == 0)
                + ((x & 0xFFFFFF) == 0) + (x == 0))

    lane = np.arange(32)
    run = np.full((S, LW), -1, np.int64)
    dist = np.zeros((S, LW), np.int64)
    xn = np.zeros((S, LW), np.int64)
    for s in range(S):
        if not (doms[s] > 0).any():
            continue  # the block leaves at once
        pos0 = s * L
        base = word_at(pos0 + 4 * np.arange(padded))
        best = np.full(padded, -1, np.int64)
        for m in range(M):
            d = int(doms[s, m])
            if d <= 0:
                continue
            q0 = pos0 - d + r
            k0, sh, slot = q0 >> 2, 8 * (q0 & 3), 63 - m
            carry = none
            above = np.where(lane == 0, aligned_word(k0 + W * lane + steps * SPAN), 0)
            for c in range(steps - 1, -1, -1):
                a = [aligned_word(k0 + W * lane + c * SPAN + i) for i in range(W)]
                a.append(np.where(lane == 0, above, a[0])[(lane + 1) & 31])
                above = a[0]
                w0 = c * SPAN + W * lane
                x = [base[w0 + i] ^ funnel(a[i], a[i + 1], sh) for i in range(W)]
                own, later = [None] * W, np.full(32, 2**31 - 1, np.int64)
                for i in range(W - 1, -1, -1):
                    later = np.where(x[i] != 0, 4 * (w0 + i) + low_bytes(x[i]), later)
                    own[i] = later
                ballot = sum(1 << int(j) for j in lane if any(int(x[i][j]) for i in range(W)))
                rest = np.array([(ballot >> int(j)) >> 1 for j in lane], np.int64)
                ffs = np.array([(int(v) & -int(v)).bit_length() for v in rest])
                theirs = own[0][(lane + ffs) & 31]
                after = np.minimum(np.where(rest != 0, theirs, carry), none)
                for i in range(W):
                    first = np.minimum(own[i], after)
                    if i == 0:
                        carry = int(first[0])
                    key = (first << 6) + slot - ((w0 + i) << 8)
                    best[w0 + i] = np.maximum(best[w0 + i], key)
        key = best[:LW]
        won = key >= 0
        run[s] = np.where(won, key >> 6, -1)
        dist[s] = np.where(won, doms[s][np.minimum(63 - (key & 63), M - 1)], 0)
        nxt = np.append(key[1:], -1)
        dn = doms[s][np.minimum(63 - (nxt & 63), M - 1)]
        xn[s] = np.where(nxt >= 0, base[:LW] ^ word_at(pos0 + 4 * np.arange(LW) - dn), 0)
    return run, dist, xn


@pytest.mark.parametrize("extra", [0, 1, 2, 3])
@pytest.mark.parametrize("seed", range(len(kernel_cases.LR_PATTERNS)))
def test_lr_walk_model_equals_plain(seed, extra):
    """The CUDA kernel's algorithm, modelled on the CPU, against the plain
    twin; ``extra`` bytes per row give every row another byte alignment."""
    N, S, M = 4096, 8, 6
    rng = np.random.default_rng(seed)
    rows = [kernel_cases.lr_operands(kernel_cases.LR_PATTERNS[(i + seed) % 6], rng, N, S, M)
            for i in range(3)]
    bufs = np.stack([r[0] for r in rows])
    doms = np.stack([r[1] for r in rows])
    bufs = np.concatenate([bufs, rng.integers(1, 255, (3, extra), dtype=np.uint8)], axis=1)
    want = lr_kernel.lr_measure_plain(torch.from_numpy(bufs), torch.from_numpy(doms), N)
    for b in range(3):
        for g, w in zip(measure_walk_model(bufs, b, doms[b], N), want):
            np.testing.assert_array_equal(g, w[b].numpy())


@pytest.mark.parametrize("S,N", [(64, 98304), (32, 98304), (64, 36864), (64, 294912),
                                 (32, 294912)])
def test_lr_walk_model_equals_plain_at_preset_shapes(S, N):
    """A few segments of every pattern at the presets' geometry: the first
    (before the buffer), the last (against the pad), dead, holed, duplicated
    and full rows."""
    keep = [0, 1, 3, 5, 6, S - 2, S - 1]
    for seed in range(len(kernel_cases.LR_PATTERNS)):
        bufs, doms = kernel_cases.lr_measure_batch(1, S, N, seed)
        few = np.zeros_like(doms[0])
        few[keep] = doms[0][keep]  # the other segments leave at once
        want = lr_kernel.lr_measure_plain(torch.from_numpy(bufs), torch.from_numpy(few[None]), N)
        for g, w in zip(measure_walk_model(bufs, 0, few, N), want):
            np.testing.assert_array_equal(g, w[0].numpy())


def _local_lengths_both(buf, doms, N, S, M, sel):
    d_cand = kernel_cases.lr_harvest(doms, N)
    nt, hs = N - 37, 0
    want = jlr.local_dominant_lengths(
        jnp.asarray(buf), N, jnp.int32(nt), jnp.int32(hs), jnp.asarray(d_cand),
        num_dom=M, num_seg=S, harvest_stride=1, sel=sel, pair=True)
    got = tlr.local_dominant_lengths(
        torch.from_numpy(buf)[None], N, torch.tensor([nt]), torch.tensor([hs]),
        torch.from_numpy(d_cand)[None], num_dom=M, num_seg=S, sel=sel)
    return d_cand, nt, hs, want, got


@pytest.mark.parametrize("S,N,sel", [(64, 98304, "run"), (32, 98304, "freq"), (64, 36864, "run"),
                                     (64, 294912, "run"), (32, 294912, "freq"),
                                     (64, 163840, "run")])
@pytest.mark.parametrize("pattern", kernel_cases.LR_PATTERNS)
def test_lr_local_lengths_equal_jax(pattern, S, N, sel):
    rng = np.random.default_rng(S + N)
    buf, doms = kernel_cases.lr_operands(pattern, rng, N, S)
    _, _, _, want, got = _local_lengths_both(buf, doms, N, S, 48, sel)
    assert int((got[0] > 0).sum()) > 0
    np.testing.assert_array_equal(got[0][0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1][0].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("pattern", kernel_cases.LR_PATTERNS)
def test_lr_local_lengths_equal_jax_kernel(pattern):
    """Small ones through the Pallas kernel itself, in interpret mode."""
    N, S, M = 4096, 8, 6
    rng = np.random.default_rng(11)
    buf, doms = kernel_cases.lr_operands(pattern, rng, N, S, M)
    d_cand, nt, hs, want, got = _local_lengths_both(buf, doms, N, S, M, "run")
    # The kernel's word tables read further past the chunk than LR_PAD.
    wide = np.concatenate([buf, np.zeros(4200, np.uint8)])
    kern = jlr.local_dominant_lengths_tpu(
        jnp.asarray(wide), N, jnp.int32(nt), jnp.int32(hs), jnp.asarray(d_cand),
        num_dom=M, num_seg=S, sel="run", pair=True,
        interpret=jax.default_backend() != "tpu")
    for g, w, k in zip(got, want, kern):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(k))


@pytest.mark.parametrize("B,E,nq,seed", kernel_cases.HIST_CASES + kernel_cases.HIST_CASES_WIDE)
def test_quarter_hist_cases_equal_jax_kernel(B, E, nq, seed):
    lsym, dcode = kernel_cases.hist_batch(B, E, seed)
    lf, df = hist_kernel.quarter_histograms(torch.from_numpy(lsym), torch.from_numpy(dcode), nq)
    assert lf.dtype == df.dtype == torch.int32
    lf_j, df_j = quarter_histograms_batched(jnp.asarray(lsym), jnp.asarray(dcode), nq,
                                            interpret=True)
    np.testing.assert_array_equal(lf.numpy(), np.asarray(lf_j))
    np.testing.assert_array_equal(df.numpy(), np.asarray(df_j))
    QL = E // nq
    for b in range(B):
        for q in range(nq):
            ls = lsym[b, q * QL : (q + 1) * QL]
            dc = dcode[b, q * QL : (q + 1) * QL]
            np.testing.assert_array_equal(
                lf[b, q].numpy(), np.bincount(ls[(ls >= 0) & (ls < 286)], minlength=286))
            np.testing.assert_array_equal(
                df[b, q].numpy(), np.bincount(dc[(dc >= 0) & (dc < 30)], minlength=30))
