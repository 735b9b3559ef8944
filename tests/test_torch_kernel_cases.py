"""The adversarial operands of ``deflate_rs_tpu_torch/utils/kernel_cases.py``
for ``lr_measure`` and ``quarter_hist`` on the CPU.

The long-range cases go two ways.  As (buffer, harvest) through the JAX
package's ``longrange.local_dominant_lengths`` (a few small ones also through
``local_dominant_lengths_tpu``, the Pallas kernel in interpret mode) and the
port's ``local_dominant_lengths``.  As raw dominant rows through the port's
plain twin ``lr_measure_plain`` and a byte-by-byte numpy measurement written
here; a lane-for-lane numpy model of the CUDA kernel's algorithm is held
against the twin too, and so is one of the kernel's tiled path (its three
passes over tiles and groups of live slots, its 32- and 64-bit winner keys).
The histogram cases go through the JAX package's
Pallas kernel in interpret mode, the port's twin and ``numpy.bincount``.
The suffix-order scan's cases go through a block-for-block numpy model of
``csrc/sa_scan.cu`` (its halo, min-tables and early stops) against the plain
twin ``sa_scan_plain``.
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
from deflate_rs_tpu_torch.ops import hist_kernel, lr_kernel, matching  # noqa: E402
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


W, SPAN = 4, 128  # words a lane owns in a step; words of a step
LANE = np.arange(32)


class RowWords:
    """Row ``b`` of ``bufs`` as the CUDA kernel reads it: the rows lie back
    to back in memory and are read as aligned 32-bit words with the bytes
    outside the row masked off (and words wholly outside not loaded)."""

    def __init__(self, bufs: np.ndarray, b: int):
        self.len = bufs.shape[1]
        addr = b * self.len  # the row's address; memory starts 4-aligned
        self.r = addr & 3
        self.start = addr - self.r
        self.mem = np.concatenate([bufs.reshape(-1), np.full(8, 0xEE, np.uint8)]).astype(np.int64)

    def aligned_word(self, k):
        k = np.asarray(k, np.int64)
        lo = 4 * k - self.r
        ok = (lo > -4) & (lo < self.len)
        a = np.where(ok, self.start + 4 * k, 0)
        m = self.mem
        v = m[a] | (m[a + 1] << 8) | (m[a + 2] << 16) | (m[a + 3] << 24)
        v = np.where(lo < 0, v & (0xFFFFFFFF << (8 * np.maximum(-lo, 0))) & 0xFFFFFFFF, v)
        over = np.clip(lo + 4 - self.len, 0, 3)
        return np.where(ok, v & (0xFFFFFFFF >> (8 * over)), 0)

    def word_at(self, p):
        q = np.asarray(p, np.int64) + self.r
        return funnel(self.aligned_word(q >> 2), self.aligned_word((q >> 2) + 1), 8 * (q & 3))


def funnel(lo, hi, sh):
    return ((lo | (hi << 32)) >> sh) & 0xFFFFFFFF


def low_bytes(x):
    return (((x & 0xFF) == 0).astype(np.int64) + ((x & 0xFFFF) == 0)
            + ((x & 0xFFFFFF) == 0) + (x == 0))


def walk_model(row: RowWords, k0: int, sh: int, base, none: int, carry: int, steps: int,
               update) -> None:
    """One warp's walk (``walk`` in the kernel): from the last step to the
    first, a lane on 4 neighbouring words; ``update(w, first)`` gets each
    word's first mismatching byte at or after it, ``carry`` is the first
    after the steps."""
    above = np.where(LANE == 0, row.aligned_word(k0 + W * LANE + steps * SPAN), 0)
    for c in range(steps - 1, -1, -1):
        a = [row.aligned_word(k0 + W * LANE + c * SPAN + i) for i in range(W)]
        a.append(np.where(LANE == 0, above, a[0])[(LANE + 1) & 31])
        above = a[0]
        w0 = c * SPAN + W * LANE
        x = [base[w0 + i] ^ funnel(a[i], a[i + 1], sh) for i in range(W)]
        own, later = [None] * W, np.full(32, 2**31 - 1, np.int64)
        for i in range(W - 1, -1, -1):
            later = np.where(x[i] != 0, 4 * (w0 + i) + low_bytes(x[i]), later)
            own[i] = later
        ballot = sum(1 << int(j) for j in LANE if any(int(x[i][j]) for i in range(W)))
        rest = np.array([(ballot >> int(j)) >> 1 for j in LANE], np.int64)
        ffs = np.array([(int(v) & -int(v)).bit_length() for v in rest])
        theirs = own[0][(LANE + ffs) & 31]
        after = np.minimum(np.where(rest != 0, theirs, carry), none)
        for i in range(W):
            first = np.minimum(own[i], after)
            if i == 0:
                carry = int(first[0])
            update(w0 + i, first)


def measure_walk_model(bufs: np.ndarray, b: int, doms: np.ndarray, N: int):
    """Row ``b``'s (run, dist, xor_next) by the CUDA kernel's block path
    (``csrc/lr_measure.cu``), modelled lane for lane in numpy: a warp walks
    each live dominant's window from its last step of 128 words to its
    first; winners are a maximum over run << 6 | (63 - slot)."""
    S, M = doms.shape
    L = N // S
    LW = kernel_cases.lr_window_words(N, S)
    steps = -(-LW // SPAN)
    padded = steps * SPAN
    row = RowWords(bufs, b)
    run = np.full((S, LW), -1, np.int64)
    dist = np.zeros((S, LW), np.int64)
    xn = np.zeros((S, LW), np.int64)
    for s in range(S):
        if not (doms[s] > 0).any():
            continue  # the block leaves at once
        pos0 = s * L
        base = row.word_at(pos0 + 4 * np.arange(padded))
        best = np.full(padded, -1, np.int64)
        for m in range(M):
            d = int(doms[s, m])
            if d <= 0:
                continue
            q0 = pos0 - d + row.r

            def update(w, first, slot=63 - m):
                best[w] = np.maximum(best[w], ((first - 4 * w) << 6) + slot)

            walk_model(row, q0 >> 2, 8 * (q0 & 3), base, 4 * LW, 4 * LW, steps, update)
        key = best[:LW]
        won = key >= 0
        run[s] = np.where(won, key >> 6, -1)
        dist[s] = np.where(won, doms[s][np.minimum(63 - (key & 63), M - 1)], 0)
        nxt = np.append(key[1:], -1)
        dn = doms[s][np.minimum(63 - (nxt & 63), M - 1)]
        xn[s] = np.where(nxt >= 0, base[:LW] ^ row.word_at(pos0 + 4 * np.arange(LW) - dn), 0)
    return run, dist, xn


def pack_key(run, m, sb: int):
    """The tiled path's winner key of slot ``m`` with a run of ``run`` bytes:
    ``(run + 1) << sb | (2^sb - 1 - m)``, 0 for no winner."""
    return ((np.asarray(run, np.int64) + 1) << sb) | ((1 << sb) - 1 - np.asarray(m, np.int64))


def unpack_key(key, sb: int):
    """(run, slot) of a key; run -1 and slot 0 where the key is 0."""
    key = np.asarray(key, np.int64)
    mask = (1 << sb) - 1
    return np.where(key > 0, (key >> sb) - 1, -1), np.where(key > 0, mask - (key & mask), 0)


def measure_tiled_model(bufs: np.ndarray, b: int, doms: np.ndarray, N: int, tile: int,
                        group: int = 8, sb: int | None = None):
    """Row ``b``'s (run, dist, xor_next) by the kernel's tiled path, its
    three passes modelled lane for lane with tiles of ``tile`` words (the
    kernel's is ``kernel_cases.LR_TILE``) and blocks of ``group`` live slots
    (the kernel's are 8, 16 or 32, the most that still make 2,048 blocks),
    ranked with the dead slots skipped.  Pass 1: per tile after the first and live slot, the first
    mismatching window byte of the tile, from a forward scan that stops at
    the first step with one.  Pass 2: per (tile, group), each slot's carry is
    the least of those over the later tiles and its walk starts from it; the
    block keeps a maximum per word of ``pack_key`` keys, with ``sb`` from
    ``lr_kernel.tiled_key_bits`` unless given, and merges it into the row's
    keys by a maximum per word.  Pass 3 unpacks the keys."""
    S, M = doms.shape
    L = N // S
    LW = kernel_cases.lr_window_words(N, S)
    tiles = -(-LW // tile)
    width = 8
    if sb is None:
        sb, width = lr_kernel.tiled_key_bits(LW, M)
    row = RowWords(bufs, b)
    run = np.full((S, LW), -1, np.int64)
    dist = np.zeros((S, LW), np.int64)
    xn = np.zeros((S, LW), np.int64)
    for s in range(S):
        live = [m for m in range(M) if doms[s, m] > 0]
        groups = [live[i : i + group] for i in range(0, len(live), group)]
        keys = np.zeros(LW, np.int64)
        first_of = np.full((M, tiles), -7, np.int64)  # pass 1's scratch
        for t in range(1, tiles):
            tw0, nw = t * tile, min(tile, LW - t * tile)
            pos0 = s * L + 4 * tw0
            base = row.word_at(pos0 + 4 * np.arange(nw))
            for m in live:
                q0 = pos0 - int(doms[s, m]) + row.r
                k0, sh = q0 >> 2, 8 * (q0 & 3)
                found = 4 * LW
                for w0 in range(0, nw, SPAN):
                    w = w0 + W * LANE
                    a = [row.aligned_word(k0 + w + i) for i in range(W + 1)]
                    own = np.full(32, 2**31 - 1, np.int64)
                    for i in range(W - 1, -1, -1):
                        ok = w + i < nw
                        x = np.where(ok, base[np.minimum(w + i, nw - 1)], 0) ^ funnel(
                            a[i], a[i + 1], sh)
                        own = np.where(ok & (x != 0), 4 * (w + i) + low_bytes(x), own)
                    hit = np.nonzero(own != 2**31 - 1)[0]
                    if len(hit):
                        found = 4 * tw0 + int(own[hit[0]])
                        break
                first_of[m, t] = found
        for t in range(tiles):
            tw0, nw = t * tile, min(tile, LW - t * tile)
            steps = -(-nw // SPAN)
            pos0 = s * L + 4 * tw0
            base = row.word_at(pos0 + 4 * np.arange(steps * SPAN))
            for slots in groups:  # one block
                best = np.zeros(steps * SPAN, np.int64)
                for m in slots:
                    carry = min([4 * LW] + [int(first_of[m, u])
                                            for u in range(t + 1, tiles)]) - 4 * tw0

                    def update(w, first, m=m):
                        key = pack_key(first - 4 * w, m, sb)
                        best[w] = np.maximum(best[w], np.where(first >= 4 * w, key, 0))

                    q0 = pos0 - int(doms[s, m]) + row.r
                    walk_model(row, q0 >> 2, 8 * (q0 & 3), base, 4 * (LW - tw0), carry, steps,
                               update)
                keys[tw0 : tw0 + nw] = np.maximum(keys[tw0 : tw0 + nw], best[:nw])
        assert int(keys.max(initial=0)) < 1 << (8 * width)
        r, slot = unpack_key(keys, sb)
        run[s] = r
        dist[s] = np.where(keys > 0, doms[s][np.minimum(slot, M - 1)], 0)
        nxt = np.append(keys[1:], 0)
        _, nslot = unpack_key(nxt, sb)
        xw = row.word_at(s * L + 4 * np.arange(LW)) ^ row.word_at(
            s * L + 4 * np.arange(LW) - doms[s][np.minimum(nslot, M - 1)])
        xn[s] = np.where(nxt > 0, xw, 0)
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


@pytest.mark.parametrize("B,N,D,seed", kernel_cases.LR_GLOBAL_CASES)
def test_lr_global_plain_equals_bytewise(B, N, D, seed):
    """The whole-chunk window (S = 1, the lr_global pass's geometry) at the
    three tiers, every slot live at D = 64 and 256, and rows with dead slots."""
    bufs, doms = kernel_cases.lr_global_batch(B, N, D, seed)
    assert bufs.shape == (B, N + kernel_cases.LR_PAD) and doms.shape == (B, 1, D)
    for i in range(B):
        got = lr_kernel.lr_measure(torch.from_numpy(bufs[i : i + 1]),
                                   torch.from_numpy(doms[i : i + 1]), N)
        want = measure_bytewise(bufs[i], doms[i], N)
        assert int((want[0] >= 0).sum()) > 0
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[0].numpy(), w)


def test_lr_global_ties_go_to_the_first_slot():
    """In the ``ties`` pattern two slots match the same region alike for more
    than 258 bytes, across a tile's edge; the earlier slot wins, whether its
    distance is the longer or the shorter."""
    T = kernel_cases.LR_EDGE
    for N in (36864, 98304):
        bufs, doms = kernel_cases.lr_global_batch(1, N, 64, 7)
        assert kernel_cases.LR_GLOBAL_PATTERNS[7] == "ties"
        run, dist, _ = lr_kernel.lr_measure_plain(torch.from_numpy(bufs),
                                                  torch.from_numpy(doms), N)
        for p, slot in ((4 * T - 350, 0), (3 * T - 350, 2)):
            w = (p + 3) // 4
            assert w // kernel_cases.LR_TILE != (w + int(run[0, 0, w]) // 4) // kernel_cases.LR_TILE
            assert int(run[0, 0, w]) > 258
            assert int(dist[0, 0, w]) == int(doms[0, 0, slot])


@pytest.mark.parametrize("keys", ["narrow", "wide"])
@pytest.mark.parametrize("S", [1, 2])
@pytest.mark.parametrize("seed", range(len(kernel_cases.LR_PATTERNS)))
def test_lr_tiled_model_equals_plain(seed, S, keys):
    """The tiled path's three passes, modelled on the CPU with tiles of 256
    words (5 tiles at S = 1, 3 a segment at S = 2) and 70 slots (more than
    the block path's key holds), in groups of 8, 16 or 32 live slots by the
    seed (their maxima merged across blocks), against the plain twin, with
    the 32-bit keys the geometry takes and with the 64-bit form; three rows,
    each with another byte alignment."""
    N, M = 4096, 70
    rng = np.random.default_rng(40 + seed)
    rows = [kernel_cases.lr_operands(kernel_cases.LR_PATTERNS[(i + seed) % 6], rng, N, S, M)
            for i in range(3)]
    bufs = np.stack([r[0] for r in rows])
    doms = np.stack([r[1] for r in rows])
    bufs = np.concatenate([bufs, rng.integers(1, 255, (3, seed % 4), dtype=np.uint8)], axis=1)
    want = lr_kernel.lr_measure_plain(torch.from_numpy(bufs), torch.from_numpy(doms), N)
    assert lr_kernel.tiled_key_bits(kernel_cases.lr_window_words(N, S), M) == (7, 4)
    sb = 32 if keys == "wide" else None
    for b in range(3):
        for g, w in zip(measure_tiled_model(bufs, b, doms[b], N, 256, (8, 16, 32)[seed % 3],
                                            sb), want):
            np.testing.assert_array_equal(g, w[b].numpy())


@pytest.mark.parametrize("pattern", kernel_cases.LR_GLOBAL_PATTERNS[len(kernel_cases.LR_PATTERNS):])
def test_lr_tiled_model_equals_plain_at_kernel_tile(pattern):
    """The whole-chunk patterns at the 4 KiB tier's window (9,283 words) and
    the kernel's own tile (1,024 words): the first twelve slots of each row,
    which hold the pattern's distances (two groups, the second partial)."""
    N = 36864
    bufs, doms = kernel_cases.lr_global_batch(
        1, N, 64, kernel_cases.LR_GLOBAL_PATTERNS.index(pattern))
    few = np.ascontiguousarray(doms[0, :, :12])
    want = lr_kernel.lr_measure_plain(torch.from_numpy(bufs), torch.from_numpy(few[None]), N)
    assert int((want[0] > 258).sum()) > 0
    for g, w in zip(measure_tiled_model(bufs, 0, few, N, kernel_cases.LR_TILE), want):
        np.testing.assert_array_equal(g, w[0].numpy())


def test_lr_tiled_key_extremes():
    """The 32-bit key at its extremes: the longest run of the widest window
    (a 256 KiB chunk with its history, as one segment) with slot 0 and with
    the last slot the 32-bit form takes there; one slot more takes 64 bits.
    The order holds: a longer run wins, then the lower slot."""
    LW = kernel_cases.lr_window_words(294912, 1)
    assert LW == 73795
    sb, width = lr_kernel.tiled_key_bits(LW, 64)
    assert (sb, width) == (6, 4)
    top = 1 << (32 - (4 * LW + 1).bit_length())  # the most slots of the 32-bit form
    assert top == 8192
    assert lr_kernel.tiled_key_bits(LW, top) == (13, 4)
    assert lr_kernel.tiled_key_bits(LW, top + 1) == (32, 8)
    for M in (64, top):
        sb = lr_kernel.tiled_key_bits(LW, M)[0]
        keys = pack_key([4 * LW, 4 * LW, 4 * LW - 1, 0, 0], [0, M - 1, 0, 0, M - 1], sb)
        assert int(keys.max()) < 1 << 32 and int(keys.min()) > 0
        np.testing.assert_array_equal(unpack_key(keys, sb)[0], [4 * LW, 4 * LW, 4 * LW - 1, 0, 0])
        np.testing.assert_array_equal(unpack_key(keys, sb)[1], [0, M - 1, 0, 0, M - 1])
        assert keys[0] > keys[1] > keys[2] > keys[3] > keys[4]
    wide = pack_key([4 * LW, 0], [top, top], 32)
    np.testing.assert_array_equal(unpack_key(wide, 32)[0], [4 * LW, 0])
    np.testing.assert_array_equal(unpack_key(wide, 32)[1], [top, top])
    assert unpack_key(0, 13)[0] == -1


@pytest.mark.parametrize("step", [1, 7, 64])
@pytest.mark.parametrize("N,S,M", kernel_cases.LR_TILED_GEOMETRIES[:2])
def test_lr_plain_sliced_equals_plain(N, S, M, step):
    """The plain version a few slots at a time (the card checks the 64-bit
    keys' geometry with it) equals the whole: ties across slices go to the
    earlier slice, and word w's XOR follows the winner of word w + 1."""
    buf, doms = (torch.from_numpy(a) for a in kernel_cases.lr_tiled_batch(N, S, M))
    want = lr_kernel.lr_measure_plain(buf, doms, N)
    for g, w in zip(lr_kernel.lr_measure_plain_sliced(buf, doms, N, step), want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


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


@pytest.mark.parametrize("B,E,nq,seed", kernel_cases.HIST_CASES_GRANULE)
def test_quarter_hist_granule_cases_equal_bincount(B, E, nq, seed):
    """Rows of 1 MiB (also against the Pallas kernel in interpret mode) and
    of 4,112 positions, which the Pallas kernel does not take (it wants
    E % (128 nq) == 0; the JAX encoder counts such chunks without it)."""
    lsym, dcode = kernel_cases.hist_batch(B, E, seed)
    lf, df = hist_kernel.quarter_histograms(torch.from_numpy(lsym), torch.from_numpy(dcode), nq)
    if E % (128 * nq) == 0:
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


@pytest.mark.parametrize("S,seed", [(64, 0), (64, 2), (32, 1), (32, 3)])
def test_lr_models_equal_plain_at_1mib(S, seed):
    """A 1 MiB chunk with its history: Default's 64 segments (windows of
    4,291 words) through the block path's model, high's 32 (8,515 words,
    more than a block holds) through the tiled path's, with the kernel's
    tile and groups of 16.  Three segments of the row (the first, one with
    holes, the last), against the plain version taken 8 slots at a time and
    the byte-by-byte measurement."""
    N = 1081344
    assert kernel_cases.lr_window_words(N, S) == {64: 4291, 32: 8515}[S]
    assert (N, S, 48) in kernel_cases.LR_TILED_GEOMETRIES or S == 64
    bufs, doms = kernel_cases.lr_measure_batch(1, S, N, seed)
    few = np.zeros_like(doms[0])
    keep = [0, 5, S - 1]
    few[keep] = doms[0][keep]
    want = lr_kernel.lr_measure_plain_sliced(torch.from_numpy(bufs), torch.from_numpy(few[None]),
                                             N, 8)
    for g, w in zip(want, measure_bytewise(bufs[0], few, N)):
        np.testing.assert_array_equal(g[0].numpy(), w)
    if S == 64:
        model = measure_walk_model(bufs, 0, few, N)
    else:
        model = measure_tiled_model(bufs, 0, few, N, kernel_cases.LR_TILE, 16)
    for g, w in zip(model, want):
        np.testing.assert_array_equal(g, w[0].numpy())


# ------------------------------------------------------------------ sa_scan

SA_ROWS, SA_WINDOW = matching.SA_ROWS, 32768


def score_of(run, pos, c, hst):
    dist = pos - c
    return np.where((dist >= 1) & (dist <= SA_WINDOW) & (c >= hst),
                    (run << 16) | (SA_WINDOW + 1 - dist), 0)


def sa_scan_model(buf, perm, hstart, n_total, K, PW, nkey, tail):
    """``csrc/sa_scan.cu`` in numpy, block by block: each block's rows and
    halo of LCPs (words compared in memory order, keys of invalid rows all
    ones), the min-tables of 16 and 256 rows by doubling, and every row's two
    walks with the kernel's skips and stops; all rows of a block walk at
    once."""
    B, N = perm.shape
    out = np.full((B, N), -1, np.int64)
    deep = K + sum(1 << j for j in tail)
    span = (SA_ROWS + 2 * deep + 15) & ~15
    levels = 8 if max(tail, default=-1) >= 8 else 4 if max(tail, default=-1) >= 4 else 0
    for b in range(B):
        pm = perm[b].astype(np.int64)
        hst, last = int(hstart[b]), int(n_total[b]) - 3
        row = buf[b]

        def words(p):
            at = p[:, None] + np.arange(4 * PW)
            w = row[at].reshape(len(p), PW, 4).copy()
            w[~((p >= hst) & (p <= last)), :nkey] = 0xFF
            return w.view("<u4")[..., 0].astype(np.int64)

        for r0 in range(0, N, SA_ROWS):
            r = r0 - K + np.arange(SA_ROWS + 2 * K)
            sp = np.where((r >= 0) & (r < N), pm[np.clip(r, 0, N - 1)], 0)
            base = r0 - deep
            r = base + np.arange(span)
            a0 = np.zeros(span, np.int64)
            ok = (r >= 1) & (r < N)
            x = words(pm[r[ok]]) ^ words(pm[r[ok] - 1])
            first = np.argmax(x != 0, axis=1)
            d = x[np.arange(len(x)), first]
            low = (d & -d).astype(np.uint64)  # the lowest set bit's byte is the first unequal
            a0[ok] = np.where(d != 0, 4 * first + (np.log2(np.maximum(low, 1)).astype(int) >> 3),
                              4 * PW)
            tables, cur = {0: a0}, a0
            for level in range(1, levels + 1):
                s = 1 << (level - 1)
                cur = np.minimum(cur, np.concatenate([np.full(s, 255), cur[:-s]]))
                tables[level] = cur

            def window(lo, j):
                level = 8 if j >= 8 else 4 if j >= 4 else 0
                step = 1 << level
                return np.min([tables[level][lo + step - 1 + q * step]
                               for q in range(1 << (j - level))], axis=0)

            i = np.arange(r0, min(r0 + SA_ROWS, N))
            pos = sp[i - r0 + K]
            u, v = i - base, i - r0 + K
            valid = (pos >= hst) & (pos <= last)
            best = np.zeros(len(i), np.int64)
            for side in (-1, 1):
                # Depth 1 first.  Where its row shares row i's sort key (al >=
                # 4 nkey), so do ``same`` rows in all: back, the nearest alone
                # scores; ahead, none.  The walk resumes past them from cap.
                at = np.arange(span)
                if side < 0:
                    brk = np.maximum.accumulate(np.where(a0 < 4 * nkey, at, -1))
                    same = np.minimum(u - brk[u], deep)
                else:
                    brk = np.minimum.accumulate(np.where(a0 < 4 * nkey, at, span)[::-1])[::-1]
                    same = np.minimum(brk[u + 1] - u - 1, deep)
                group = same >= 1
                run = np.minimum(4 * PW, a0[u] if side < 0 else a0[u + 1])
                live = valid & (run >= 3)
                if side < 0:
                    best = np.where(live, score_of(run, pos, sp[v - 1], hst), best)
                    live &= ~group | ((run << 16) + SA_WINDOW > best)
                    done = np.where(group, same, 1)
                    run = np.where(group, 4 * PW, run)
                else:
                    live &= (run << 16) + SA_WINDOW > best
                    done = np.where(group, same, 0)
                    run = np.full(len(i), 4 * PW)
                live &= done < deep
                steps = [(d, None) for d in range(1, K + 1)]
                k = K
                for j in tail:
                    steps.append((k + (1 << j), (j, k)))
                    k += 1 << j
                for d, jump in steps:
                    on = live & (d > done)
                    if jump is None:
                        a = a0[u - d + 1] if side < 0 else a0[u + d]
                        c = sp[v - d] if side < 0 else sp[v + d]
                    else:
                        j, k = jump
                        a = window(u - d + 1, j) if side < 0 else window(u + k + 1, j)
                        c = pm[np.clip(i + side * d, 0, N - 1)]
                    run = np.where(on, np.minimum(run, a), run)
                    live &= ~on | ((run >= 3) & ((run << 16) + SA_WINDOW > best))
                    on &= live
                    best = np.where(on, np.maximum(best, score_of(run, pos, c, hst)), best)
            out[b, pos] = np.where(valid, best, 0)
    assert (out >= 0).all()  # every position written once
    return out


@pytest.mark.parametrize("params", kernel_cases.SA_PARAMS, ids=["k64", "k128", "fast"])
@pytest.mark.parametrize("pattern", ["ff_invalid", "period2", "ties", "text"])
def test_sa_scan_model_equals_plain(pattern, params):
    """Four blocks and a half of 4 KiB-tier rows: the halo crosses every
    block edge; the patterns that mask keys beside equal bytes, walk every
    depth and jump, and wander inside deep tie groups, and text."""
    K, PW, nkey, tail = params
    E = 4096
    buf, hs, nt = kernel_cases.sa_batch(E, 1, kernel_cases.SA_PATTERNS.index(pattern))
    b, h, n = torch.from_numpy(buf), torch.from_numpy(hs), torch.from_numpy(nt)
    perm = matching._stable_lex_sort(matching.key_words(b, HALO + E, n, h, nkey))
    want = matching.sa_scan_plain(b, perm, h, n, K, PW, nkey, tail)
    got = sa_scan_model(buf, perm.numpy(), hs, nt, K, PW, nkey, tail)
    np.testing.assert_array_equal(got, want.numpy())
