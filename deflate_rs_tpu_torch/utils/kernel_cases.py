"""Adversarial operands for the port's hand-written CUDA kernels.

The inputs harvested from the encoders' runs are mostly text and never reach
the corners of the kernels.  ``parse_scan``: hypotheses that never converge,
tokens that jump a whole segment, payloads that end inside a segment.
``package_merge``: rows with 0, 1 or a power of two of live leaves,
frequencies that force the length limit or touch the ``BIG`` clamp.
``lr_measure``: ties across every dominant, runs that cross every warp,
mismatches on either side of a warp's 32 words and at the window's end,
distances of every byte alignment, windows that reach before the buffer or
past its end, dead, holed, duplicated and full dominant rows; and at the
whole-chunk window of one segment (the tiled path), runs that cross tiles or
go on to the window's end and equal long runs at two slots.
``quarter_hist``: one symbol everywhere, nothing in range, negatives, the
bins' edges.  Every kernel also at the chunk sizes the JAX package encodes
beyond 256 KiB (1 MiB) and at multiples of 16 that are no multiple of 64
(4,112 bytes).  ``token_fields``: symbols on either side of both tables' ends
and negative ones, table widths of 0, 15, 32 and more and below 0, extra
values with bits above their width, stored rows.  This module builds such operands with numpy from a seed, so
that the CPU tests (against the JAX package and the plain twins) and the
card-side checks (``chip_smoke.py``, ``tests/test_torch_cuda.py``,
``tools/kernel_ab.py``) run the same cases.
"""

from __future__ import annotations

import numpy as np

from ..constants import MAX_MATCH
from ..constants import WINDOW_SIZE as MAX_DIST

BIG = 1 << 29  # the package-merge padding sentinel (ops/pm_kernel.py)
SEG = 64  # positions per segment of the CUDA parse kernel

PARSE_PATTERNS = ("ones", "max", "uniform", "never_converge", "jump_over", "text")


def text_steps(rng, E: int, match_frac: float = 0.3) -> np.ndarray:
    """Text-like steps: literals with a share of matches of 3..258."""
    steps = np.ones(E, np.int32)
    is_m = rng.random(E) < match_frac
    steps[is_m] = rng.integers(3, 259, int(is_m.sum()))
    return steps


def parse_steps(pattern: str, rng, E: int) -> np.ndarray:
    """One chunk's steps int32[E] of the named pattern."""
    if pattern == "ones":
        return np.ones(E, np.int32)
    if pattern == "max":
        return np.full(E, 258, np.int32)
    if pattern == "uniform":
        return rng.integers(1, 259, E).astype(np.int32)
    if pattern == "never_converge":
        # A constant step of one segment, entered off phase by a first step
        # of 1: the true parse stands at offset 1 of every segment and the
        # hypotheses at offset 0, so none converges for half the chunk; text
        # follows, where the speculation has to resume.
        steps = text_steps(rng, E)
        steps[: E // 2] = SEG
        steps[0] = 1
        return steps
    if pattern == "jump_over":
        # Tokens that start on a segment's last position and jump the whole
        # next segment (and more), between stretches of text.
        steps = text_steps(rng, E)
        steps[SEG - 1 :: 5 * SEG] = 258
        steps[SEG - 2 :: 5 * SEG] = 1
        steps[SEG - 3 :: 5 * SEG] = 1
        return steps
    if pattern == "text":
        return text_steps(rng, E)
    raise ValueError(pattern)


def parse_payloads(E: int) -> list:
    """Payload lengths: the ends, and values inside a segment."""
    return [E, 0, E - 1, 1, E // 2 + 37, SEG + 1, E - SEG - 5]


def parse_scan_batch(E: int, B: int, seed: int = 0, payloads=parse_payloads):
    """``(steps int32[B, E], n int32[B])``: row ``r`` has pattern
    ``(r + seed) % 6`` and payload ``(r + seed) % 7`` of the lists above
    (``payloads(E)`` gives the payload list)."""
    rng = np.random.default_rng(1000 * seed + E + B)
    ns = payloads(E)
    steps = np.stack([parse_steps(PARSE_PATTERNS[(r + seed) % len(PARSE_PATTERNS)], rng, E)
                      for r in range(B)])
    n = np.array([ns[(r + seed) % len(ns)] for r in range(B)], np.int32)
    return steps, n


# (E, B, seed): both tiers; one chunk, a full batch, and one past it.
PARSE_CASES = ([(4096, 1, s) for s in range(6)]
               + [(4096, 32, 0), (4096, 33, 1), (65536, 1, 3), (65536, 32, 0), (65536, 33, 1)])


WINDOW = 65536  # positions the CUDA parse kernel holds at once (csrc/parse_scan.cu)


def parse_payloads_wide(E: int) -> list:
    """Payload lengths of a chunk wider than one window of the parse kernel:
    the ends, and values on either side of a window's edge."""
    return [E, WINDOW, WINDOW + 1, WINDOW - 1, E // 2 + 37, E - WINDOW + 1, E - SEG - 5, 0]


def parse_scan_batch_wide(E: int, B: int, seed: int = 0):
    """As :func:`parse_scan_batch` for chunks of several windows.  The
    patterns hand every kind of entry from a window to the next: ``ones`` and
    ``text`` enter at or near the edge, ``max`` (258 everywhere) lands 2 to
    254 positions inside, past whole segments, ``never_converge`` enters off
    phase by one, and ``jump_over`` jumps from a window's last position."""
    rng = np.random.default_rng(1000 * seed + E + B)
    ns = parse_payloads_wide(E)
    steps = np.stack([parse_steps(PARSE_PATTERNS[(r + seed) % len(PARSE_PATTERNS)], rng, E)
                      for r in range(B)])
    for r in range(B):
        if PARSE_PATTERNS[(r + seed) % len(PARSE_PATTERNS)] == "jump_over":
            steps[r, WINDOW - 1 :: WINDOW] = 258  # taken or not, as the text before it falls
            steps[r, WINDOW - 2 :: WINDOW] = 1
    n = np.array([ns[(r + seed) % len(ns)] for r in range(B)], np.int32)
    return steps, n


# (E, B, seed): two and four windows; every pattern and every payload once.
PARSE_CASES_WIDE = [(131072, 6, 0), (262144, 6, 1), (262144, 8, 3), (196608, 2, 4)]


def parse_payloads_granule(E: int) -> list:
    """Payload lengths of a chunk whose width is no multiple of 64 (one
    window whose last segment holds ``E % 64`` positions): the ends, inside
    that segment, at its start and just before it."""
    tail = E % SEG
    return [E, E - 7, E - tail, E - tail - 1, 0, E // 2 + 37, SEG + 1]


# (E, B, seed) of parse_scan_batch with parse_payloads_granule: the chunk
# sizes that are multiples of 16 and not of 64, in one window (the fast, rle and turbo presets' 4,112 and 8,208 bytes, a last
# segment of 16 positions; 4,128 and 4,144, of 32 and 48); every pattern,
# runs of 258 and the serial repair included, at every payload once.
PARSE_CASES_GRANULE = [(4112, 7, 0), (4112, 7, 3), (8208, 7, 1), (4128, 7, 2), (4144, 7, 4)]
# (E, B, seed) of parse_scan_batch_wide: 65,552 (a last window of one
# segment of 16 positions) and 1 MiB (16 windows), every pattern and payload.
PARSE_CASES_WIDE_GRANULE = [(65552, 8, 0), (65552, 6, 5)]
PARSE_CASES_MIB = [(1048576, 8, 0),
                   # 32 windows, and 64 whose last ends in a partial segment
                   # of 48 positions (4 MiB - 16: fast's and rle's widest).
                   (2097152, 6, 1), (4194288, 6, 2)]
# (E, B, seed) of parse_scan_batch_wide at 128 and 256 windows, each last
# window ending in a partial segment of 48 positions (8 and 16 MiB - 16; the
# chip only: the serial models take minutes there).
PARSE_CASES_16MIB = [(8388592, 4, 3), (16777200, 4, 4)]


def sorted_leaves(freqs: np.ndarray) -> np.ndarray:
    """Leaf values by rank, int32[R, A]: the used frequencies ascending,
    ``BIG`` for unused symbols (the operand of ``lengths_by_rank``)."""
    return np.sort(np.where(freqs > 0, freqs, BIG), axis=1).astype(np.int32)


def _fib(k: int) -> list:
    f = [1, 1]
    while len(f) < k:
        f.append(f[-1] + f[-2])
    return f[:k]


def _row(kind: str, rng, A: int, m: int | None = None) -> np.ndarray:
    f = np.zeros(A, np.int32)
    if kind == "random":  # m live symbols anywhere
        used = rng.choice(A, m, replace=False)
        f[used] = rng.integers(1, 5000, m)
    elif kind == "zipf":  # litlen-like: a few hot symbols, a long tail of ones
        m = int(rng.integers(60, A + 1)) if A > 60 else A
        used = rng.choice(A, m, replace=False)
        f[used] = np.maximum(1, (40000 / (1 + np.arange(m)) ** 1.2).astype(np.int64))
    elif kind == "dist":  # at most 30 live symbols at the front
        k = int(rng.integers(2, min(A, 30) + 1))
        f[:k] = rng.integers(1, 3000, k)
    elif kind == "fib":  # forces the length limit
        k = min(A, 30)
        f[rng.choice(A, k, replace=False)] = _fib(k)
    elif kind == "near_big":  # sums reach the clamp at BIG
        f[:] = rng.integers((1 << 20) - 1000, 1 << 20, A)
    elif kind == "single":
        f[int(rng.integers(0, A))] = int(rng.integers(1, 50))
    elif kind != "empty":
        raise ValueError(kind)
    return f


MIXED_KINDS = ("zipf", "dist", "empty", "single", "fib", "near_big", "dist", "zipf")
M_SWEEP = (0, 1, 2, 3, 31, 32, 33, 64, 65, 255, 256, 286)


FREQ_2P20_CASE = "freq_2p20_286"
# The cases with a leaf of 2**21 to 2**24 (blocks of 2 to 16 MiB chunks).
WIDE_LEAF_CASES = ("freq_2p21_286", "freq_2p22_286", "freq_2p23_286", "freq_2p24_286")


def package_merge_cases() -> list:
    """``[(name, freqs int32[R, A], max_len)]``; 0 marks an unused symbol."""
    cases = []
    rng = np.random.default_rng(2024)
    cases.append(("m_sweep_286", np.stack(
        [_row("random", rng, 286, m) for m in M_SWEEP for _ in range(3)]), 15))
    for A, max_len in ((19, 7), (30, 15), (286, 15)):
        eq = np.stack([np.full(A, v, np.int32) for v in (1, 1000, (1 << 20) - 1)])
        cases.append((f"equal_{A}", eq, max_len))
        cases.append((f"fib_{A}_at_{max_len}", np.stack(
            [_row("fib", rng, A) for _ in range(4)]), max_len))
        cases.append((f"near_big_{A}", np.stack(
            [_row("near_big", rng, A) for _ in range(4)]), max_len))
    for R in (1, 512, 2304):  # small and large rows share a launch
        cases.append((f"mixed_{R}x286", np.stack(
            [_row(MIXED_KINDS[r % len(MIXED_KINDS)], rng, 286) for r in range(R)]), 15))
    cases.append(("mixed_512x19", np.stack(
        [_row(MIXED_KINDS[r % len(MIXED_KINDS)], rng, 19) for r in range(512)]), 7))
    # One symbol of frequency 2**20 and EOB (256) at 1: the litlen row of a
    # 1 MiB block of one byte value at huffman_only or turbo, a leaf of 2**20
    # after the sort.  On symbol 0, and on 97 (b"a"), above unused symbols.
    mib = np.zeros((2, 286), np.int32)
    mib[0, 0] = mib[1, 97] = 1 << 20
    mib[:, 256] = 1
    cases.append((FREQ_2P20_CASE, mib, 15))
    # A leaf of 2**21 on symbols 0 and 97, and a row whose leaves halve from
    # 2**21 (on 97, then 32, 101, ...) down to 1, summing with EOB to 2**22:
    # the length limit binds and the packages reach the row's whole sum.
    two = np.zeros((3, 286), np.int32)
    two[0, 0] = two[1, 97] = 1 << 21
    halving = [97, 32, 101, 116, 0, 10] + list(range(200, 216))
    two[2, halving] = [1 << (21 - i) for i in range(len(halving))]
    two[:, 256] = 1
    cases.append((WIDE_LEAF_CASES[0], two, 15))
    # A leaf of 2**22 (a 4 MiB block of one byte value) on symbols 0 and 97.
    four = np.zeros((2, 286), np.int32)
    four[0, 0] = four[1, 97] = 1 << 22
    four[:, 256] = 1
    cases.append((WIDE_LEAF_CASES[1], four, 15))
    # A leaf of 2**23 on symbols 0 and 97, and a row whose leaves halve from
    # 2**23 down to 1, summing with EOB to 2**24 (an 8 MiB chunk's block).
    eight = np.zeros((3, 286), np.int32)
    eight[0, 0] = eight[1, 97] = 1 << 23
    halving = [97, 32, 101, 116, 0, 10] + list(range(200, 218))
    eight[2, halving] = [1 << (23 - i) for i in range(len(halving))]
    eight[:, 256] = 1
    cases.append((WIDE_LEAF_CASES[2], eight, 15))
    # A leaf of 2**24 (a 16 MiB block of one byte value) on symbols 0 and 97:
    # rows of ``package_merge.MAX_ROW_SUM``.
    sixteen = np.zeros((2, 286), np.int32)
    sixteen[0, 0] = sixteen[1, 97] = 1 << 24
    sixteen[:, 256] = 1
    cases.append((WIDE_LEAF_CASES[3], sixteen, 15))
    cases.append(("no_rows", np.zeros((0, 286), np.int32), 15))
    return cases


# ------------------------------------------------------------- lr_measure

LR_PATTERNS = ("zeros", "period", "mismatch", "alignment", "edges", "text")
LR_PAD = 72  # bytes of a chunk buffer past its N positions


def lr_window_words(N: int, S: int) -> int:
    """Words measured per segment (``ops/lr_kernel.py::window_words``)."""
    return (N // S + MAX_MATCH + 6) // 4 + 1


def _put(doms: np.ndarray, s, values) -> None:
    """Write ``values`` into the leading slots of segment(s) ``s``."""
    M = doms.shape[-1]
    doms[s, : min(M, len(values))] = values[:M]


def _low_entropy(rng, n: int) -> np.ndarray:
    """Four byte values only: runs of every length up to some tens."""
    return rng.integers(97, 101, n, dtype=np.uint8)


def lr_operands(pattern: str, rng, N: int, S: int, M: int = 48):
    """One chunk's ``(buf uint8[N + LR_PAD], doms int32[S, M])`` of the named
    pattern; 0 marks a dead slot.  Whatever the pattern, segment ``s`` has
    its slots reshaped by ``s % 8``: 1 a dead tail, 3 all dead, 5 holes
    between live slots, 6 duplicated distances; the others stay as built
    (all ``M`` live)."""
    L = N // S
    LW = lr_window_words(N, S)
    n = N + LR_PAD
    doms = rng.integers(1, MAX_DIST + 1, (S, M)).astype(np.int32)
    if pattern == "zeros":
        # Every dominant matches the whole window: all tie, the first wins,
        # and the run crosses every warp of the walk.
        buf = np.zeros(n, np.uint8)
        for s in range(S):
            doms[s] = rng.choice(np.arange(1, MAX_DIST + 1), M, replace=False)
    elif pattern == "period":
        # Period d: d and 2d (and 3d) match alike; the earlier slot wins.
        d = int(rng.integers(3, 1200))
        buf = np.resize(rng.integers(0, 256, d, dtype=np.uint8), n)
        _put(doms, slice(0, S, 2), np.array([2 * d, d, 3 * d], np.int32))
        _put(doms, slice(1, S, 2), np.array([d, 3 * d, 2 * d], np.int32))
    elif pattern == "mismatch":
        # Period d broken by one byte per segment: at words 31, 32, 33 (the
        # sides of a warp's 32 words), LW - 2 and LW - 1, at each byte 0..3.
        d = 4 * int(rng.integers(2, 300)) + int(rng.integers(0, 4))
        buf = np.resize(rng.integers(0, 256, d, dtype=np.uint8), n)
        words = (31, 32, 33, LW - 2, LW - 1)
        for s in range(S):
            p = s * L + 4 * words[s % 5] + (s // 5) % 4
            if p < n:
                buf[p] ^= 0x55
        doms[:, 6:] = 0
        _put(doms, slice(None), np.array([d, 2 * d, d + 1, 1, MAX_DIST, 4 * d], np.int32))
    elif pattern == "alignment":
        # Distances of every byte alignment, the smallest and the largest.
        buf = _low_entropy(rng, n)
        fixed = np.array([1, 2, 3, 4, 5, 6, 7, 8, MAX_DIST, MAX_DIST - 1, MAX_DIST - 2,
                          MAX_DIST - 3], np.int32)
        for s in range(S):
            _put(doms, s, fixed)
            doms[s] = rng.permutation(doms[s])
    elif pattern == "edges":
        # Segment 0 with distances that reach before the buffer (zeros
        # there, and zeros at the buffer's start to match them); the last
        # segment against a pad that is all zeros or all sevens, so that a
        # run either goes on past the buffer's end or stops exactly there.
        buf = _low_entropy(rng, n)
        buf[:300] = 0
        buf[N - 400 :] = 0 if rng.integers(0, 2) else 7
        _put(doms, 0, np.array([MAX_DIST, 20000, 301, 300, 299, 5, 2, 1], np.int32))
        _put(doms, S - 1, np.array([1, 2, 3, 4, 71, 72, 73, 400], np.int32))
    elif pattern == "text":
        # Long copies at a few distances among low-entropy bytes.
        buf = _low_entropy(rng, n)
        copies = rng.integers(1, min(N // 4, MAX_DIST), 3)
        for q in copies:
            at = int(rng.integers(q, N - 2 * MAX_MATCH))
            ln = int(rng.integers(MAX_MATCH, 2 * MAX_MATCH))
            buf[at : at + ln] = buf[at - q : at - q + ln].copy()
        _put(doms, slice(None), copies.astype(np.int32))
    else:
        raise ValueError(pattern)
    for s in range(S):
        k = s % 8
        if k == 1:
            doms[s, M // 2 :] = 0
        elif k == 3:
            doms[s] = 0
        elif k == 5:
            doms[s, 1] = 0
            doms[s, 3:5] = 0
        elif k == 6:
            doms[s, 2] = doms[s, 0]
            doms[s, M - 1] = doms[s, 1]
    return buf, doms


def lr_measure_batch(B: int, S: int, N: int, seed: int = 0, M: int = 48):
    """``(buf uint8[B, N + LR_PAD], doms int32[B, S, M])``: row ``r`` has
    pattern ``(r + seed) % 6`` of ``LR_PATTERNS``."""
    rng = np.random.default_rng(7000 * seed + N + 3 * B + S)
    rows = [lr_operands(LR_PATTERNS[(r + seed) % len(LR_PATTERNS)], rng, N, S, M)
            for r in range(B)]
    return np.stack([r[0] for r in rows]), np.stack([r[1] for r in rows])


def lr_harvest(doms: np.ndarray, N: int) -> np.ndarray:
    """Harvested distances int32[N] whose per-segment dominants are (up to
    their order) the live slots of ``doms`` int32[S, M]: earlier slots get
    longer runs, a gap of two positions between runs."""
    S, M = doms.shape
    L = N // S
    d_cand = np.zeros(N, np.int32)
    for s in range(S):
        p = s * L
        for m in range(M):
            ln = 2 * (1 + (M - m) // 4)
            if doms[s, m] <= 0:
                continue
            if p + ln > (s + 1) * L:
                break
            d_cand[p : p + ln] = doms[s, m]
            p += ln + 2
    return d_cand


# (B, S, N, seed): one chunk in every pattern at Default's and high's segment
# counts and at the 4 KiB tier's N; a full batch and one past it.
LR_CASES = ([(1, S, N, seed) for S, N in ((64, 98304), (32, 98304), (64, 36864))
             for seed in range(len(LR_PATTERNS))]
            + [(32, 64, 98304, 0), (33, 32, 98304, 1), (33, 64, 36864, 2), (32, 32, 36864, 3)])


# (B, S, N, seed): chunks of 128 and 256 KiB with their 32 KiB of history, at
# Default's 64 segments (windows of 707 and 1,219 words) and high's 32 (1,347
# and 2,371 words).
LR_CASES_WIDE = ([(1, 64, 294912, seed) for seed in range(len(LR_PATTERNS))]
                 + [(1, 32, 294912, 1), (1, 32, 163840, 4), (3, 64, 163840, 2)])
# (B, S, N, seed): chunks of 512 KiB and 1 MiB with their history at Default's
# 64 segments (windows of 2,243 and 4,291 words: the block path) and a 1 MiB
# chunk at high's 32 (8,515 words, more than a block holds: the tiled path
# on a preset's main path).
LR_CASES_MIB = ([(1, 64, 1081344, seed) for seed in range(len(LR_PATTERNS))]
                + [(2, 64, 557056, 1)]
                + [(1, 32, 1081344, seed) for seed in range(len(LR_PATTERNS))])
# (B, S, N, seed) at 16 MiB chunks and a raised dom_segs: Default at 1,024
# segments (windows of 4,171 words: the block path, 1,024 blocks a chunk)
# and at 512 (8,275 words: the tiled path).
LR_CASES_16MIB = [(1, 1024, 16809984, 0), (1, 1024, 16809984, 3), (1, 512, 16809984, 1)]


# ---------------------------------------------- lr_measure, whole-chunk window
# The lr_global pass measures the whole chunk as one segment (S = 1) at up to
# D slots: the kernel's tiled path, tiles of LR_TILE words.

LR_TILE = 1024  # words of a tile of the tiled path (csrc/lr_measure.cu, kTile)
LR_EDGE = 8 * LR_TILE  # bytes between the edges the patterns below straddle: two tiles
LR_GLOBAL_PATTERNS = LR_PATTERNS + ("cross", "ties", "before", "to_end")


def lr_global_operands(pattern: str, rng, N: int, D: int):
    """One chunk's ``(buf uint8[N + LR_PAD], doms int32[1, D])`` at S = 1 of
    the named pattern, every slot live.  The patterns of ``LR_PATTERNS``
    are built as :func:`lr_operands` builds segment 0; then:

    - ``cross``: copies of 3 ``LR_EDGE`` and more that start just before an
      edge, so a run crosses tiles and its carry decides its length;
    - ``ties``: two regions of 300-700 random bytes, each repeated at a short
      and a long distance (their sources a few tiles apart) and straddling an
      edge: equal runs above 258 bytes at two slots, the earlier slot
      short in one region and long in the other, and the earlier must win;
    - ``before``: 20,000 zero bytes at the start and distances up to 32,768,
      so the words d bytes back lie before the buffer (and read as zero);
    - ``to_end``: the last 30,000 bytes and the pad are zero, so runs at
      short distances go on to the window's end (no mismatch after them)."""
    T = LR_EDGE
    n = N + LR_PAD
    if pattern in LR_PATTERNS:
        return lr_operands(pattern, rng, N, 1, D)
    doms = rng.choice(np.arange(1, MAX_DIST + 1), (1, D), replace=False).astype(np.int32)
    if pattern == "cross":
        buf = _low_entropy(rng, n)
        fixed = []
        for k in range(1, N // T):
            q = int(rng.integers(1, min(k * T - 600, MAX_DIST)))
            at = k * T - int(rng.integers(1, 600))
            ln = min(3 * T + 1000, N - at)
            # A copy byte by byte: where it overlaps itself it repeats.
            buf[at : at + ln] = buf[at - q + np.arange(ln) % q]
            fixed.append(q)
        _put(doms, 0, np.array(fixed, np.int32))
    elif pattern == "ties":
        buf = rng.integers(0, 256, n, dtype=np.uint8)
        # (target start, (earlier slot's distance, later slot's distance))
        regions = ((4 * T - 350, (3 * T + 1000, 1200)), (3 * T - 350, (700, 20000)))
        for (p, pair) in regions:
            R = int(rng.integers(300, 701))
            x = rng.integers(0, 256, R, dtype=np.uint8)
            for d in pair:
                buf[p - d : p - d + R] = x
            buf[p : p + R] = x
            # The byte after the region differs from both copies' next byte.
            others = {int(buf[p + R - d]) for d in pair}
            buf[p + R] = next(v for v in range(256) if v not in others)
        doms[0, :4] = [*regions[0][1], *regions[1][1]]
    elif pattern == "before":
        buf = _low_entropy(rng, n)
        buf[:20000] = 0
        _put(doms, 0, np.array([MAX_DIST, 30000, 20001, 19999, 8192, 4], np.int32))
    elif pattern == "to_end":
        buf = _low_entropy(rng, n)
        buf[n - 30000 :] = 0
        _put(doms, 0, np.array([1, 2, 3, 4, 300, 301, 20000], np.int32))
    else:
        raise ValueError(pattern)
    return buf, doms


def lr_global_batch(B: int, N: int, D: int, seed: int = 0):
    """``(buf uint8[B, N + LR_PAD], doms int32[B, 1, D])``: row ``r`` has
    pattern ``(r + seed) % 10`` of ``LR_GLOBAL_PATTERNS``; odd rows get dead
    slots (two holes and a dead tail, as an lr_global union never has) and a
    duplicated distance."""
    rng = np.random.default_rng(9000 * seed + N + 5 * B + D)
    bufs, doms = [], []
    for r in range(B):
        buf, d = lr_global_operands(
            LR_GLOBAL_PATTERNS[(r + seed) % len(LR_GLOBAL_PATTERNS)], rng, N, D)
        if r % 2:
            d[0, 1] = 0
            d[0, 3 * D // 4 :] = 0
            d[0, D // 2] = 0
            d[0, D // 2 + 1] = d[0, 0]
        bufs.append(buf)
        doms.append(d)
    return np.stack(bufs), np.stack(doms)


# (B, N, D, seed) at S = 1: every pattern at the 4 KiB tier's N (windows of
# 9,283 words, 10 tiles) with D = 64 and 256, and at 64 KiB (24,643 words, 25
# tiles) with D = 64; the new patterns at D = 256 there and at 256 KiB (73,795
# words, 73 tiles) with D = 64; two batches with dead slots.
LR_GLOBAL_CASES = ([(1, 36864, D, seed) for D in (64, 256)
                    for seed in range(len(LR_GLOBAL_PATTERNS))]
                   + [(1, 98304, 64, seed) for seed in range(len(LR_GLOBAL_PATTERNS))]
                   + [(1, N, D, seed) for N, D in ((98304, 256), (294912, 64))
                      for seed in range(len(LR_PATTERNS), len(LR_GLOBAL_PATTERNS))]
                   + [(4, 98304, 64, 3), (3, 36864, 256, 6)])


# (N, S, M): the tiled path where the block path's key has no room (more than
# 64 slots) at windows that fit it, the widest union of Default (64
# segments x 48 dominants) at the 4 KiB tier's whole-chunk window, and high's
# local pass at a 1 MiB chunk (32 segments of 8,515 words).
LR_TILED_GEOMETRIES = [(4096, 1, 70), (4096, 2, 70), (98304, 32, 100), (36864, 1, 3072),
                       (1081344, 32, 48)]
# The 64-bit winner keys: one slot more than the 32-bit form takes at the
# widest window (a 256 KiB chunk with its history as one segment).
LR_WIDE_KEY_GEOMETRY = (294912, 1, 8193)


def lr_tiled_batch(N: int, S: int, M: int, rows: int = 3):
    """``(buf uint8[rows, N + LR_PAD + 1], doms int32[rows, S, M])``: row
    ``i`` in pattern ``i % 6`` of ``LR_PATTERNS``; the odd row length starts
    each row at another byte alignment."""
    rng = np.random.default_rng(M + S)
    ops = [lr_operands(LR_PATTERNS[i % len(LR_PATTERNS)], rng, N, S, M) for i in range(rows)]
    bufs = np.concatenate([np.stack([o[0] for o in ops]), np.zeros((rows, 1), np.uint8)], axis=1)
    return bufs, np.stack([o[1] for o in ops])


# ----------------------------------------------------------- quarter_hist

HIST_PATTERNS = ("one_symbol", "out_of_range", "negatives", "edges", "text")


def hist_operands(pattern: str, rng, E: int):
    """One chunk's ``(lsym int32[E], dcode int32[E])`` of the named pattern."""
    if pattern == "one_symbol":  # worst contention on one bin
        return np.full(E, 32, np.int32), np.full(E, 5, np.int32)
    if pattern == "out_of_range":  # the encoder's sentinels everywhere
        return np.full(E, 999, np.int32), np.full(E, 99, np.int32)
    if pattern == "negatives":
        lsym = rng.integers(-300, 286, E).astype(np.int32)
        dcode = rng.integers(-40, 30, E).astype(np.int32)
        lsym[:: 97] = np.iinfo(np.int32).min
        dcode[:: 89] = np.iinfo(np.int32).min
        return lsym, dcode
    if pattern == "edges":  # the last bin, the first value past it, around 0
        return (rng.choice(np.array([285, 286, 0, -1, 287], np.int32), E),
                rng.choice(np.array([29, 30, 0, -1, 31], np.int32), E))
    if pattern == "text":  # a hot symbol, the sentinels, the full range
        lsym = rng.integers(0, 286, E).astype(np.int32)
        lsym[rng.random(E) < 0.3] = 999
        lsym[rng.random(E) < 0.2] = 101
        dcode = rng.integers(0, 30, E).astype(np.int32)
        dcode[rng.random(E) < 0.6] = 99
        return lsym, dcode
    raise ValueError(pattern)


def hist_batch(B: int, E: int, seed: int = 0):
    """``(lsym int32[B, E], dcode int32[B, E])``: row ``r`` has pattern
    ``(r + seed) % 5`` of ``HIST_PATTERNS``."""
    rng = np.random.default_rng(9000 * seed + E + B)
    rows = [hist_operands(HIST_PATTERNS[(r + seed) % len(HIST_PATTERNS)], rng, E)
            for r in range(B)]
    return np.stack([r[0] for r in rows]), np.stack([r[1] for r in rows])


# (B, E, nq, seed): one chunk in every pattern and a batch past 32, in both
# tiers, at every number of quarters a preset uses.
HIST_CASES_WIDE = [(2, 262144, nq, seed) for nq, seed in ((1, 0), (4, 1), (8, 2), (8, 4))]
# (B, E, nq, seed): rows of 1 MiB at every preset's quarters, and 4,112
# positions at nq 1 and 4 (fast and turbo, rle: quarters of 1,028 positions,
# still read with 16-byte loads).
HIST_CASES_GRANULE = ([(2, 1048576, nq, seed) for nq, seed in ((1, 0), (4, 1), (8, 2))]
                      + [(B, 4112, nq, seed) for B, nq, seed in ((1, 1, 0), (5, 1, 3),
                                                                 (1, 4, 1), (5, 4, 4))]
                      # rows of 4 MiB: quarters of up to 4 Mi positions
                      + [(1, 4194304, nq, seed) for nq, seed in ((1, 5), (4, 6), (8, 7))])
HIST_CASES = ([(1, E, nq, seed) for E in (4096, 65536) for nq in (1, 2, 4, 8)
               for seed in range(len(HIST_PATTERNS))]
              + [(33, E, nq, 0) for E in (4096, 65536) for nq in (1, 2, 4, 8)])


# ----------------------------------------------------------- token_fields

I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1
# Symbols on either side of each table's ends, the encoder's sentinels and
# the int32 extremes: every one below 288 (30) is a token, negatives too.
FIELD_LSYM_EDGES = np.array([-1, 0, 287, 288, 999, -300, I32_MIN, I32_MAX], np.int32)
FIELD_DCODE_EDGES = np.array([-1, 0, 29, 30, 99, -31, I32_MIN, I32_MAX], np.int32)
# Widths of a table entry's high half: none, the longest code, shifts of 32
# and more, and halves with bit 15 set (an entry below 0: a negative width).
FIELD_WIDTHS = np.array([0, 15, 32, 33, 40, 0x7FFF, 0x8000, 0xFFFF], np.int64)


def field_operands(rng, E: int, nq: int, huff: int):
    """One chunk's token_fields operands ``(huff, lsym, len_en, len_ev,
    dcode, dist_en, dist_ev, l_pack_q, d_pack_q)`` (the arrays without their
    batch axis): text-like symbols with a third of the positions on
    ``FIELD_*_EDGES``; table entries whose codes use all 16 bits and whose
    widths are mostly 1..15 with an eighth on ``FIELD_WIDTHS``; extra-bit
    counts of 0..13 with the odd 31, 32 or -1; extra values anywhere in the
    32 bits, so they carry bits above their width."""
    lsym = rng.integers(0, 286, E).astype(np.int32)
    lsym[rng.random(E) < 0.3] = 999
    at = rng.random(E) < 0.3
    lsym[at] = rng.choice(FIELD_LSYM_EDGES, int(at.sum()))
    dcode = rng.integers(0, 30, E).astype(np.int32)
    dcode[rng.random(E) < 0.5] = 99
    at = rng.random(E) < 0.3
    dcode[at] = rng.choice(FIELD_DCODE_EDGES, int(at.sum()))

    def extra(hi):
        en = rng.integers(0, hi, E).astype(np.int32)
        odd = rng.random(E) < 0.02
        en[odd] = rng.choice(np.array([31, 32, -1], np.int32), int(odd.sum()))
        ev = rng.integers(I32_MIN, I32_MAX, E, dtype=np.int64, endpoint=True).astype(np.int32)
        return en, ev

    def table(n):
        width = rng.integers(1, 16, (nq, n)).astype(np.int64)
        odd = rng.random((nq, n)) < 0.125
        width[odd] = rng.choice(FIELD_WIDTHS, int(odd.sum()))
        code = rng.integers(0, 1 << 16, (nq, n))
        return ((width << 16) | code).astype(np.uint32).view(np.int32)

    len_en, len_ev = extra(6)
    dist_en, dist_ev = extra(14)
    return (np.int32(huff), lsym, len_en, len_ev, dcode, dist_en, dist_ev,
            table(288), table(30))


def field_batch(B: int, E: int, nq: int, seed: int = 0):
    """The nine token_fields operands for ``B`` chunks; row ``r`` is stored
    (``huff`` 0) where ``(r + seed) % 3 == 2``."""
    rng = np.random.default_rng(11000 * seed + E + 7 * nq + B)
    rows = [field_operands(rng, E, nq, int((r + seed) % 3 != 2)) for r in range(B)]
    return tuple(np.stack(col) for col in zip(*rows))


# (B, E, nq): shapes outside the encoder's, for the kernel's edge paths: rows
# whose length is no multiple of 4 (scalar loads), quarters of 3 positions
# (a tile touching four), more quarters than a preset makes.
FIELD_ODD_SHAPES = [(2, 4098, 2), (3, 6000, 3), (1, 12, 4), (2, 65536, 32)]

# (B, E, nq, seed): one chunk of both tiers at every number of quarters a
# preset or block_split makes (the 4 KiB tier at nq 32 has quarters of 128
# positions, four to a kernel tile), stored rows among them; a batch of
# three; one chunk of the widest tier.
FIELD_CASES = ([(1, E, nq, seed) for E in (4096, 65536)
                for seed, nq in enumerate((1, 2, 4, 8, 32))]
               + [(3, 4096, 8, 1), (1, 262144, 8, 0)])
# (B, E, nq, seed): rows of 1 MiB at Default's 8 quarters and fast's 1, and
# 4,112 positions at nq 1 and 4 (quarters of 1,028 positions; the card also
# checks them one element into their buffers, on the scalar path).
FIELD_CASES_GRANULE = [(1, 1048576, 8, 0), (1, 1048576, 1, 1), (5, 4112, 1, 2),
                       (5, 4112, 4, 3)]
