"""Adversarial operands for the ``parse_scan`` and ``package_merge`` kernels.

The inputs harvested from the encoders' runs are mostly text and never reach
the corners of the two kernels: hypotheses that never converge, tokens that
jump a whole segment, payloads that end inside a segment; rows with 0, 1 or
a power of two of live leaves, frequencies that force the length limit or
touch the ``BIG`` clamp.  This module builds such operands with numpy from a
seed, so that the CPU tests (against the JAX package and the plain twins)
and the card-side checks (``chip_smoke.py``, ``tests/test_torch_cuda.py``)
run the same cases.
"""

from __future__ import annotations

import numpy as np

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


def parse_scan_batch(E: int, B: int, seed: int = 0):
    """``(steps int32[B, E], n int32[B])``: row ``r`` has pattern
    ``(r + seed) % 6`` and payload ``(r + seed) % 7`` of the lists above."""
    rng = np.random.default_rng(1000 * seed + E + B)
    ns = parse_payloads(E)
    steps = np.stack([parse_steps(PARSE_PATTERNS[(r + seed) % len(PARSE_PATTERNS)], rng, E)
                      for r in range(B)])
    n = np.array([ns[(r + seed) % len(ns)] for r in range(B)], np.int32)
    return steps, n


# (E, B, seed): both tiers; one chunk, a full batch, and one past it.
PARSE_CASES = ([(4096, 1, s) for s in range(6)]
               + [(4096, 32, 0), (4096, 33, 1), (65536, 1, 3), (65536, 32, 0), (65536, 33, 1)])


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
    cases.append(("no_rows", np.zeros((0, 286), np.int32), 15))
    return cases
