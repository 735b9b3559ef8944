"""The port's jump steps and parse against the JAX package and a serial walk."""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
# The suite runs several workers on one machine: one intra-op thread per
# worker keeps the port's many small ops from oversubscribing the cores.
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from deflate_rs_tpu.ops import parse as jp  # noqa: E402
from deflate_rs_tpu_torch.ops import parse as tp  # noqa: E402
from deflate_rs_tpu_torch.ops.parse_scan import parse_scan  # noqa: E402


def serial_parse(steps, n):
    out = np.zeros(len(steps), bool)
    p = 0
    while p < n:
        out[p] = True
        p += int(steps[p])
    return out


def make_steps(rng, E, match_frac=0.3):
    steps = np.ones(E, np.int32)
    is_m = rng.random(E) < match_frac
    steps[is_m] = rng.integers(3, 259, is_m.sum())
    return steps


@pytest.mark.parametrize("lazy", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_build_jumps_equal(lazy, seed):
    rng = np.random.default_rng(seed)
    E = 4096
    bl = rng.integers(0, 259, E).astype(np.int32)
    bl[rng.random(E) < 0.4] = 0
    bl[rng.random(E) < 0.1] = 3
    bd = np.where(bl > 0, rng.integers(1, 32769, E), 0).astype(np.int32)
    want = jp.build_jumps(jnp.asarray(bl), jnp.asarray(bd), lazy=lazy,
                          lazy_if_less_than=32 if lazy else 0)
    got = tp.build_jumps(torch.from_numpy(bl)[None], torch.from_numpy(bd)[None],
                         lazy=lazy, lazy_if_less_than=32 if lazy else 0)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))


@pytest.mark.parametrize("nfrac", [1.0, 0.55, 0.0, 0.013])
@pytest.mark.parametrize("E", [512, 4096])
def test_parse_equals_jax_reachable_and_serial(nfrac, E):
    rng = np.random.default_rng(int(nfrac * 1000) + E)
    B = 3
    steps = np.stack([make_steps(rng, E) for _ in range(B)])
    steps[1] = 1
    ns = np.full(B, int(E * nfrac), np.int32)
    got = parse_scan(torch.from_numpy(steps), torch.from_numpy(ns)).numpy()
    for b in range(B):
        nxt = jnp.minimum(jnp.arange(E, dtype=jnp.int32) + steps[b], E)
        reach = jp.reachable(jnp.concatenate([nxt, jnp.full(1, E, jnp.int32)]), 0)
        want = np.asarray(reach[:E] & (jnp.arange(E) < ns[b]))
        np.testing.assert_array_equal(got[b], want)
        np.testing.assert_array_equal(got[b], serial_parse(steps[b], ns[b]))


def test_parse_segment_boundary_overhangs():
    E, L = 4096, 16
    steps = np.ones(E, np.int32)
    for s in range(1, E // L):
        steps[s * L - 3] = 40 + (s % 200)
    got = parse_scan(torch.from_numpy(steps)[None], torch.tensor([E], dtype=torch.int32))
    np.testing.assert_array_equal(got[0].numpy(), serial_parse(steps, E))


# ---------------------------------------------------------------------------
# Adversarial operands (deflate_rs_tpu_torch/utils/kernel_cases.py): the JAX
# package against the port's plain twin, and a CPU model of the CUDA kernel's
# algorithm (speculative fix-up in rounds, then a repair pass) against the twin.
# ---------------------------------------------------------------------------

from deflate_rs_tpu.ops.parse_scan import parse_scan_batched  # noqa: E402
from deflate_rs_tpu_torch.utils.kernel_cases import PARSE_CASES, SEG, parse_scan_batch  # noqa: E402


def _plain(steps, ns):
    return parse_scan(torch.from_numpy(steps), torch.from_numpy(ns)).numpy()


@pytest.mark.parametrize("E,B,seed", PARSE_CASES)
def test_adversarial_parse_equals_jax(E, B, seed):
    """Tolerance 0 (booleans).  The Pallas kernel runs in interpret mode at
    the 4 KiB tier; at 64 KiB the JAX side is ``parse.reachable``."""
    steps, ns = parse_scan_batch(E, B, seed)
    got = _plain(steps, ns)
    if E <= 4096:
        want = np.asarray(parse_scan_batched(steps, ns, interpret=True))
    else:
        pos = jnp.arange(E, dtype=jnp.int32)
        rows = []
        for b in range(B):
            nxt = jnp.minimum(pos + steps[b], E)
            reach = jp.reachable(jnp.concatenate([nxt, jnp.full(1, E, jnp.int32)]), 0)
            rows.append(np.asarray(reach[:E] & (pos < ns[b])))
        want = np.stack(rows)
    np.testing.assert_array_equal(got, want)


def speculative_parse_model(steps, n, rounds, carry=0):
    """The CUDA kernel's algorithm for one window of a chunk (the whole chunk
    up to 65,536 positions): hypotheses, ``rounds`` rounds of speculative
    re-walks (the kernel ships one), then the serial repair, which has to be
    right after any number of rounds.  The true parse enters at ``carry``
    (0 for a chunk's first window; ``rounds`` >= 1 otherwise).  A width that
    is no multiple of 64 ends in a partial segment, walked as far as the
    payload goes (``n <= E``)."""
    E = len(steps)
    S = -(-E // SEG)
    steps = steps.tolist()
    hyp, hexit = [0] * S, [0] * S
    for s in range(S):  # phase 1: hypothesis parse of every segment
        p = s * SEG
        while p < (s + 1) * SEG and p < n:
            hyp[s] |= 1 << (p - s * SEG)
            p += steps[p]
        hexit[s] = p
    # The hypothesis is the walk from the segment's start: it converges with
    # itself at offset 0.
    entry = [s * SEG for s in range(S)]
    fix, conv, exit_ = [0] * S, [0] * S, list(hexit)
    for _ in range(rounds):  # phase 2: re-walk where the predecessor's exit moved
        want = [carry] + exit_[:-1]
        stale = [s for s in range(S) if want[s] != entry[s]]
        if not stale:
            break
        for s in stale:
            entry[s] = want[s]
            p = max(entry[s], s * SEG)
            fix[s], conv[s] = 0, SEG
            while p < (s + 1) * SEG and p < n:
                o = p - s * SEG
                if hyp[s] >> o & 1:
                    conv[s] = o
                    break
                fix[s] |= 1 << o
                p += steps[p]
            exit_[s] = p if conv[s] == SEG else hexit[s]
    broken = [s > 0 and exit_[s - 1] != entry[s] for s in range(S)]

    def discard(lo, hi):
        for k in range(lo, hi + 1):
            fix[k], conv[k] = 0, SEG

    last_marked = min(S - 1, (n - 1) // SEG) if n > 0 else -1
    nxt = 1
    while True:  # repair
        j = next((k for k in range(nxt, S) if broken[k]), S)
        if j >= S:
            break
        p, cur, holds = exit_[j - 1], j - 1, False
        while p < n and p < E:
            g = p // SEG
            discard(cur + 1, g)
            cur = g
            o = p % SEG
            if hyp[g] >> o & 1:
                conv[g] = o
                p = hexit[g]
                if g + 1 >= S or entry[g + 1] == p:
                    holds, nxt = True, g + 2
                    break
                continue
            fix[g] |= 1 << o
            p += steps[p]
        if not holds:
            discard(cur + 1, last_marked)
            break
    out = np.zeros(E, bool)
    for s in range(S):
        keep = 0 if conv[s] >= SEG else (~0 << conv[s]) & ((1 << SEG) - 1)
        m = fix[s] | (hyp[s] & keep)
        width = min(SEG, E - s * SEG)
        out[s * SEG : s * SEG + width] = [(m >> o) & 1 for o in range(width)]
    return out


@pytest.mark.parametrize("rounds", [1, 4])
@pytest.mark.parametrize("E,B,seed", PARSE_CASES)
def test_speculative_parse_model_equals_plain(E, B, seed, rounds):
    """The kernel's algorithm, modelled on the CPU, equals the plain twin
    (tolerance 0).  At the 64 KiB tier the first rows of each batch, which
    cover every pattern; every row at 4 KiB."""
    steps, ns = parse_scan_batch(E, B, seed)
    want = _plain(steps, ns)
    rows = range(B) if E <= 4096 else range(min(B, 7))
    for b in rows:
        got = speculative_parse_model(steps[b], int(ns[b]), rounds)
        np.testing.assert_array_equal(got, want[b], err_msg=f"row {b}")


def test_speculation_is_exercised():
    """The cases do reach the repair pass: in the never-converge pattern no
    hypothesis of the first half meets the true parse."""
    steps, ns = parse_scan_batch(4096, 1, 3)  # row 0: never_converge, n = 1
    steps, n = steps[0], 4096
    truth = serial_parse(steps, n)
    assert truth[1:2048:SEG].all() and not truth[SEG:2048:SEG].any()
    for rounds in (0, 1, 4):
        np.testing.assert_array_equal(speculative_parse_model(steps, n, rounds), truth)


# ---------------------------------------------------------------------------
# Chunks wider than one window of the CUDA kernel (65,536 positions): the
# kernel parses window after window, each entered where the last token of the
# window before it lands.
# ---------------------------------------------------------------------------

from deflate_rs_tpu_torch.utils.kernel_cases import (  # noqa: E402
    PARSE_CASES_WIDE, WINDOW, parse_scan_batch_wide)


def windowed_parse_model(steps, n, window=WINDOW):
    """``csrc/parse_scan.cu`` for a chunk of several windows."""
    E = len(steps)
    out = np.zeros(E, bool)
    carry = 0
    for base in range(0, E, window):
        ew = min(window, E - base)
        left = n - base
        if left <= 0:
            break
        marks = speculative_parse_model(steps[base : base + ew], left, 1, carry)
        out[base : base + ew] = marks
        if left > ew:
            last = int(np.flatnonzero(marks)[-1])
            carry = last + int(steps[base + last]) - ew
    return out


@pytest.mark.parametrize("E,B,seed", PARSE_CASES_WIDE)
def test_wide_parse_equals_jax_and_serial(E, B, seed):
    """Tolerance 0 (booleans): the plain twin, the JAX package's
    ``parse.reachable``, the serial walk and the windowed model of the CUDA
    kernel agree on every row."""
    steps, ns = parse_scan_batch_wide(E, B, seed)
    got = _plain(steps, ns)
    pos = jnp.arange(E, dtype=jnp.int32)
    for b in range(B):
        nxt = jnp.minimum(pos + steps[b], E)
        reach = jp.reachable(jnp.concatenate([nxt, jnp.full(1, E, jnp.int32)]), 0)
        np.testing.assert_array_equal(got[b], np.asarray(reach[:E] & (pos < ns[b])))
        truth = serial_parse(steps[b], ns[b])
        np.testing.assert_array_equal(got[b], truth, err_msg=f"row {b}")
        np.testing.assert_array_equal(windowed_parse_model(steps[b], int(ns[b])), truth,
                                      err_msg=f"row {b}")


@pytest.mark.parametrize("window", [256, 1024, 2048])
@pytest.mark.parametrize("E,B,seed", [(4096, 12, s) for s in range(3)])
def test_windowed_model_small_windows(E, B, seed, window):
    """The window hand-over at small sizes, where every pattern meets many
    window edges."""
    steps, ns = parse_scan_batch(E, B, seed)
    for b in range(B):
        np.testing.assert_array_equal(windowed_parse_model(steps[b], int(ns[b]), window),
                                      serial_parse(steps[b], ns[b]), err_msg=f"row {b}")


# ---------------------------------------------------------------------------
# Chunk widths that are multiples of 16 and not of 64 (the kernel's last
# segment of a window holds 16, 32 or 48 positions), and 1 MiB (16 windows).
# ---------------------------------------------------------------------------

from deflate_rs_tpu_torch.utils.kernel_cases import (  # noqa: E402
    PARSE_CASES_GRANULE, PARSE_CASES_MIB, PARSE_CASES_WIDE_GRANULE, parse_payloads_granule)


@pytest.mark.parametrize("E,B,seed", PARSE_CASES_GRANULE)
def test_granule_parse_equals_jax_kernel_and_model(E, B, seed):
    """Tolerance 0 (booleans): the plain twin against the Pallas kernel in
    interpret mode (which reshapes the chunk into 16 rows of E / 16 lanes),
    the serial walk and the CUDA kernel's algorithm, every row."""
    steps, ns = parse_scan_batch(E, B, seed, parse_payloads_granule)
    got = _plain(steps, ns)
    np.testing.assert_array_equal(got, np.asarray(parse_scan_batched(steps, ns, interpret=True)))
    for b in range(B):
        np.testing.assert_array_equal(got[b], serial_parse(steps[b], ns[b]), err_msg=f"row {b}")
        np.testing.assert_array_equal(speculative_parse_model(steps[b], int(ns[b]), 1), got[b],
                                      err_msg=f"row {b}")


@pytest.mark.parametrize("E,B,seed", PARSE_CASES_WIDE_GRANULE + PARSE_CASES_MIB)
def test_wide_granule_parse_equals_jax_and_model(E, B, seed):
    """A last window of one 16-position segment (65,552) and 16 windows
    (1 MiB): the plain twin against ``parse.reachable`` and the serial walk
    on every row, the windowed model of the CUDA kernel on the first six
    (every pattern)."""
    steps, ns = parse_scan_batch_wide(E, B, seed)
    got = _plain(steps, ns)
    pos = jnp.arange(E, dtype=jnp.int32)
    for b in range(B):
        nxt = jnp.minimum(pos + steps[b], E)
        reach = jp.reachable(jnp.concatenate([nxt, jnp.full(1, E, jnp.int32)]), 0)
        np.testing.assert_array_equal(got[b], np.asarray(reach[:E] & (pos < ns[b])))
        truth = serial_parse(steps[b], ns[b])
        np.testing.assert_array_equal(got[b], truth, err_msg=f"row {b}")
        if b < 6:
            np.testing.assert_array_equal(windowed_parse_model(steps[b], int(ns[b])), truth,
                                          err_msg=f"row {b}")
