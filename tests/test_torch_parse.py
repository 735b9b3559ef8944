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
