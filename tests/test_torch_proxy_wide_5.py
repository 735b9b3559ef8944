"""The port's block-split proxy switch table against the JAX package's
float32 form past the totals of 16 MiB chunks, part 2 of 2: the pairs
(k, f) with 25,165,889 < f << k <= 33,554,561 (chunks above 24 MiB up to
32 MiB).

Past 2**24 float32 rounds the total itself (to an even integer), and at
k = 1 the frequency too; the JAX form stays a step at each pair.  The
committed offsets equal those measured from the JAX expression in the
``[R, 30]`` jit form at every total of the part's sweep around each
``f << k`` at every 32nd pair; at every pair both jit forms have their step
at the committed total and the ``[R, 30]`` form the step's sides at the
sweep's ends, and the port's lengths equal the JAX form's there
(``tests/torch_proxy_ref.py``, ``check_wide_part``; the script that
rewrites the table, ``tests/test_torch_proxy.py``, sweeps every pair).
Rows of such totals, and the float32 sums of the token bits of blocks of
32 MiB chunks, in both forms.  Tolerance: exact equality.
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
from torch_proxy_ref import (  # noqa: E402
    ND, NL, check_wide_part, hitting_rows, jax_proxy_bits)

PART = 4


def _port_bits(rows):
    t = torch.from_numpy(np.asarray(rows, np.int64))
    return [x.numpy() for x in proxy.proxy_bits(
        t, torch.from_numpy(proxy.load_switch_table()), torch.from_numpy(proxy.row_offsets()),
        float32_sums=True)]


def test_switch_offsets_equal_jax_past_16mib():
    check_wide_part(PART)


@pytest.mark.parametrize("R,width", [(10, NL), (200, NL), (200, ND)])
def test_proxy_bits_equal_jax_on_table_hits(R, width):
    """Histograms with a symbol of frequency f at a total near f << k of this
    part, where the JAX form leaves the exact count and where it does not."""
    rows = hitting_rows(np.random.default_rng(R + PART), R, PART, width)
    want = jax.jit(jax_proxy_bits)(jnp.asarray(rows, jnp.int32))
    got = _port_bits(rows)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("width", [NL, ND])
def test_proxy_bits_round_their_float32_sums_as_jax_at_32mib(width):
    """Rows of a block of this part's totals (up to 33,554,433 symbols: a
    32 MiB chunk and EOB) spread over every column: the port's float32 sums
    of the token bits, in the JAX package's order of addition, give its
    numbers."""
    rng = np.random.default_rng(width + 32 + PART)
    R = 256
    weights = rng.random((R, width))
    weights[rng.random((R, width)) < 0.2] = 0
    weights[:, 0] += 1e-3
    tot = rng.integers(25_165_824, (1 << 25) + 2, R)
    rows = np.floor(weights / weights.sum(axis=1, keepdims=True) * tot[:, None]).astype(np.int64)
    rows[0, 0] += (1 << 25) + 1 - rows[0].sum()  # a row of the widest total
    want = [np.asarray(w) for w in jax.jit(jax_proxy_bits)(jnp.asarray(rows, jnp.int32))]
    got = _port_bits(rows)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (want[0] >= 1 << 26).sum() > R // 2
