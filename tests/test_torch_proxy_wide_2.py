"""The port's block-split proxy switch table against the JAX package's
float32 form past the totals of 4 MiB chunks, part 2 of 3: the pairs (k, f)
with 8,388,673 < f << k <= 12,582,977 (chunks above 8 MiB up to 12 MiB).

The committed offsets equal those measured from the JAX expression in the
``[R, 30]`` jit form at every total of the part's sweep around each
``f << k`` (where the JAX form is a step at each pair), the ``[R, 286]``
form has its step at the same total, and the port's lengths equal the JAX
form's on both sides of each step (``tests/torch_proxy_ref.py``,
``check_wide_part``).  The parts are split over three files so that no
file runs long; ``tests/test_torch_proxy.py`` holds the totals up to
4,194,369.  Tolerance: exact equality.
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

PART = 1


def _port_bits(rows):
    t = torch.from_numpy(np.asarray(rows, np.int64))
    return [x.numpy() for x in proxy.proxy_bits(
        t, torch.from_numpy(proxy.load_switch_table()), torch.from_numpy(proxy.row_offsets()),
        float32_sums=True)]


def test_switch_offsets_equal_jax_past_4mib():
    check_wide_part(PART)


@pytest.mark.parametrize("R", [10, 400])
def test_proxy_bits_equal_jax_on_table_hits(R):
    """Histograms with a symbol of frequency f at a total near f << k of this
    part, where the JAX form leaves the exact count and where it does not."""
    rows = hitting_rows(np.random.default_rng(R + PART), R, PART)
    want = jax.jit(jax_proxy_bits)(jnp.asarray(rows, jnp.int32))
    got = _port_bits(rows)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
