"""The port's per-quarter histograms against the JAX package's Pallas kernel
(``quarter_histograms_batched``, run in interpret mode on the CPU as
``tests/test_hist_kernel.py`` runs it).  Counts are integers: exact."""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
# The suite runs several workers on one machine: one intra-op thread per
# worker keeps the port's many small ops from oversubscribing the cores.
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from deflate_rs_tpu.ops.hist_kernel import quarter_histograms_batched  # noqa: E402
from deflate_rs_tpu_torch.ops import hist_kernel  # noqa: E402


def _symbols(seed: int, B: int, E: int):
    """Literal/length symbols and distance codes with the encoder's 999 / 99
    sentinels, other out-of-range values and negatives mixed in."""
    rng = np.random.default_rng(seed)
    lsym = rng.integers(0, 286, (B, E)).astype(np.int32)
    lsym[rng.random((B, E)) < 0.3] = 999
    lsym[rng.random((B, E)) < 0.05] = rng.integers(286, 5000)
    lsym[rng.random((B, E)) < 0.05] = -int(rng.integers(1, 1000))
    lsym[0, : E // 3] = 32  # one hot symbol, as in text
    dcode = rng.integers(0, 30, (B, E)).astype(np.int32)
    dcode[rng.random((B, E)) < 0.6] = 99
    dcode[rng.random((B, E)) < 0.05] = -1
    dcode[rng.random((B, E)) < 0.05] = 30
    return lsym, dcode


@pytest.mark.parametrize("nq", [1, 4, 8])
def test_quarter_histograms_equal_jax_kernel(nq):
    B, E = 3, 4096
    lsym, dcode = _symbols(nq, B, E)
    lf_j, df_j = quarter_histograms_batched(jnp.asarray(lsym), jnp.asarray(dcode), nq,
                                            interpret=True)
    lf, df = hist_kernel.quarter_histograms(torch.from_numpy(lsym), torch.from_numpy(dcode), nq)
    assert lf.dtype == df.dtype == torch.int32
    np.testing.assert_array_equal(lf.numpy(), np.asarray(lf_j))
    np.testing.assert_array_equal(df.numpy(), np.asarray(df_j))


def test_quarter_histograms_count_every_position():
    """Each in-range value counts once, in its own quarter; nothing else."""
    B, E, nq = 2, 65536, 8
    lsym, dcode = _symbols(11, B, E)
    lf, df = hist_kernel.quarter_histograms_plain(torch.from_numpy(lsym),
                                                  torch.from_numpy(dcode), nq)
    QL = E // nq
    for b in range(B):
        for q in range(nq):
            ls = lsym[b, q * QL : (q + 1) * QL]
            dc = dcode[b, q * QL : (q + 1) * QL]
            np.testing.assert_array_equal(
                lf[b, q].numpy(), np.bincount(ls[(ls >= 0) & (ls < 286)], minlength=286))
            np.testing.assert_array_equal(
                df[b, q].numpy(), np.bincount(dc[(dc >= 0) & (dc < 30)], minlength=30))
