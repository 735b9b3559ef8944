"""The corpus engine at chunks of 4,352 bytes (17 x 256: the long-range pass
takes them), every preset, against the JAX package's bytes, and Default at
that size on a larger input: the check of ``tests/test_torch_chunk_grid.py``
(``check_against_jax`` of ``tests/torch_corpus_data.py``).  Tolerance: exact
equality.
"""

import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
# The suite runs several workers on one machine: one intra-op thread per
# worker keeps the port's many small ops from oversubscribing the cores.
torch.set_num_threads(1)

from torch_corpus_data import PRESETS, check_against_jax, jax_preset_stream  # noqa: E402

BATCH = 4  # one JAX compile per preset serves both inputs


@pytest.mark.parametrize("preset", PRESETS)
def test_chunk_size_grid_equals_jax_or_raises(preset):
    assert isinstance(jax_preset_stream("small_mix", preset, 4352, BATCH), bytes)
    check_against_jax("small_mix", preset, 4352, BATCH)


def test_small_chunks_equal_jax():
    assert isinstance(jax_preset_stream("mixed_tail", "default", 4352, BATCH), bytes)
    check_against_jax("mixed_tail", "default", 4352, BATCH)
