"""The corpus engine at chunks of 4,112 and 8,208 bytes (multiples of 16,
not of 64), every preset, against the JAX package: where the JAX
``compress_corpus`` gives a stream the port gives the same bytes, and where
it fails (an assertion in its long-range pass, which wants a chunk and its
32 KiB of history to divide by four times the segments: Default, high,
ForceFixed, ForceStored) the port raises ``ValueError`` at the entry.  Then
a larger input at 4,112 bytes for fast, rle and turbo.  The 4,352-byte
column is ``tests/test_torch_chunk_grid_lr.py``.  Inputs and the check from
``tests/torch_corpus_data.py``; tolerance: exact equality.
"""

import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
# The suite runs several workers on one machine: one intra-op thread per
# worker keeps the port's many small ops from oversubscribing the cores.
torch.set_num_threads(1)

from torch_corpus_data import PRESETS, check_against_jax, jax_preset_stream  # noqa: E402

BATCH = 4  # one JAX compile per (preset, size) serves both inputs


@pytest.mark.parametrize("E", [4112, 8208])
@pytest.mark.parametrize("preset", PRESETS)
def test_chunk_size_grid_equals_jax_or_raises(preset, E):
    check_against_jax("small_mix", preset, E, BATCH)


@pytest.mark.parametrize("preset", ["fast", "rle", "turbo"])
def test_small_chunks_equal_jax(preset):
    assert isinstance(jax_preset_stream("mixed_tail", preset, 4112, BATCH), bytes)
    check_against_jax("mixed_tail", preset, 4112, BATCH)
