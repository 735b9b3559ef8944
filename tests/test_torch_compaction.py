"""The port's used-prefix compaction against the JAX package's.

``compact_words_device`` packs by a scatter where the JAX function packs by a
sort; only the prefix ``[:used.sum()]`` is defined in either, and that prefix
is compared exactly, on batches made with numpy from a seed: all stored (no
word used), more than half full, and mixed.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
# The suite runs several workers on one machine: one intra-op thread per
# worker keeps the port's many small ops from oversubscribing the cores.
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from deflate_rs_tpu import constants as C  # noqa: E402
from deflate_rs_tpu.ops import compaction as jc  # noqa: E402
from deflate_rs_tpu_torch.ops import compaction as tc  # noqa: E402


def _batch(kind: str, B: int, NW: int, seed: int):
    """(words uint32[B, NW], btype int32[B], data_bits int32[B])."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, (B, NW), dtype=np.uint64).astype(np.uint32)
    words[:, ::3] |= 0x80000000  # values that do not fit a signed 32-bit word
    if kind == "all_stored":
        btype = np.full(B, C.BTYPE_STORED, np.int32)
        bits = rng.integers(40, 32 * NW, B)
    elif kind == "over_half":
        btype = rng.choice([C.BTYPE_DYNAMIC, C.BTYPE_FIXED, C.BTYPE_SPLIT], B).astype(np.int32)
        bits = rng.integers(24 * NW, 32 * NW + 1, B)
    elif kind == "mixed":
        btype = rng.choice([C.BTYPE_STORED, C.BTYPE_DYNAMIC, C.BTYPE_FIXED, C.BTYPE_SPLIT],
                           B).astype(np.int32)
        bits = rng.integers(0, 32 * NW + 1, B)
        bits[0] = 32 * NW  # a full row
        if B > 2:
            bits[1], btype[1] = 0, C.BTYPE_FIXED  # an empty Huffman row
            bits[2] = 33  # one bit into the second word
    else:
        raise ValueError(kind)
    return words, btype, bits.astype(np.int32)


@pytest.mark.parametrize("kind", ["all_stored", "over_half", "mixed"])
@pytest.mark.parametrize("B,NW", [(1, 64), (3, 97), (4, 1030), (16, 210), (32, 515)])
def test_compacted_prefix_equals_jax(kind, B, NW):
    words, btype, bits = _batch(kind, B, NW, seed=B * NW)
    used_j = jc.used_words_device(jnp.asarray(btype), jnp.asarray(bits))
    want = np.asarray(jc.compact_words_device(jnp.asarray(words), used_j))
    used_h = tc.used_words_host(btype, bits)
    np.testing.assert_array_equal(used_h, jc.used_words_host(btype, bits))
    np.testing.assert_array_equal(used_h, np.asarray(used_j))
    # The encoder's carrier: uint32 values in int64.
    used_t = tc.used_words_device(torch.from_numpy(btype), torch.from_numpy(bits))
    np.testing.assert_array_equal(used_t.numpy(), used_h)
    got = tc.compact_words_device(torch.from_numpy(words.astype(np.int64)), used_t)
    assert got.dtype == torch.int32 and got.shape == (B * NW,)
    need = int(used_h.sum())
    assert need == 0 if kind == "all_stored" else need > 0
    if kind == "over_half":
        assert need > B * NW // 2
    np.testing.assert_array_equal(got.numpy().view(np.uint32)[:need], want[:need])
    # Each chunk's words lie at the exclusive prefix sum of the counts.
    woff = np.cumsum(used_h) - used_h
    for i in range(B):
        np.testing.assert_array_equal(
            got.numpy().view(np.uint32)[woff[i] : woff[i] + used_h[i]], words[i, : used_h[i]])


def test_int32_rows_compact_like_int64_rows():
    """The flat encoder may hand over rows already cut to 32 bits."""
    words, btype, bits = _batch("mixed", 5, 300, seed=9)
    used = tc.used_words_device(torch.from_numpy(btype), torch.from_numpy(bits))
    a = tc.compact_words_device(torch.from_numpy(words.astype(np.int64)), used)
    b = tc.compact_words_device(torch.from_numpy(words.view(np.int32).copy()), used)
    need = int(used.sum())
    np.testing.assert_array_equal(a.numpy()[:need], b.numpy()[:need])
