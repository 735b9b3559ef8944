"""The rules of the corpus engine at chunk sizes from 1 MiB to 4 MiB.

``check_chunk_size`` against what the JAX package's ``compress_corpus``
traces (``jax.eval_shape`` of its batch encoder: the refusals are its
trace-time asserts); fast and rle at 4 MiB against the JAX package's bytes;
a stored 4 MiB chunk with ``packed=False``; huffman_only and turbo on 2 MiB and 4 MiB of one byte value (a litlen leaf
of 2**21 or 2**22; port only, each stream round-trips); the package-merge
rows of ``kernel_cases``' leaves of 2**21 and 2**22 (Kraft's sum is 1); the
default batch by chunk size; the dry run's one-shot comparison above
64 KiB.  Tolerance: exact equality.
"""

import dataclasses
import functools
import zlib
from fractions import Fraction

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
# The suite runs several workers on one machine: one intra-op thread per
# worker keeps the port's many small ops from oversubscribing the cores.
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deflate_rs_tpu as dj  # noqa: E402
import deflate_rs_tpu_torch as dt  # noqa: E402
from deflate_rs_tpu.models.deflate import _resolve as j_resolve  # noqa: E402
from deflate_rs_tpu.parallel import corpus as jcorpus  # noqa: E402
from deflate_rs_tpu_torch.models.inflate import inflate  # noqa: E402
from deflate_rs_tpu_torch.ops.package_merge import MAX_ROW_SUM, package_merge_rows  # noqa: E402
from deflate_rs_tpu_torch.parallel import corpus as tcorpus  # noqa: E402
from deflate_rs_tpu_torch.tools.dryrun_multichip import dryrun_multichip  # noqa: E402
from deflate_rs_tpu_torch.utils.kernel_cases import (  # noqa: E402
    WIDE_LEAF_CASES, package_merge_cases)
from torch_corpus_data import inputs  # noqa: E402

CPU = {"device": "cpu"}
MIB = 1 << 20
HALO = 32768


def _options(pkg, name: str):
    if name == "default_lr_global_64":
        return dataclasses.replace(pkg.CompressionOptions.default(), lr_global=64)
    return getattr(pkg.CompressionOptions, name)()


def _jax_takes(name: str, E: int) -> bool:
    """Whether the JAX package's corpus engine traces chunks of ``E`` bytes
    at these options (with the chain scale its ``compress_corpus`` sets)."""
    o = j_resolve(_options(dj, name))
    if E > 65536 and o.max_hash_checks:
        o = dataclasses.replace(o, chain_scale=max(1, E // 65536))
    S = jax.ShapeDtypeStruct
    try:
        jax.eval_shape(jcorpus._corpus_encoder_flat(o, E, 1), S((E,), jnp.uint8),
                       S((HALO,), jnp.uint8), S((1,), jnp.int32), S((1,), jnp.int32),
                       S((1,), jnp.bool_))
    except (AssertionError, ValueError):
        return False
    return True


# (options, chunk size, taken by the JAX package): Default's and high's
# long-range rules at their widest, the presets without that pass, the
# lr_global knob, and fast one past 4 MiB.
PAIRS = [("default", MIB + 16, False), ("default", 2 * MIB, True),
         ("default", 3 * MIB + 256, True), ("default", 4_161_280, True),
         ("default", 4_161_280 + 256, False), ("default", 4 * MIB, False),
         ("high", 1_572_864, True), ("high", 2_064_128, True), ("high", 2 * MIB, False),
         ("default_lr_global_64", 2 * MIB, True), ("rle", 3_000_000, True),
         ("turbo", 4 * MIB - 16, True), ("fast", 4 * MIB, True), ("fast", 4 * MIB + 16, True)]


@pytest.mark.parametrize("name,E,taken", PAIRS)
def test_check_chunk_size_follows_jax(name, E, taken):
    assert _jax_takes(name, E) == taken
    opts = tcorpus._resolve(_options(dt, name))
    if taken:
        tcorpus.check_chunk_size(E, opts)
    else:
        with pytest.raises(ValueError):
            tcorpus.check_chunk_size(E, opts)


@functools.lru_cache(maxsize=None)
def _jax_stream(preset: str) -> bytes:
    return jcorpus.compress_corpus(inputs("salad_4m"), getattr(dj.CompressionOptions, preset)(),
                                   batch_size=1, chunk_size=4 * MIB).deflate


@pytest.mark.parametrize("preset", ["fast", "rle"])
def test_fast_and_rle_at_4mib_equal_jax(preset):
    data = inputs("salad_4m")
    got = tcorpus.compress_corpus(data, getattr(dt.CompressionOptions, preset)(),
                                  chunk_size=4 * MIB, **CPU).deflate
    assert got == _jax_stream(preset)
    assert zlib.decompress(got, wbits=-15) == data


def test_stored_4mib_chunk_byte_aligned_round_trips():
    """A stored chunk of 4 MiB (random bytes) and a short text chunk behind
    it at fast, ``packed=False``: whole rows, stored fields packed on the
    device, each chunk byte-aligned behind a sync marker (port only)."""
    data = (np.random.default_rng(9).integers(0, 256, 4 * MIB, dtype=np.uint8).tobytes()
            + inputs("salad_4m")[:100_000])
    got = tcorpus.compress_corpus(data, dt.CompressionOptions.fast(), chunk_size=4 * MIB,
                                  packed=False, **CPU).deflate
    assert got[0] & 0b111 == 0  # not final, stored
    assert 4 * MIB < len(got) < len(data)
    assert zlib.decompress(got, wbits=-15) == data


@pytest.mark.parametrize("size", [2 * MIB, 4 * MIB])
@pytest.mark.parametrize("preset", ["huffman_only", "turbo"])
def test_one_byte_value_round_trips(preset, size):
    """One litlen symbol of frequency 2**21 or 2**22 and EOB: a dynamic or
    fixed block that inflates to the input (port only)."""
    data = b"a" * size
    got = tcorpus.compress_corpus(data, getattr(dt.CompressionOptions, preset)(),
                                  chunk_size=size, **CPU).deflate
    assert len(got) < size // 7
    assert zlib.decompress(got, wbits=-15) == data
    assert inflate(got) == data


@pytest.mark.parametrize("name", WIDE_LEAF_CASES)
def test_wide_leaves_satisfy_kraft_exactly(name):
    freqs = dict((c[0], c[1]) for c in package_merge_cases())[name]
    assert (freqs.sum(axis=1) <= MAX_ROW_SUM).all() and freqs.max() >= 1 << 21
    lengths = package_merge_rows(torch.from_numpy(freqs), 15).numpy()
    for f, n in zip(freqs, lengths):
        assert ((n > 0) == (f > 0)).all() and n.max() <= 15
        assert sum(Fraction(1, 1 << int(x)) for x in n if x) == 1


@pytest.mark.parametrize("E,batch", [(65536, 64), (MIB, 64), (MIB + 16 * 4096, 60),
                                     (2 * MIB, 32), (4_161_280, 16), (4 * MIB, 16)])
def test_default_batch_holds_64_mib(E, batch):
    assert tcorpus.default_batch_size(E) == batch


@pytest.mark.parametrize("batch_size,want", [(None, 32), (3, 3)])
def test_compress_corpus_batches_by_the_rule_unless_told(batch_size, want):
    """The pipeline a call borrows is sized by the default rule at 2 MiB,
    or by the caller's ``batch_size``."""
    data = b"abc" * 1000
    got = tcorpus.compress_corpus(data, dt.CompressionOptions.huffman_only(),
                                  chunk_size=2 * MIB, batch_size=batch_size, **CPU)
    key, pipe = tcorpus._pipelines[-1]
    assert key[1] == 2 * MIB and pipe.batch_size == want
    assert zlib.decompress(got.deflate, wbits=-15) == data


def test_dryrun_one_rank_above_64k_equals_the_corpus_engine():
    """The dry run's rank builds the sharded encoder with the corpus engine's
    options at its chunk size, so its file equals the one-shot bytes at
    chunks of 128 KiB (one spawned gloo rank)."""
    s = dryrun_multichip(1, emit=131072, device="cpu")
    assert s["chunks"] == 4 and s["emit"] == 131072
    assert 0 in s["block_types"]  # a stored chunk
