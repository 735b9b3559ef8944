"""The corpus engine and the sharded encoder at the chunk sizes above
256 KiB, against the JAX package's bytes: Default at 512 KiB and 1 MiB (raw,
and the zlib framing at 1 MiB), high at 512 KiB, the cap above 16 MiB, and the
sharded encoder at two gloo ranks with chunks of 4,112 bytes at fast.  The
inputs mix text, random bytes, runs and records
(``tests/torch_corpus_data.py``); each JAX stream is computed once.  The
grid of presets at chunks below 32 KiB is ``tests/test_torch_chunk_grid.py``.
Tolerance: exact equality.
"""

import functools
import zlib

import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
# The suite runs several workers on one machine: one intra-op thread per
# worker keeps the port's many small ops from oversubscribing the cores.
torch.set_num_threads(1)

import deflate_rs_tpu as dj  # noqa: E402
import deflate_rs_tpu_torch as dt  # noqa: E402
from deflate_rs_tpu.parallel import corpus as jcorpus  # noqa: E402
from deflate_rs_tpu_torch import constants as C  # noqa: E402
from deflate_rs_tpu_torch.parallel import corpus as tcorpus  # noqa: E402
from deflate_rs_tpu_torch.parallel.sharded import assemble_host  # noqa: E402
from deflate_rs_tpu_torch.tools.dryrun_multichip import build_batch, spawn_ranks  # noqa: E402
from torch_corpus_data import inputs  # noqa: E402
from torch_sharded_ranks import emit_case, pad_to_multiple  # noqa: E402

CPU = {"device": "cpu"}
# (name, preset, chunk size, input): the input cut so that every size has
# a short last chunk behind two or more full ones.
WIDE_CASES = {
    "default_512k": ("default", 524_288, slice(None)),
    "default_1m": ("default", 1_048_576, slice(None)),
    "high_512k": ("high", 524_288, slice(400_000, 1_120_000)),
}


def _data(name: str) -> bytes:
    return inputs("wide_mix")[WIDE_CASES[name][2]]


@functools.lru_cache(maxsize=None)
def _jax(name: str):
    preset, E, _ = WIDE_CASES[name]
    return jcorpus.compress_corpus(_data(name), getattr(dj.CompressionOptions, preset)(),
                                   batch_size=2, chunk_size=E)


@functools.lru_cache(maxsize=None)
def _port(name: str):
    preset, E, _ = WIDE_CASES[name]
    return tcorpus.compress_corpus(_data(name), getattr(dt.CompressionOptions, preset)(),
                                   batch_size=2, chunk_size=E, **CPU)


@pytest.mark.parametrize("name", list(WIDE_CASES))
def test_wide_chunks_equal_jax(name):
    got, want = _port(name), _jax(name)
    assert got.deflate == want.deflate
    assert zlib.decompress(got.deflate, wbits=-15) == _data(name)
    assert got.fetched["batches"] == -(-len(_data(name)) // WIDE_CASES[name][1] // 2)


def test_wide_chunks_zlib_framing_equals_jax():
    """Header, 1 MiB chunks and Adler-32 trailer, as the JAX results frame them."""
    got, want = _port("default_1m"), _jax("default_1m")
    frame = [C.zlib_header() + r.deflate + r.adler.to_bytes(4, "big") for r in (got, want)]
    assert frame[0] == frame[1]
    assert zlib.decompress(frame[0]) == _data("default_1m")


@pytest.mark.parametrize("E", [33_554_432 + 256, 33_554_432 + 16, 64 << 20])
def test_above_the_cap_raises_at_the_entry(E):
    with pytest.raises(ValueError, match="at most 33554432"):
        tcorpus.compress_corpus(b"abc", chunk_size=E, **CPU)


@pytest.mark.parametrize("preset", ["fast", "huffman_only"])
def test_the_old_cap_plus_16_is_taken(preset):
    """16 MiB + 16, past the cap until 32 MiB chunks, is a size the presets
    without a long-range pass take, as the JAX package does."""
    tcorpus.check_chunk_size(16_777_216 + 16,
                             tcorpus._resolve(getattr(dt.CompressionOptions, preset)()))


def test_sharded_two_ranks_at_4112_fast_equal_jax():
    """Two spawned gloo ranks, 16 chunks of 4,112 bytes (a last partial
    segment in the parse) at fast: the packed splice equals the JAX corpus
    engine's bytes at that chunk size."""
    E, world = 4112, 2
    data = inputs("small_mix")
    shards = spawn_ranks(emit_case, world, (data, E, "fast"), device="cpu")
    (_, _, ns, lasts), B = pad_to_multiple(build_batch(data, E), world)
    payloads = [data[i * E : i * E + int(ns[i])] for i in range(B)]
    got = assemble_host(shards, B, packed=True, payloads=payloads, is_lasts=lasts[:B])
    want = jcorpus.compress_corpus(data, dj.CompressionOptions.fast(), batch_size=4,
                                   chunk_size=E).deflate
    assert got == want
    assert zlib.decompress(got, wbits=-15) == data
