"""The corpus engine and the sharded encoder at chunk sizes from 2 MiB to
4 MiB, against the JAX package's bytes: Default at 2 MiB on a stored chunk
of random bytes and a text chunk behind it (range totals past 1,048,641,
where the block-split proxy's switch table and its float32 sums take over
from the exact count), Default at 4,161,280 (the widest chunk its long-range
pass takes) on word-salad text, and the sharded encoder at world size 1 on
the 2 MiB case.  Each JAX stream is computed once, one chunk a batch.
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
from deflate_rs_tpu_torch.parallel import corpus as tcorpus  # noqa: E402
from deflate_rs_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from deflate_rs_tpu_torch.parallel.sharded import assemble_host, make_sharded_encoder  # noqa: E402
from deflate_rs_tpu_torch.tools.dryrun_multichip import build_batch  # noqa: E402
from torch_corpus_data import inputs  # noqa: E402

CPU = {"device": "cpu"}
# name -> (preset, chunk size, input)
CASES = {
    "default_2m": ("default", 2_097_152, "stored_then_text"),
    "default_4161280": ("default", 4_161_280, "salad_4m"),
}


def _data(name: str) -> bytes:
    _, E, which = CASES[name]
    return inputs(which)[:E] if name == "default_4161280" else inputs(which)


@functools.lru_cache(maxsize=None)
def _jax(name: str) -> bytes:
    preset, E, _ = CASES[name]
    return jcorpus.compress_corpus(_data(name), getattr(dj.CompressionOptions, preset)(),
                                   batch_size=1, chunk_size=E).deflate


@functools.lru_cache(maxsize=None)
def _port(name: str):
    preset, E, _ = CASES[name]
    return tcorpus.compress_corpus(_data(name), getattr(dt.CompressionOptions, preset)(),
                                   chunk_size=E, **CPU)


@pytest.mark.parametrize("name", list(CASES))
def test_wide_chunks_equal_jax(name):
    got = _port(name)
    assert got.deflate == _jax(name)
    assert zlib.decompress(got.deflate, wbits=-15) == _data(name)
    assert got.fetched["batches"] == 1  # the default batch holds every chunk


def test_stored_chunk_of_2mib_leads_the_stream():
    """The first chunk, 2 MiB of random bytes, is stored (BTYPE 00 in the
    stream's first bits), its block of 2**21 literals scored through the
    widened proxy; the text chunk behind it is not."""
    got = _port("default_2m").deflate
    assert got[0] & 0b111 == 0  # not final, stored
    assert len(got) < len(_data("default_2m")) - 500_000


def test_sharded_world_size_one_at_2mib_equals_corpus_bytes():
    """The sharded step at world size 1 (no process group) with the corpus
    engine's options at 2 MiB: its packed splice is the JAX stream."""
    preset, E, _ = CASES["default_2m"]
    data = _data("default_2m")
    options = tcorpus.chunk_options(getattr(dt.CompressionOptions, preset)(), E)
    assert options.chain_scale == 32
    step = make_sharded_encoder(make_mesh(device="cpu"), options, E)
    bufs, hist, ns, lasts = build_batch(data, E)
    shard = step(bufs, hist, ns, lasts)
    payloads = [data[i * E : i * E + int(ns[i])] for i in range(len(ns))]
    got = assemble_host(shard, packed=True, payloads=payloads, is_lasts=lasts)
    assert got == _jax("default_2m")


@pytest.mark.parametrize("E", [4_194_304, 4_161_280 + 256])
def test_sharded_refuses_what_default_does_not_take(E):
    with pytest.raises(ValueError, match="long-range pass"):
        make_sharded_encoder(make_mesh(device="cpu"), dt.CompressionOptions.default(), E)
