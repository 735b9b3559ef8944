"""The corpus engine and the sharded encoder at 8 MiB, against the JAX
package's whole streams: fast on pg11 repeated to one 8 MiB chunk (the JAX
stream is valid, 3,396,833 B), and huffman_only on it, where one block gives
the space more than 2**20 literals and the JAX stream is one zlib rejects
(its package-merge key reaches ``2**29`` and the leaf loses its code) while
the port's round-trips.  Each JAX stream is computed once, one chunk a
batch (a JAX stream at 8 MiB takes about 10-11 GB and 16-32 s); every JAX
stream of 8 MiB lives in this file, so no two run at once.  Tolerance:
exact equality.
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
from deflate_rs_tpu_torch.models.inflate import inflate  # noqa: E402
from deflate_rs_tpu_torch.parallel import corpus as tcorpus  # noqa: E402
from deflate_rs_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from deflate_rs_tpu_torch.parallel.sharded import assemble_host, make_sharded_encoder  # noqa: E402
from deflate_rs_tpu_torch.tools.dryrun_multichip import build_batch  # noqa: E402
from torch_corpus_data import inputs  # noqa: E402

CPU = {"device": "cpu"}
E = 8 << 20
FAST_8M_BYTES = 3_396_833  # the JAX package's fast stream of pg11_8m


@functools.lru_cache(maxsize=None)
def _jax(preset: str) -> bytes:
    return jcorpus.compress_corpus(inputs("pg11_8m"), getattr(dj.CompressionOptions, preset)(),
                                   batch_size=1, chunk_size=E).deflate


@functools.lru_cache(maxsize=None)
def _port(preset: str) -> bytes:
    return tcorpus.compress_corpus(inputs("pg11_8m"), getattr(dt.CompressionOptions, preset)(),
                                   chunk_size=E, **CPU).deflate


def test_fast_8mib_on_text_equals_jax():
    got = _port("fast")
    assert len(got) == FAST_8M_BYTES
    assert got == _jax("fast")
    assert zlib.decompress(got, wbits=-15) == inputs("pg11_8m")


def test_huffman_only_8mib_on_text_round_trips_where_jax_does_not():
    """The recorded difference: the JAX stream's dynamic header gives the
    space no code (zlib: "invalid literal/lengths set"); the port's stream
    inflates to the input through zlib and the port's decoder."""
    data = inputs("pg11_8m")
    assert data.count(b" ") >= 1 << 20
    with pytest.raises(zlib.error, match="invalid literal/lengths set"):
        zlib.decompress(_jax("huffman_only"), wbits=-15)
    got = _port("huffman_only")
    assert got != _jax("huffman_only")
    assert zlib.decompress(got, wbits=-15) == data
    assert inflate(got) == data


def test_sharded_world_size_one_at_8mib_equals_jax():
    """The sharded step at world size 1 (no process group) with the corpus
    engine's options at 8 MiB: its packed splice is the JAX stream."""
    data = inputs("pg11_8m")
    options = tcorpus.chunk_options(dt.CompressionOptions.fast(), E)
    assert options.chain_scale == 128
    step = make_sharded_encoder(make_mesh(device="cpu"), options, E)
    bufs, hist, ns, lasts = build_batch(data, E)
    shard = step(bufs, hist, ns, lasts)
    got = assemble_host(shard, packed=True, payloads=[data], is_lasts=lasts)
    assert got == _jax("fast")
