"""The rules of the corpus engine at chunk sizes from 4 MiB to 16 MiB.

``check_chunk_size`` against what the JAX package's ``compress_corpus``
traces (``jax.eval_shape`` of its batch encoder: the refusals are its
trace-time asserts) at the boundaries of each rule, the long-range pass at
a raised ``dom_segs`` included, and the port's cap at 16 MiB; the default
batch by chunk size; the JAX package's fault on text at 8 and 16 MiB pinned
at row level (its package-merge gives a symbol of frequency 2**20 or more
no code) beside the port's complete code, and the port's stream of such a
16 MiB chunk, which round-trips; one byte value at 16 MiB (a litlen leaf of
2**24); the sharded encoder's refusals.  Tolerance: exact equality.
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
from deflate_rs_tpu.ops.package_merge import package_merge_lengths  # noqa: E402
from deflate_rs_tpu.parallel import corpus as jcorpus  # noqa: E402
from deflate_rs_tpu_torch.ops.package_merge import MAX_ROW_SUM, package_merge_rows  # noqa: E402
from deflate_rs_tpu_torch.parallel import corpus as tcorpus  # noqa: E402
from deflate_rs_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from deflate_rs_tpu_torch.parallel.sharded import make_sharded_encoder  # noqa: E402
from torch_corpus_data import inputs  # noqa: E402

CPU = {"device": "cpu"}
MIB = 1 << 20
HALO = 32768


def _options(pkg, name: str):
    """A preset, or ``<preset>_segs<S>``: the preset with ``dom_segs=S``."""
    preset, _, segs = name.partition("_segs")
    o = getattr(pkg.CompressionOptions, preset)()
    return dataclasses.replace(o, dom_segs=int(segs)) if segs else o


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


# (options, chunk size, taken by the JAX package).  The presets without a
# long-range pass up to the cap and one past it (the port's cap, which the
# JAX package does not have); Default and high at their own segments past
# their ends;
# Default at 256 segments at its widest chunk (harvest rows of 32,766) and
# the next size whose chunk and history divide into whole words (rows of
# 32,768); Default and high at 512 segments, the cap's chunk and a size that
# does not divide; Default at 1,024 segments (the local pass's block path on
# the card).
PAIRS = [("fast", 8 * MIB, True), ("fast", 16 * MIB, True), ("fast", 16 * MIB + 16, True),
         ("rle", 12 * MIB + 16, True), ("huffman_only", 16 * MIB, True),
         ("turbo", 16 * MIB - 16, True), ("default", 8 * MIB, False), ("high", 8 * MIB, False),
         ("default_segs256", 16_743_424, True), ("default_segs256", 16_744_448, False),
         ("default_segs512", 16 * MIB, True), ("default_segs512", 16 * MIB - 1024, False),
         ("high_segs512", 16 * MIB, True), ("default_segs1024", 16 * MIB, True),
         ("default_segs512", 16 * MIB + 2048, True)]


@pytest.mark.parametrize("name,E,taken", PAIRS)
def test_check_chunk_size_follows_jax(name, E, taken):
    assert _jax_takes(name, E) == taken
    opts = tcorpus._resolve(_options(dt, name))
    if E > tcorpus.MAX_CHUNK_SIZE:  # the port's cap: above it, the JAX package only
        with pytest.raises(ValueError, match="at most 16777216"):
            tcorpus.check_chunk_size(E, opts)
    elif taken:
        tcorpus.check_chunk_size(E, opts)
    else:
        with pytest.raises(ValueError):
            tcorpus.check_chunk_size(E, opts)


@pytest.mark.parametrize("E,batch", [(4 * MIB + 16, 15), (8 * MIB, 8), (12 * MIB + 16, 5),
                                     (16 * MIB - 16, 4), (16 * MIB, 4)])
def test_default_batch_holds_64_mib(E, batch):
    assert tcorpus.default_batch_size(E) == batch


def _kraft(lengths) -> Fraction:
    return sum(Fraction(1, 1 << int(x)) for x in lengths if x)


# The litlen symbols of pg11 repeated to 8 and 16 MiB that reach a frequency
# of 2**20 in one block of the whole chunk (its bytes and EOB): the space, and
# at 16 MiB also "e" and "t".  The JAX package's XLA package-merge gives each
# of them length 0 (its int32 key ``f * 512 + sym`` passes the unused
# symbols' ``2**29 + s``); its code then leaves part of Kraft's sum unused,
# and the stream's dynamic header is one zlib rejects.
JAX_DROPS_ON_TEXT = {"pg11_8m": ((32,), Fraction(7, 8)),
                     "pg11_16m": ((32, 101, 116), Fraction(11, 16))}


@pytest.mark.parametrize("name", list(JAX_DROPS_ON_TEXT))
def test_jax_package_merge_drops_the_commonest_text_symbols(name):
    data = inputs(name)
    freqs = np.zeros(286, np.int32)
    freqs[:256] = np.bincount(np.frombuffer(data, np.uint8), minlength=256)
    freqs[256] = 1
    assert freqs.sum() <= MAX_ROW_SUM
    dropped, kraft = JAX_DROPS_ON_TEXT[name]
    assert tuple(np.flatnonzero(freqs >= 1 << 20)) == dropped
    want = np.asarray(package_merge_lengths(jnp.asarray(freqs), 15))
    got = package_merge_rows(torch.from_numpy(freqs[None]), 15)[0].numpy()
    assert tuple(np.flatnonzero(want != got)) == dropped
    assert (want[list(dropped)] == 0).all() and _kraft(want) == kraft
    assert ((got > 0) == (freqs > 0)).all() and got.max() <= 15 and _kraft(got) == 1


@functools.lru_cache(maxsize=None)
def _port(name: str, preset: str) -> bytes:
    return tcorpus.compress_corpus(inputs(name), getattr(dt.CompressionOptions, preset)(),
                                   chunk_size=16 * MIB, **CPU).deflate


def test_huffman_only_16mib_on_text_round_trips():
    """One block of pg11 repeated to 16 MiB gives three litlen symbols more
    than 2**20 literals each: the port's stream inflates to the input through
    zlib (the JAX package's does not, pinned above)."""
    data = inputs("pg11_16m")
    got = _port("pg11_16m", "huffman_only")
    assert zlib.decompress(got, wbits=-15) == data


@pytest.mark.parametrize("preset", ["huffman_only", "turbo"])
def test_one_byte_value_at_16mib_round_trips(preset):
    """One litlen symbol of frequency 2**24 and EOB, a row of package-merge's
    ``MAX_ROW_SUM``: a dynamic or fixed block that inflates to the input
    (port only)."""
    data = b"a" * (16 * MIB)
    got = tcorpus.compress_corpus(data, getattr(dt.CompressionOptions, preset)(),
                                  chunk_size=16 * MIB, **CPU).deflate
    assert len(got) < len(data) // 7
    assert zlib.decompress(got, wbits=-15) == data


@pytest.mark.parametrize("name,E", [("default", 8 * MIB), ("fast", 16 * MIB + 16),
                                    ("default_segs256", 16 * MIB)])
def test_sharded_refuses_what_the_corpus_engine_refuses(name, E):
    with pytest.raises(ValueError, match="long-range pass|at most 16777216"):
        make_sharded_encoder(make_mesh(device="cpu"), _options(dt, name), E)
