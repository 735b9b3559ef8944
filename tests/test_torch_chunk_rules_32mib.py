"""The rules of the corpus engine at chunk sizes from 16 MiB to 32 MiB.

``check_chunk_size`` against what the JAX package's ``compress_corpus``
traces (``jax.eval_shape`` of its batch encoder: the refusals are its
trace-time asserts) at the boundaries of each rule, the long-range pass at
512, 1,024 and 2,048 segments included, and the port's cap at 32 MiB, which
the JAX package does not have; ``compress_corpus`` and
``make_sharded_encoder`` refuse the same sizes at the entry.  The default
batch by chunk size; the JAX package's fault on text at 32 MiB pinned at row
level (its package-merge gives nine of the ten symbols of frequency 2**20 or
more no code and misranks others) beside the port's complete code.
Tolerance: exact equality.
"""

import dataclasses
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
from deflate_rs_tpu_torch.ops import lr_kernel  # noqa: E402
from deflate_rs_tpu_torch.ops.package_merge import MAX_ROW_SUM, package_merge_rows  # noqa: E402
from deflate_rs_tpu_torch.parallel import corpus as tcorpus  # noqa: E402
from deflate_rs_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from deflate_rs_tpu_torch.parallel.sharded import make_sharded_encoder  # noqa: E402
from torch_corpus_data import inputs  # noqa: E402

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
# long-range pass up to the cap, and past it at 32 MiB + 16 and 64 MiB (the
# port's cap); Default and high at their own segments; Default at 512
# segments at its widest chunk (harvest rows of 32,766), the next size whose
# chunk and history divide into whole words (rows of 32,768) and the cap;
# Default at 1,024 segments at the cap (the local pass on lr_measure's tiled
# path), a size that does not divide and the next one below that does; high
# at 1,024 and Default at 2,048 segments at the cap (the block path).
PAIRS = [("fast", 24 * MIB, True), ("fast", 32 * MIB, True), ("fast", 32 * MIB + 16, True),
         ("fast", 64 * MIB, True), ("rle", 24 * MIB + 16, True),
         ("huffman_only", 32 * MIB, True), ("huffman_only", 32 * MIB + 256, True),
         ("turbo", 32 * MIB - 16, True), ("default", 32 * MIB, False),
         ("high", 32 * MIB, False), ("default_segs512", 33_519_616, True),
         ("default_segs512", 33_521_664, False), ("default_segs512", 32 * MIB, False),
         ("default_segs1024", 32 * MIB, True), ("default_segs1024", 32 * MIB - 2048, False),
         ("default_segs1024", 32 * MIB - 4096, True), ("high_segs1024", 32 * MIB, True),
         ("default_segs2048", 32 * MIB, True)]


@pytest.mark.parametrize("name,E,taken", PAIRS)
def test_check_chunk_size_follows_jax(name, E, taken):
    """The port takes a size exactly where the JAX package traces it, up
    to the cap; compress_corpus and the sharded encoder refuse the others
    at the entry (before any encode)."""
    assert _jax_takes(name, E) == taken
    opts = tcorpus._resolve(_options(dt, name))
    match = "at most 33554432" if E > tcorpus.MAX_CHUNK_SIZE else "long-range pass"
    if taken and E <= tcorpus.MAX_CHUNK_SIZE:
        tcorpus.check_chunk_size(E, opts)
        return
    with pytest.raises(ValueError, match=match):
        tcorpus.check_chunk_size(E, opts)
    with pytest.raises(ValueError, match=match):
        tcorpus.compress_corpus(b"abc", opts, chunk_size=E, device="cpu")
    with pytest.raises(ValueError, match=match):
        make_sharded_encoder(make_mesh(device="cpu"), opts, E)


@pytest.mark.parametrize("name,tiled", [("default_segs1024", True), ("high_segs1024", True),
                                        ("default_segs2048", False)])
def test_long_range_path_at_the_cap(name, tiled):
    """Which path of ``lr_measure.cu`` the local pass takes at 32 MiB:
    windows of 8,267 words at 1,024 segments pass the block path's
    ``MAX_WINDOW_WORDS``; 4,167 at 2,048 do not."""
    o = tcorpus._resolve(_options(dt, name))
    words = lr_kernel.window_words(HALO + 32 * MIB, o.resolved_dom_segs)
    assert words == (8267 if tiled else 4167)
    assert (words > lr_kernel.MAX_WINDOW_WORDS) == tiled


@pytest.mark.parametrize("E,batch", [(16 * MIB + 16, 3), (24 * MIB + 16, 2),
                                     (32 * MIB - 16, 2), (32 * MIB, 2)])
def test_default_batch_holds_64_mib(E, batch):
    assert tcorpus.default_batch_size(E) == batch


def test_chain_scale_at_the_cap():
    """Above 64 KiB the matcher's chain budget scales with the chunk: 512
    at 32 MiB, as in the JAX package's compress_corpus."""
    o = tcorpus.chunk_options(tcorpus._resolve(dt.CompressionOptions.fast()), 32 * MIB)
    assert o.chain_scale == 512


def _kraft(lengths) -> Fraction:
    return sum(Fraction(1, 1 << int(x)) for x in lengths if x)


# The litlen row of pg11 repeated to one 32 MiB chunk (its bytes and EOB, a
# row of ``MAX_ROW_SUM``): ten symbols reach 2**20.  The JAX package's XLA
# package-merge (its int32 key ``f * 512 + sym`` wraps) gives nine of them
# length 0 and misranks the space and ten other symbols; its code then uses
# three eighths of Kraft's sum, and the stream's dynamic header is one zlib
# rejects.
TEXT_32M_WIDE = (32, 97, 101, 104, 105, 110, 111, 114, 115, 116)
JAX_DROPS_32M = (97, 101, 104, 105, 110, 111, 114, 115, 116)
JAX_MISRANKS_32M = {13: 5, 32: 15, 42: 10, 47: 12, 53: 13, 69: 8, 73: 7, 77: 9, 86: 11,
                    88: 14, 112: 6}


def test_jax_package_merge_fails_on_32mib_of_text():
    data = inputs("pg11_32m")
    freqs = np.zeros(286, np.int32)
    freqs[:256] = np.bincount(np.frombuffer(data, np.uint8), minlength=256)
    freqs[256] = 1
    assert freqs.sum() == MAX_ROW_SUM
    assert tuple(np.flatnonzero(freqs >= 1 << 20)) == TEXT_32M_WIDE
    want = np.asarray(package_merge_lengths(jnp.asarray(freqs), 15))
    got = package_merge_rows(torch.from_numpy(freqs[None]), 15)[0].numpy()
    differ = np.flatnonzero(want != got)
    assert tuple(differ) == tuple(sorted(JAX_DROPS_32M + tuple(JAX_MISRANKS_32M)))
    assert (want[list(JAX_DROPS_32M)] == 0).all()
    assert {int(s): int(want[s]) for s in JAX_MISRANKS_32M} == JAX_MISRANKS_32M
    assert _kraft(want) == Fraction(3, 8)
    assert ((got > 0) == (freqs > 0)).all() and got.max() <= 15 and _kraft(got) == 1
