"""Package-merge at a symbol frequency of 2**20: a 1 MiB chunk of one byte
value at huffman_only or turbo (no match search) gives one litlen symbol
that frequency.  The port's code lengths against the JAX package's
``package_merge_lengths`` (its XLA form), and the corpus engine at 1 MiB
chunks against the JAX package's bytes.  Tolerance: exact equality.

The reference drops the symbol where unused symbols sort below it (2**20 on
any symbol but 0): it gives the symbol length 0, and on 1 MiB of ``b"a"`` it
writes 12 bytes that inflate to nothing.  The port keeps the symbol; that
row is pinned here as the recorded difference.
"""

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
from deflate_rs_tpu.ops.package_merge import package_merge_lengths as j_lengths  # noqa: E402
from deflate_rs_tpu.parallel import corpus as jcorpus  # noqa: E402
from deflate_rs_tpu_torch.models.inflate import inflate  # noqa: E402
from deflate_rs_tpu_torch.ops.package_merge import (  # noqa: E402
    package_merge_lengths, package_merge_rows)
from deflate_rs_tpu_torch.parallel import corpus as tcorpus  # noqa: E402
from torch_corpus_data import pg11  # noqa: E402

MIB = 1 << 20
EOB = 256
# The symbols that carry 2**20; EOB carries 1.  0 is the one the reference
# gets right; 97 is b"a"; 255 and 285 sit just below and at the top.
HOT = (0, 1, 97, 255, 285)


def _row(hot: int) -> np.ndarray:
    f = np.zeros(286, np.int32)
    f[hot] = MIB
    f[EOB] = 1
    return f


@functools.lru_cache(maxsize=None)
def _jax_rows() -> np.ndarray:
    rows = jnp.asarray(np.stack([_row(h) for h in HOT]))
    return np.asarray(jax.jit(jax.vmap(functools.partial(j_lengths, max_len=15)))(rows))


def _used(lengths) -> dict:
    return {int(s): int(lengths[s]) for s in np.nonzero(lengths)[0]}


@pytest.mark.parametrize("hot", HOT)
def test_rows_against_jax(hot):
    """On symbol 0 the port equals the reference; above it the reference
    gives the hot symbol length 0 and the port length 1."""
    want = _jax_rows()[HOT.index(hot)]
    f = torch.from_numpy(_row(hot))
    got = package_merge_rows(f[None], 15)[0].numpy()
    np.testing.assert_array_equal(package_merge_lengths(f, 15).numpy(), got)
    assert _used(got) == {hot: 1, EOB: 1}
    if hot == 0:
        np.testing.assert_array_equal(got, want)
    else:
        assert _used(want) == {EOB: 1}


@pytest.mark.parametrize("hot", HOT)
def test_rows_satisfy_kraft_exactly(hot):
    lengths = package_merge_rows(torch.from_numpy(_row(hot))[None], 15)[0].numpy()
    assert sum(Fraction(1, 1 << int(n)) for n in lengths if n) == 1


def _text_zeros_text() -> bytes:
    text = pg11() * (-(-MIB // len(pg11())))
    return text[:MIB] + bytes(MIB) + text[: MIB // 2]


@functools.lru_cache(maxsize=None)
def _jax_stream() -> bytes:
    # One JAX run: on this input its huffman_only and turbo streams are the
    # same bytes (each chunk one dynamic block; huffman_only's split keeps
    # every chunk whole here), 1,051,819 B.
    return jcorpus.compress_corpus(_text_zeros_text(), dj.CompressionOptions.huffman_only(),
                                   batch_size=1, chunk_size=MIB).deflate


@pytest.mark.parametrize("preset", ["huffman_only", "turbo"])
def test_corpus_text_and_a_zero_mib_equal_jax(preset):
    data = _text_zeros_text()
    got = tcorpus.compress_corpus(data, getattr(dt.CompressionOptions, preset)(),
                                  chunk_size=MIB, device="cpu").deflate
    assert got == _jax_stream()
    assert len(got) == 1_051_819
    assert zlib.decompress(got, wbits=-15) == data


@pytest.mark.parametrize("preset", ["huffman_only", "turbo"])
def test_corpus_a_mib_of_one_byte_round_trips(preset):
    """Port only: the reference's 12 B stream of this input inflates to
    nothing."""
    data = b"a" * MIB
    got = tcorpus.compress_corpus(data, getattr(dt.CompressionOptions, preset)(),
                                  chunk_size=MIB, device="cpu").deflate
    assert len(got) == 131_085
    assert zlib.decompress(got, wbits=-15) == data
    assert inflate(got) == data
