"""Inputs shared by the port's tests, and the JAX corpus engine's streams of
them, each made once per test process.

``inputs(name)`` gives a seeded input: "mix" (pg11 with random bytes between,
so several block types share a batch), "all_stored", "dense" (about 6 bits a
byte), "mixed_tail" (stored, text and runs with an odd tail),
"repeated_text", "wide_mix" (1.1 MB of repeated text, random bytes, runs and
records: two chunks of 1 MiB, three of 512 KiB), "small_mix" (64 KiB of
text, random bytes and runs), "salad_4m" (4 MiB of pg11's words in a seeded
Zipf order: text that repeats little at long range) and "stored_then_text"
(2 MiB of random bytes, then 1,000,000 B of that text: a stored chunk of
2 MiB and a text chunk behind it), "pg11_8m" and "pg11_16m" (pg11 repeated
to one chunk of 8 or 16 MiB: text on which one block gives the space more
than 2**20 literals) and "spread_16m" (16 MiB of seeded bytes on which no
symbol of a block reaches 2**20, ``deflate_rs_tpu_torch.utils.mix.spread``).  ``jax_stream`` is ``deflate_rs_tpu.parallel.corpus``'s raw
stream of one of them, ``jax_preset_stream`` the same at a preset (or the
exception it raised), and ``check_against_jax`` holds the port's corpus
engine to it.  Importing this module imports no JAX.
"""

import functools
import os

import numpy as np

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


@functools.lru_cache(maxsize=None)
def pg11() -> bytes:
    with open(os.path.join(DATA, "pg11.txt"), "rb") as f:
        return f.read()


def word_salad(n: int, seed: int) -> bytes:
    """``n`` bytes of pg11's words, drawn in a Zipf order of their first
    appearance, one space between."""
    words = list(dict.fromkeys(pg11().split()))
    rng = np.random.default_rng(seed)
    pick = (rng.zipf(1.2, n // 3) - 1) % len(words)
    return b" ".join(words[i] for i in pick)[:n]


@functools.lru_cache(maxsize=None)
def inputs(name: str) -> bytes:
    pg = pg11()
    if name == "mix":  # binary mixed in, so several block types share a batch
        rng = np.random.default_rng(0)
        return pg + rng.integers(0, 256, 80_000, dtype=np.uint8).tobytes() + pg[:50_000]
    rng = np.random.default_rng(7)
    rand = rng.integers(0, 256, 3 * 65536, dtype=np.uint8).tobytes()
    if name == "all_stored":  # no word of the compacted buffer is used
        return rand
    if name == "dense":  # ~6 bits a byte: more than half of the buffer is used
        return rng.integers(0, 64, 4 * 65536, dtype=np.uint8).tobytes()
    if name == "mixed_tail":  # stored, text and runs in one batch, odd tail
        return rand[:65536] + pg[:100_000] + b"\x00" * 70_000 + rand[:12_345]
    if name == "repeated_text":
        return (pg * 4)[:600_000]
    if name == "wide_mix":
        records = b"".join(b"id=%07d;name=%s;" % (i, pg[i % 5000 : i % 5000 + 12])
                           for i in range(4000))
        return ((pg * 4)[:600_000] + rand[:150_000] + b"\x00" * 90_000 + records
                + pg[:200_000])[:1_150_000]
    if name == "salad_4m":
        return word_salad(4 << 20, 3)
    if name == "stored_then_text":
        return (np.random.default_rng(4).integers(0, 256, 2 << 20, dtype=np.uint8).tobytes()
                + word_salad(1_000_000, 4))
    if name in ("pg11_8m", "pg11_16m"):
        n = (8 if name == "pg11_8m" else 16) << 20
        return (pg * (n // len(pg) + 1))[:n]
    if name == "spread_16m":
        from deflate_rs_tpu_torch.utils.mix import spread

        return spread(16 << 20)
    if name == "small_mix":
        return (pg[:30_000] + rand[:12_000] + b"\x00" * 6_000 + b"ab" * 2_000
                + pg[60_000:73_536])
    raise ValueError(name)


@functools.lru_cache(maxsize=None)
def jax_stream(name: str, batch_size: int, chunk_size: int = 65536, packed: bool = True) -> bytes:
    from deflate_rs_tpu.parallel import corpus as jcorpus

    return jcorpus.compress_corpus(inputs(name), batch_size=batch_size, chunk_size=chunk_size,
                                   packed=packed).deflate


PRESETS = ("default", "high", "fast", "rle", "huffman_only", "turbo", "ForceFixed", "ForceStored")


def preset_options(pkg, preset: str):
    """``pkg.CompressionOptions`` of a name of ``PRESETS`` (``pkg``: either
    package)."""
    if preset.startswith("Force"):
        return pkg.CompressionOptions(special=getattr(pkg.SpecialOptions, preset))
    return getattr(pkg.CompressionOptions, preset)()


@functools.lru_cache(maxsize=None)
def jax_preset_stream(name: str, preset: str, chunk_size: int, batch_size: int):
    """The JAX corpus engine's raw stream of ``inputs(name)`` at ``preset``,
    or the type of the ``AssertionError`` or ``ValueError`` it raised."""
    import deflate_rs_tpu as dj
    from deflate_rs_tpu.parallel import corpus as jcorpus

    try:
        return jcorpus.compress_corpus(inputs(name), preset_options(dj, preset),
                                       batch_size=batch_size, chunk_size=chunk_size).deflate
    except (AssertionError, ValueError) as e:
        return type(e)


def check_against_jax(name: str, preset: str, chunk_size: int, batch_size: int) -> None:
    """The port's corpus engine on the CPU gives the JAX stream of
    :func:`jax_preset_stream`, or, where JAX failed, raises ``ValueError``
    at the entry (``check_chunk_size``, before any encode)."""
    import zlib

    import pytest

    import deflate_rs_tpu_torch as dt
    from deflate_rs_tpu_torch.parallel import corpus as tcorpus

    want = jax_preset_stream(name, preset, chunk_size, batch_size)
    opts = preset_options(dt, preset)
    if isinstance(want, bytes):
        got = tcorpus.compress_corpus(inputs(name), opts, batch_size=batch_size,
                                      chunk_size=chunk_size, device="cpu").deflate
        assert got == want
        assert zlib.decompress(got, wbits=-15) == inputs(name)
    else:
        with pytest.raises(ValueError, match="long-range pass"):
            tcorpus.check_chunk_size(chunk_size, opts)
        with pytest.raises(ValueError, match="long-range pass"):
            tcorpus.compress_corpus(inputs(name), opts, chunk_size=chunk_size, device="cpu")
