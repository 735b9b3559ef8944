"""Inputs shared by the port's tests, and the JAX corpus engine's streams of
them, each made once per test process.

``inputs(name)`` gives a seeded input: "mix" (pg11 with random bytes between,
so several block types share a batch), "all_stored", "dense" (about 6 bits a
byte), "mixed_tail" (stored, text and runs with an odd tail) and
"repeated_text".  ``jax_stream`` is ``deflate_rs_tpu.parallel.corpus``'s raw
stream of one of them.  Importing this module imports no JAX.
"""

import functools
import os

import numpy as np

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


@functools.lru_cache(maxsize=None)
def pg11() -> bytes:
    with open(os.path.join(DATA, "pg11.txt"), "rb") as f:
        return f.read()


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
    raise ValueError(name)


@functools.lru_cache(maxsize=None)
def jax_stream(name: str, batch_size: int, chunk_size: int = 65536, packed: bool = True) -> bytes:
    from deflate_rs_tpu.parallel import corpus as jcorpus

    return jcorpus.compress_corpus(inputs(name), batch_size=batch_size, chunk_size=chunk_size,
                                   packed=packed).deflate
