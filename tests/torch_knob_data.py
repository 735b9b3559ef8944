"""Inputs and options shared by the tests of the long-range knobs.

``records(n)`` gives near-repeated records (a 300-byte record with three
bytes changed in each copy): the matcher's claims there hit the probe cap,
so the long-range pass has distances to harvest and the knobs change
streams.  ``harvested`` records what the port's encoder hands its local
long-range pass.  Importing this module imports no JAX.
"""

import dataclasses
import functools

import numpy as np

# The knob settings compared with the JAX package, as hashable tuples.
KNOBS = ((("lr_global", 64),), (("lr_global", 256),), (("lr_stride", 2),),
         (("lr_global", 64), ("lr_stride", 2)))


@functools.lru_cache(maxsize=None)
def records(n: int, seed: int = 0) -> bytes:
    rng = np.random.default_rng(seed)
    base = rng.integers(97, 123, 300, dtype=np.uint8)
    out = []
    for _ in range(n // 300 + 1):
        r = base.copy()
        r[rng.integers(0, 300, 3)] = rng.integers(97, 123, 3)
        out.append(r.tobytes())
    return b"".join(out)[:n]


def knob_options(pkg, preset: str, knob: dict):
    """``pkg``'s preset (either package) with the knob's fields set."""
    return dataclasses.replace(getattr(pkg.CompressionOptions, preset)(), **knob)


def harvested(data: bytes, options):
    """(buf, N, n_total, hstart, d_cand) of the first chunk of ``data`` as
    the port's encoder hands them to ``local_dominant_lengths`` on the CPU."""
    import deflate_rs_tpu_torch as dt
    from deflate_rs_tpu_torch.ops import chunk_encode

    seen = []
    local = chunk_encode.local_dominant_lengths

    def record(buf, N, n_total, hstart, d_cand, **kw):
        if not seen:
            seen.append((buf[:1], N, n_total[:1], hstart[:1], d_cand[:1]))
        return local(buf, N, n_total, hstart, d_cand, **kw)

    chunk_encode.local_dominant_lengths = record
    try:
        dt.deflate_bytes_conf(data, options, device="cpu")
    finally:
        chunk_encode.local_dominant_lengths = local
    return seen[0]
