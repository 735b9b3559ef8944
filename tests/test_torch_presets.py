"""Every preset of the port against the JAX package, byte for byte, at the
64 KiB tier (pg11, three chunks), plus the pinned pg11 sizes and the zlib
and gzip framings of high.

The 4 KiB tier and the tiny force-mode inputs are held against JAX in
``tests/test_torch_options.py`` (``test_non_default_presets_raise`` and
``test_force_modes_raise``), so that each JAX encoder, one per
configuration and tier, compiles once in the suite.
"""

import gzip
import os
import zlib

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
# The suite runs several workers on one machine: one intra-op thread per
# worker keeps the port's many small ops from oversubscribing the cores.
torch.set_num_threads(1)

import deflate_rs_tpu as dj  # noqa: E402
import deflate_rs_tpu_torch as dt  # noqa: E402

DATA = os.path.join(os.path.dirname(__file__), "data")
CONFIGS = ["fast", "high", "rle", "huffman_only", "turbo", "ForceFixed", "ForceStored"]
# The pinned pg11 sizes of tests/test_ratio.py:64-80.
PG11_SIZES = {"fast": 68562, "high": 60066, "rle": 97877, "huffman_only": 97867}


def options(pkg, name: str):
    """The named configuration from ``pkg`` (either package)."""
    if name.startswith("Force"):
        return pkg.CompressionOptions(special=pkg.SpecialOptions[name])
    return getattr(pkg.CompressionOptions, name)()


@pytest.fixture(scope="module")
def pg11():
    with open(os.path.join(DATA, "pg11.txt"), "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def jax_pg11(pg11):
    """JAX's pg11 stream per configuration, computed once per module."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = dj.deflate_bytes_conf(pg11, options(dj, name))
        return cache[name]

    return get


@pytest.mark.parametrize("name", CONFIGS)
def test_pg11_equal_jax(name, pg11, jax_pg11):
    got = dt.deflate_bytes_conf(pg11, options(dt, name), device="cpu")
    assert got == jax_pg11(name)
    assert zlib.decompress(got, -15) == pg11
    if name in PG11_SIZES:
        assert len(got) == PG11_SIZES[name]


def test_compression_enum_reaches_presets(pg11, jax_pg11):
    """``Compression.Fast`` resolves to the fast preset (``Best`` to high:
    see the framing test)."""
    got = dt.deflate_bytes_conf(pg11, dt.Compression.Fast, device="cpu")
    assert got == jax_pg11("fast")


def test_force_fixed_incompressible():
    """Random bytes under fixed codes take ~8.5 bits a byte: above the
    stored bound, inside the 9/8 ForceFixed word buffer."""
    data = np.random.default_rng(6).integers(0, 256, 70000, dtype=np.uint8).tobytes()
    got = dt.deflate_bytes_conf(data, options(dt, "ForceFixed"), device="cpu")
    assert got == dj.deflate_bytes_conf(data, options(dj, "ForceFixed"))
    assert len(got) > len(data) * 33 // 32
    assert zlib.decompress(got, -15) == data


def test_high_zlib_and_gzip_framing(pg11):
    data = pg11[:70000]  # two chunks of the 64 KiB tier
    opts_t, opts_j = options(dt, "high"), options(dj, "high")
    z = dt.deflate_bytes_zlib_conf(data, dt.Compression.Best, device="cpu")
    assert z == dj.deflate_bytes_zlib_conf(data, opts_j)
    assert zlib.decompress(z) == data
    g = dt.deflate_bytes_gzip_conf(data, dt.GzBuilder().with_filename("pg11.txt"), opts_t,
                                   device="cpu")
    assert g == dj.deflate_bytes_gzip_conf(data, dj.GzBuilder().with_filename("pg11.txt"),
                                           opts_j)
    assert gzip.decompress(g) == data
