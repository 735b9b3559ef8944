"""The long-range knobs (``lr_global``, ``lr_stride > 1`` and both) at
Default and high in the 64 KiB tier: ``deflate_bytes_conf`` of the port on
the CPU against the JAX package, byte for byte, on one 64 KiB input of
near-repeated records (``torch_knob_data.py``); the zlib and gzip forms of
one setting.  The knobs change the stream at both presets there (a knob
that changed nothing would make the comparison vacuous): against the port's
knob-free stream, which equals the JAX package's (``test_torch_presets.py``,
``test_torch_deflate.py``).  The 4 KiB tier, the stages array for array and
the other engines: ``tests/test_torch_longrange_global.py``.  Each JAX
encoder compiles once in this module.
"""

import functools
import gzip
import zlib

import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import deflate_rs_tpu as dj  # noqa: E402
import deflate_rs_tpu_torch as dt  # noqa: E402
from torch_knob_data import KNOBS, knob_options, records  # noqa: E402

N = 65536


@functools.lru_cache(maxsize=None)
def _jax(preset: str, knob: tuple) -> bytes:
    return dj.deflate_bytes_conf(records(N), knob_options(dj, preset, dict(knob)))


@functools.lru_cache(maxsize=None)
def _port(preset: str, knob: tuple) -> bytes:
    return dt.deflate_bytes_conf(records(N), knob_options(dt, preset, dict(knob)), device="cpu")


@pytest.mark.parametrize("preset", ["default", "high"])
@pytest.mark.parametrize("knob", KNOBS, ids=[str(k) for k in KNOBS])
def test_knob_streams_equal_jax_64k_tier(preset, knob):
    got = _port(preset, knob)
    assert got == _jax(preset, knob)
    assert zlib.decompress(got, -15) == records(N)


@pytest.mark.parametrize("preset", ["default", "high"])
def test_lr_global_changes_the_stream(preset):
    """Default: 2,686 B without a knob, 2,464 B with lr_global=64; high:
    2,475 and 2,374 B."""
    assert _jax(preset, (("lr_global", 64),)) != _port(preset, ())


def test_lr_stride_changes_default():
    """A strided harvest ranks other dominants than the pair-collapsed one:
    2,696 B against 2,686 B at Default."""
    assert _jax("default", (("lr_stride", 2),)) != _port("default", ())


def test_zlib_and_gzip_forms_with_a_knob():
    o_t = knob_options(dt, "high", {"lr_global": 64, "lr_stride": 2})
    o_j = knob_options(dj, "high", {"lr_global": 64, "lr_stride": 2})
    z = dt.deflate_bytes_zlib_conf(records(N), o_t, device="cpu")
    assert z == dj.deflate_bytes_zlib_conf(records(N), o_j)
    assert zlib.decompress(z) == records(N)
    g = dt.deflate_bytes_gzip_conf(records(N), dt.GzBuilder(), o_t, device="cpu")
    assert g == dj.deflate_bytes_gzip_conf(records(N), dj.GzBuilder(), o_j)
    assert gzip.decompress(g) == records(N)
