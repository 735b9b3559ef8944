"""The long-range knobs of the port against the JAX package: the strided
harvest (``lr_stride > 1``), ``union_dominants`` and
``global_dominant_lengths`` (``lr_global``) array for array, and
``deflate_bytes_conf`` with the knobs at Default and high in the 4 KiB tier
byte for byte (the 64 KiB tier: ``tests/test_torch_longrange_knobs.py``);
the corpus engine and a streaming encoder with a knob give the one-shot
bytes.  Every value is an integer: tolerance 0 everywhere.

The harvests are real: the distances the port's matcher claims at its probe
cap on near-repeated records (``torch_knob_data.py``), recorded as the
encoder hands them to the long-range pass.  Each JAX encoder (one per
configuration and tier) compiles once in this module.
"""

import dataclasses
import functools
import io
import zlib

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import deflate_rs_tpu as dj  # noqa: E402
import deflate_rs_tpu_torch as dt  # noqa: E402
from deflate_rs_tpu.ops import longrange as jlr  # noqa: E402
from deflate_rs_tpu_torch.ops import longrange as tlr  # noqa: E402
from deflate_rs_tpu_torch.parallel.corpus import compress_corpus  # noqa: E402
from torch_knob_data import KNOBS, harvested, knob_options, records  # noqa: E402


@functools.lru_cache(maxsize=None)
def _harvest(n: int, preset: str):
    """(buf, N, n_total, hstart, d_cand) of the first chunk of ``records(n)``."""
    return harvested(records(n), knob_options(dt, preset, {}))


def _j(t):
    return jnp.asarray(t[0].numpy())


@pytest.mark.parametrize("stride", [2, 4])
@pytest.mark.parametrize("sel,S", [("run", 64), ("freq", 32)])
def test_select_dominants_strided_equals_jax(stride, sel, S):
    buf, N, nt, hs, dc = _harvest(65536, "default")
    got_d, got_f = tlr.select_dominants(dc, S, 48, sel, harvest_stride=stride, pair=False)
    want_d, want_f = jlr._select_dominants(_j(dc), S, 48, stride, sel=sel, pair=False)
    assert int((got_d > 0).sum()) > S  # live dominants in many segments
    np.testing.assert_array_equal(got_d[0].numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(got_f[0].numpy(), np.asarray(want_f))


def test_select_dominants_row_width_check():
    dc = torch.zeros((1, 98304), dtype=torch.int32)
    with pytest.raises(ValueError, match="raise dom_segs or harvest_stride"):
        tlr.select_dominants(dc, 1, 48, "run", harvest_stride=2, pair=False)
    with pytest.raises(AssertionError):
        tlr.select_dominants(dc, 64, 48, "run", harvest_stride=2, pair=True)


def _tied_harvest(values, N: int = 8192) -> np.ndarray:
    """Harvested distances of four segments: distance k has one run of
    ``2 * L[(k + s) % 5]`` positions in segment s (L = 20, 40, .., 100).
    The top three of each segment then total 140, 240, 240, 180 and 160 for
    k = 0..4 under either selection: ``values[1]`` and ``values[2]`` tie."""
    L = (20, 40, 60, 80, 100)
    d = np.zeros(N, np.int32)
    for s in range(4):
        p = s * (N // 4)
        for k, v in enumerate(values):
            ln = 2 * L[(k + s) % 5]
            d[p : p + ln] = v
            p += ln + 2
    return d


def _random_harvest(seed: int, N: int = 4096) -> np.ndarray:
    """Distances from an alphabet of six in runs of 2 or 4 positions."""
    rng = np.random.default_rng(seed)
    alphabet = rng.choice(np.arange(1, 32769), 6, replace=False)
    d = np.zeros(N, np.int32)
    p = 0
    while p < N - 4:
        ln = int(rng.choice([2, 4]))
        if rng.random() < 0.7:
            d[p : p + ln] = alphabet[rng.integers(0, 6)]
        p += ln + 2 * int(rng.integers(0, 2))
    return d


@pytest.mark.parametrize("D", [1, 5, 12, 20])  # below, at and above S * M = 12
@pytest.mark.parametrize("sel", ["run", "freq"])
def test_union_dominants_ties_equal_jax(D, sel):
    """Tied totals: JAX's top_k keeps the lower index of the value-sorted
    runs, the smaller distance; the port's stable sort does the same.  The
    tied pair is in either order of distance; D = 1 keeps one of them."""
    S, M = 4, 3
    rows = [_tied_harvest((7000, 9000, 300, 20000, 5)), _tied_harvest((7000, 300, 9000, 20000, 5)),
            _random_harvest(1, 8192), _random_harvest(2, 8192)]
    got = tlr.union_dominants(torch.from_numpy(np.stack(rows)), S, M, D, sel=sel)
    for r, row in enumerate(rows):
        want = jlr.union_dominants(jnp.asarray(row), S, M, D, harvest_stride=1, sel=sel,
                                   pair=True)
        np.testing.assert_array_equal(got[r].numpy(), np.asarray(want))
        live = int((got[r] > 0).sum())
        assert live > 0 and (got[r][live:] == 0).all()  # a live prefix
    # The tie goes to the smaller distance, whichever segment order.
    assert got[0].tolist()[: min(D, 2)] == [300, 9000][: min(D, 2)]
    assert got[1].tolist()[: min(D, 2)] == [300, 9000][: min(D, 2)]


@pytest.mark.parametrize("preset", ["default", "high"])
@pytest.mark.parametrize("D,stride", [(64, 1), (200, 1), (64, 2), (256, 4)])
def test_union_and_global_lengths_equal_jax(preset, D, stride):
    """On the records' harvest at the preset's segments, dominants and
    selection; the measurement over the whole chunk as one segment."""
    buf, N, nt, hs, dc = _harvest(65536, preset)
    o = knob_options(dt, preset, {"lr_global": D, "lr_stride": stride})
    kw = dict(num_dom=o.resolved_num_dom, num_seg=o.resolved_dom_segs,
              harvest_stride=stride, sel=o.resolved_lr_sel, pair=o.resolved_lr_pair)
    got = tlr.union_dominants(dc, num_global=D, **kw)
    want = jlr.union_dominants(_j(dc), num_global=D, **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))
    assert int((got > 0).sum()) > 8
    g_len, g_dist = tlr.global_dominant_lengths(buf, N, nt, hs, dc, num_global=D, **kw)
    w_len, w_dist = jlr.global_dominant_lengths(
        _j(buf), N, jnp.int32(int(nt[0])), jnp.int32(int(hs[0])), _j(dc), num_global=D, **kw)
    assert int((g_len > 0).sum()) > 1000
    np.testing.assert_array_equal(g_len[0].numpy(), np.asarray(w_len))
    np.testing.assert_array_equal(g_dist[0].numpy(), np.asarray(w_dist))


@functools.lru_cache(maxsize=None)
def _jax_4k(preset: str, knob: tuple) -> bytes:
    return dj.deflate_bytes_conf(records(4096), knob_options(dj, preset, dict(knob)))


@pytest.mark.parametrize("preset", ["default", "high"])
@pytest.mark.parametrize("knob", KNOBS, ids=[str(k) for k in KNOBS])
def test_knob_streams_equal_jax_4k_tier(preset, knob):
    data = records(4096)
    got = dt.deflate_bytes_conf(data, knob_options(dt, preset, dict(knob)), device="cpu")
    assert got == _jax_4k(preset, knob)
    assert zlib.decompress(got, -15) == data


def test_knob_changes_default_in_4k_tier():
    """In the small tier the union of Default reaches claims its segments
    miss (383 against 381 bytes)."""
    plain = dt.deflate_bytes_conf(records(4096), dt.CompressionOptions.default(), device="cpu")
    assert _jax_4k("default", (("lr_global", 64),)) != plain


@pytest.mark.parametrize("framing", ["raw", "zlib"])
def test_corpus_engine_and_streaming_with_a_knob_equal_one_shot(framing):
    """Four chunks of records: the one-shot path (the chunk-batch engine at
    this size) against the corpus engine in batches of two, and against a
    streaming encoder in writes of 99,991 bytes."""
    data = records(4 * 65536 - 1234)
    o = dataclasses.replace(dt.CompressionOptions.default(), lr_global=64, lr_stride=2)
    if framing == "raw":
        want = dt.deflate_bytes_conf(data, o, device="cpu")
        got = compress_corpus(data, o, batch_size=2, device="cpu").deflate
        sink = io.BytesIO()
        enc = dt.write.DeflateEncoder(sink, o, device="cpu")
    else:
        want = dt.deflate_bytes_zlib_conf(data, o, device="cpu")
        got = None
        sink = io.BytesIO()
        enc = dt.write.ZlibEncoder(sink, o, device="cpu")
    for off in range(0, len(data), 99_991):
        enc.write(data[off : off + 99_991])
    enc.finish()
    assert sink.getvalue() == want
    if got is not None:
        assert got == want and zlib.decompress(got, -15) == data
    else:
        assert zlib.decompress(want) == data
