"""Each reader computes its metric from a small recorded trace, and the
roofline's bytes are the bounds ``chip_smoke.py`` printed at 64 x 1 MiB."""

import json
import os

import pytest

from portbench import roofline, spec, trace

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture
def rec():
    with open(os.path.join(HERE, "trace_small.json")) as f:
        return json.load(f)


# Device intervals, us: union 62 of a 100 us window; seven kernels; encode
# 33 us of host time, fetches and splice 32, over 2 MB of input.
EXPECTED = {
    "corpus.encode_host_ms_per_mb": 0.033 / 2,
    "corpus.fetch_splice_ms_per_mb": 0.032 / 2,
    "encoder.launches_per_mb": 7 / 2,
    "encoder.busy_ms_per_mb": 0.062 / 2,
    "kernels_roofline": 100 * 1.1676550e-3 / 46e-6,
    "device.idle_share": 0.38,
    "sharded.rank0_serial_ms_per_job": 130.0,
    "device.idle_share.ranks": 0.35,
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_the_recorded_trace(name, rec):
    assert spec.metric(name).read(rec) == pytest.approx(EXPECTED[name], rel=1e-4)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_finds_nothing_in_an_empty_trace(name):
    empty = {"window_s": 1.0, "input_mb": 1.0, "jobs": 1, "device": [], "host_ranges": {},
             "launches": {}, "config": {}}
    assert spec.metric(name).read(empty) is None


def test_breakdown_names_gaps_by_the_host_range(rec):
    b = trace.breakdown(rec)
    gaps = dict(b["idle_gaps"])
    assert gaps == pytest.approx({"corpus.encode": 14e-6, "corpus.splice": 10e-6,
                                  "outside any span": 1e-6, "portbench.gather": 8e-6})
    ops = dict(b["device_ops"])
    assert ops["package_merge_kernel"] == pytest.approx(6e-6)
    assert ops["at::native::vectorized_elementwise_kernel"] == pytest.approx(10e-6)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


# Bounds in ms that chip_smoke.py printed for Default's operands at 64 x 1
# MiB (PERF.md's kernel table), kernel by kernel.
CHIP_SMOKE_MS = {"lr_measure": 0.10484, "parse_scan": 0.10016, "package_merge": 0.00072,
                 "token_fields": 0.80149, "quarter_hist": 0.16045}


@pytest.mark.parametrize("kernel", sorted(CHIP_SMOKE_MS))
def test_bytes_bound_matches_chip_smoke(kernel, rec):
    fn, _ = roofline.KERNELS[kernel]
    nbytes, per_batch = fn(64, 1 << 20, rec["config"]["preset_numbers"])
    assert nbytes / roofline.HBM_BYTES_PER_S * 1e3 == pytest.approx(CHIP_SMOKE_MS[kernel],
                                                                    abs=6e-6)
    assert per_batch == (2 if kernel == "package_merge" else 1)


def test_kernel_base_strips_signature():
    assert trace.kernel_base("void f<int, 4>(int*, long)") == "f"
    assert trace.kernel_base("lr_measure_kernel(unsigned char const*)") == "lr_measure_kernel"
    assert trace.kernel_base("void (anonymous namespace)::g<true>(int)") == "g"
    assert trace.kernel_base("at::native::(anonymous namespace)::h(int)") == "at::native::h"
    assert trace.kernel_base("Memcpy HtoD (Pinned -> Device)") == "Memcpy"
