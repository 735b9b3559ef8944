"""The program's stage ranges (``encoder.<stage>``, host ranges only) leave
the traced record and every reader as they were.

``trace.record`` files every CUDA event whose name has no ``corpus.`` or
``portbench.`` prefix under ``device``.  The program's ranges are
function-scope records, which the profiler mirrors onto no device
timeline, so a trace with them holds the same device events as one
without: the record, the readers and the breakdown are equal.  A device
mirror of a stage range, which a ``record_function`` range would leave,
would be counted as device work: the last test shows it.
"""

from types import SimpleNamespace

import pytest

from portbench import spec, trace

STAGES = ("lz77", "long_range", "parse", "symbols", "histograms", "scoring", "tables",
          "fields", "pack", "checksums")
READERS = ("corpus.encode_host_ms_per_mb", "corpus.fetch_splice_ms_per_mb",
           "encoder.launches_per_mb", "encoder.busy_ms_per_mb", "kernels_roofline",
           "device.idle_share")
CONFIG = {"chunk_size": 1 << 20, "batch_size": 64,
          "preset_numbers": {"max_hash_checks": 128, "lazy_if_less_than": 32,
                             "num_quarters": 8, "dom_segs": 64, "num_dom": 48}}


def _event(name, start, end, device=False):
    from torch.autograd import DeviceType

    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=DeviceType.CUDA if device else DeviceType.CPU)


def _events(stage_ranges: bool, mirrors: bool = False) -> list:
    """Two batches: upload, encode (its ten stage ranges inside where
    asked), fetches and splice on the host; kernels, a copy and a memset on
    the device, with the profiler's mirrors of the corpus ranges."""
    out = []
    for b in range(2):
        t = 1000.0 * b
        out += [_event("corpus.upload", t, t + 5), _event("corpus.encode", t + 5, t + 405),
                _event("corpus.meta_fetch", t + 405, t + 600),
                _event("corpus.words_fetch", t + 600, t + 620),
                _event("corpus.splice", t + 620, t + 900),
                _event("aten::add", t + 10, t + 12), _event("cudaLaunchKernel", t + 11, t + 12),
                _event("Memcpy HtoD (Pinned -> Device)", t + 3, t + 9, device=True),
                _event("corpus.upload", t + 3, t + 9, device=True),
                _event("corpus.encode", t + 20, t + 500, device=True),
                _event("Memset (Device)", t + 500, t + 502, device=True)]
        for i, s in enumerate(STAGES):
            lo = t + 20 + 48 * i
            out.append(_event(f"at::native::vectorized_elementwise_kernel<{i}>", lo, lo + 30,
                              device=True))
            if s == "parse":
                out.append(_event("void (anonymous namespace)::parse_scan_kernel<true>(int*)",
                                  lo + 30, lo + 40, device=True))
            if stage_ranges:
                out.append(_event("encoder." + s, t + 6 + 39 * i, t + 44 + 39 * i))
            if mirrors:
                out.append(_event("encoder." + s, lo, lo + 40, device=True))
    return out


def _record(events) -> dict:
    prof = SimpleNamespace(events=lambda: events)
    return trace.record(prof, window_s=2e-3, input_bytes=2_000_000, jobs=1,
                        launches={"parse_scan": 2}, config=CONFIG)


def test_record_is_the_same_with_the_stage_ranges():
    without, with_ranges = _record(_events(False)), _record(_events(True))
    assert with_ranges == without
    assert len(without["device"]) == 2 * (2 + len(STAGES) + 1)  # no mirror in device
    assert set(without["host_ranges"]) == {"corpus.upload", "corpus.encode",
                                           "corpus.meta_fetch", "corpus.words_fetch",
                                           "corpus.splice"}


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_the_same_with_the_stage_ranges(name):
    got = [spec.metric(name).read(_record(_events(r))) for r in (False, True)]
    assert got[0] is not None and got[0] == got[1]


def test_breakdown_is_the_same_with_the_stage_ranges():
    b = [trace.breakdown(_record(_events(r))) for r in (False, True)]
    assert b[0] == b[1]
    assert {k for k, _ in b[0]["idle_gaps"]} <= {"corpus.encode", "corpus.upload",
                                                 "corpus.meta_fetch", "corpus.words_fetch",
                                                 "corpus.splice", "outside any span"}


def test_a_device_mirror_of_a_stage_range_would_count_as_device_work():
    """Why the program's ranges are host ranges only: the record takes a
    mirrored ``encoder.*`` range for device work."""
    plain, mirrored = _record(_events(True)), _record(_events(True, mirrors=True))
    assert len(mirrored["device"]) == len(plain["device"]) + 2 * len(STAGES)
    launches = spec.metric("encoder.launches_per_mb")
    assert launches.read(mirrored) > launches.read(plain)
