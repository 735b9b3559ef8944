"""Each driver end to end on the CPU at a tiny size, and the check seeing
``correct`` come out false when the timed path is broken underneath it."""

import dataclasses
import json

import pytest

from portbench import reference, run
from portbench.drivers import ranks
from portbench.tests import tiny

KEYS = ("correct", "attempted", "failed", "metrics", "device")


def line_of(cell, trace_on=False, seconds=0.5):
    out, lines = run.execute(cell, tiny.SEED, seconds, trace_on, device="cpu")
    json.loads(json.dumps(out))  # one JSON line
    assert list(out)[: len(KEYS)] == list(KEYS) and list(out)[-1] == "check"
    assert lines[-1].startswith("failed_jobs ") and "limit" in lines[-1]
    return out


@pytest.mark.parametrize("name", ["corpus.default-64k.mix", "sharded.default-64k.ranks4"])
@pytest.mark.parametrize("trace_on", [False, True])
def test_driver_runs_and_is_correct(name, trace_on):
    cell = tiny.cell(name)
    out = line_of(cell, trace_on)
    assert out["correct"] is True, out
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert out["device"]["count"] == cell.chips
    assert out["check"]["bad_jobs"] == {"value": 0, "limit": 0}
    if trace_on:
        # On the CPU only the host's spans have something to read.
        assert set(out["metrics"]) <= {m["name"] for m in cell.per_layer}
        assert "window_s" in out["device"]
    else:
        assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
        assert out["metrics"]["setup_s"]["value"] > 0


def _flip(stream: bytes) -> bytes:
    b = bytearray(stream)
    b[len(b) // 2] ^= 0x10
    return bytes(b)


def _broken(kind):
    """compress_corpus with one fault planted in it."""
    from deflate_rs_tpu_torch.parallel import corpus

    real = corpus.compress_corpus
    last = []

    def fault(data, *args, **kw):
        if kind == "half":  # half of the batch left out
            data = data[: len(data) // 2]
        res = real(data, *args, **kw)
        if kind == "altered":  # an answer altered where it is produced
            res = corpus.CorpusResult(_flip(res.deflate), res.adler, res.crc32, res.isize,
                                      res.fetched)
        if kind == "unchanged":  # the previous job's answer handed back
            last.append(res)
            res = last[0]
        return res

    return fault


@pytest.mark.parametrize("kind", ["altered", "half", "unchanged"])
def test_corpus_fault_is_not_correct(kind, monkeypatch):
    from deflate_rs_tpu_torch.parallel import corpus

    monkeypatch.setattr(corpus, "compress_corpus", _broken(kind))
    out = line_of(tiny.cell("corpus.default-64k.mix"), seconds=1.5)
    assert out["correct"] is False
    assert out["check"]["bad_jobs"]["value"] >= 1


def test_raising_job_is_not_correct(monkeypatch):
    from deflate_rs_tpu_torch.parallel import corpus

    def fail(*a, **kw):
        raise RuntimeError("planted")

    cell = tiny.cell("corpus.default-64k.mix")
    monkeypatch.setattr(corpus, "compress_corpus", fail)
    out, lines = run.execute(dataclasses.replace(cell, traffic=dict(cell.traffic, warmup_jobs=0)),
                             tiny.SEED, 0.5, False, device="cpu")
    assert out["correct"] is False and out["failed"] == 1
    assert any("planted" in line for line in lines)


@pytest.mark.parametrize("fault", ["exchange", "altered"])
def test_ranks_fault_is_not_correct(fault, monkeypatch):
    """The rank entry of ``test_portbench_lifetime`` plants the fault
    named in the environment in every rank."""
    monkeypatch.setenv("PORTBENCH_TEST_RANK", fault)
    cell = tiny.cell("sharded.default-64k.ranks4")
    (one,) = ranks.launch_runs(cell, [tiny.SEED], 0.5, False, device="cpu",
                               entry="portbench.tests.test_portbench_lifetime")
    one["setup_s"] = 1.0
    out, _ = run.result(cell, one, False, {"platform": "cpu", "kind": "cpu", "count": 4,
                                           "memory_peak_bytes": 0})
    assert out["correct"] is False
    assert out["failed"] >= 1 or out["check"]["bad_jobs"]["value"] >= 1


def test_check_sees_a_corrupted_stream():
    data = bytes(range(256)) * 1024
    import zlib

    good = zlib.compress(data, 6)
    assert reference.check([(data, good)], 65536, 6)["bad_jobs"] == 0
    for bad in (_flip(good), good[:-1], good[:-4] + b"\0\0\0\0", good + b"x"):
        assert reference.check([(data, bad)], 65536, 6)["bad_jobs"] == 1
    ok, lines = reference.verdict({"checked_jobs": 0}, {"bad_jobs": 0})
    assert not ok and lines[0] == "checked_jobs 0 least 1"


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["corpus.default-64k.mix", "corpus.default-1m.mix"])
def test_cell_on_the_card(name, cuda_card):
    """Each cell of ``BENCHMARK.json`` for a short window on the card
    (``python3 -m pytest portbench/tests -m cuda`` on a machine with an H100)."""
    from portbench import spec

    out, _ = run.execute(spec.load_cell(name), tiny.SEED, 2.0, False, device="cuda")
    assert out["correct"] is True, out
    assert out["device"]["platform"] == "gpu" and out["device"]["memory_peak_bytes"] > 0
