"""``ChunkEncoder``'s stages (``ChunkEncoder.STAGES``) and the tool that
times them (``deflate_rs_tpu_torch/tools/stage_timing.py``).

The stage methods, chained by hand, give ``forward``'s dict element for
element at every preset, the force modes and ``lr_global=64``, with and
without checksums, on crafted chunks of the 4 KiB tier and on one 64 KiB
chunk; at Default and high the chained words also equal the JAX
``encode_chunk``'s.  ``stage_timing`` on the CPU prints one line per stage
and one for ``forward``, with the host's times only; on a hand-built trace
it fills each stage's row from the activity its range launched, its host
time and its idle gaps, and ``forward``'s from the range around the
traced call.  The mix the tools and ``chip_smoke.py`` share
(``utils/mix.py``) keeps its bytes.
Tolerance: exact equality.
"""

import dataclasses
import functools
import hashlib
import json

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from deflate_rs_tpu import CompressionOptions as JOpts  # noqa: E402
from deflate_rs_tpu.ops.chunk_encode import get_chunk_encoder  # noqa: E402
from deflate_rs_tpu_torch import CompressionOptions as TOpts  # noqa: E402
from deflate_rs_tpu_torch import SpecialOptions  # noqa: E402
from deflate_rs_tpu_torch.ops.chunk_encode import HALO, PAD, ChunkEncoder  # noqa: E402
from deflate_rs_tpu_torch.tools import stage_timing  # noqa: E402
from deflate_rs_tpu_torch.utils import mix  # noqa: E402
from portbench.tests.events import two_stage_trace  # noqa: E402

OPTIONS = {
    "default": TOpts.default(), "fast": TOpts.fast(), "high": TOpts.high(), "rle": TOpts.rle(),
    "huffman_only": TOpts.huffman_only(), "turbo": TOpts.turbo(),
    "ForceFixed": TOpts(special=SpecialOptions.ForceFixed),
    "ForceStored": TOpts(special=SpecialOptions.ForceStored),
    "lr_global=64": dataclasses.replace(TOpts.default(), lr_global=64),
}


def _rows(emit: int):
    """(payload, history, is_last) rows: text, noise, runs, a text/noise
    split, tiny and empty payloads at 4 KiB; one chunk of text then noise,
    with history, at 64 KiB."""
    rng = np.random.default_rng(8)
    text = mix.pg11()
    noise = rng.integers(0, 256, 1 << 17, dtype=np.uint8).tobytes()
    if emit == 65536:
        return [(text[40_000:80_000] + noise[:25_536], text[:40_000], False)]
    runs = b"".join(bytes([int(v)]) * int(r) for v, r in
                    zip(rng.integers(0, 256, 64), rng.integers(1, 200, 64)))
    return [
        (text[:4096], b"", True),
        (text[5000:9096], text[:5000], False),
        (noise[:4096], b"", True),
        (runs[:4096], noise[:3000], False),
        (text[:2048] + noise[:2048], b"", True),
        (b"ab", b"", True),
        (b"", b"", True),
    ]


@functools.lru_cache(maxsize=None)
def _buffers(emit: int):
    rows = _rows(emit)
    bufs = np.zeros((len(rows), HALO + emit + PAD), np.uint8)
    hist = np.zeros(len(rows), np.int64)
    ns = np.zeros(len(rows), np.int64)
    last = np.zeros(len(rows), bool)
    for i, (p, h, is_last) in enumerate(rows):
        h = h[-HALO:]
        bufs[i, HALO - len(h) : HALO] = np.frombuffer(h, np.uint8)
        bufs[i, HALO : HALO + len(p)] = np.frombuffer(p, np.uint8)
        hist[i], ns[i], last[i] = len(h), len(p), is_last
    return bufs, hist, ns, last


def _chained(enc: ChunkEncoder, args) -> dict:
    s = enc.inputs(*args)
    s = enc.lz77(s)
    s = enc.long_range(s)
    s = enc.parse(s)
    s = enc.symbols(s)
    s = enc.histograms(s)
    s = enc.scoring(s)
    s = enc.tables(s)
    s = enc.fields(s)
    s = enc.pack(s)
    s = enc.checksums(s)
    return enc.outputs(s)


@functools.lru_cache(maxsize=None)
def _run(name: str, emit: int, checksums: bool):
    enc = ChunkEncoder(OPTIONS[name], emit, with_checksums=checksums)
    args = tuple(torch.from_numpy(a) for a in _buffers(emit))
    with torch.no_grad():
        return enc(*args), _chained(enc, args)


@pytest.mark.parametrize("checksums", [False, True])
@pytest.mark.parametrize("emit", [4096, 65536])
@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_chained_stages_equal_forward(name, emit, checksums):
    whole, chained = _run(name, emit, checksums)
    want = {"words", "total_bits", "data_bits", "btype", "ntokens"}
    if checksums:
        want |= {"s1", "s2", "crc_raw"}
    assert set(whole) == set(chained) == want
    for k in want:
        assert whole[k].dtype == chained[k].dtype, k
        assert torch.equal(whole[k], chained[k]), k


def test_the_crafted_rows_reach_every_block_type():
    _, chained = _run("default", 4096, False)
    assert set(chained["btype"].tolist()) == {0, 1, 2, 3}


@pytest.mark.parametrize("name", ["default", "high"])
def test_chained_stages_equal_jax(name):
    """The chained stages at the 4 KiB tier against the JAX encode_chunk."""
    _, got = _run(name, 4096, False)
    jenc = get_chunk_encoder(getattr(JOpts, name)(), 4096, with_checksums=False)
    bufs, hist, ns, last = _buffers(4096)
    for i in range(len(ns)):
        want = jenc(bufs[i], np.int32(hist[i]), np.int32(ns[i]), np.bool_(last[i]))
        for k in ("total_bits", "data_bits", "btype", "ntokens"):
            assert int(got[k][i]) == int(want[k]), (i, k)
        np.testing.assert_array_equal(got["words"][i].numpy(),
                                      np.asarray(want["words"]).astype(np.int64))


def test_a_stage_that_does_not_run_returns_its_state():
    enc = ChunkEncoder(TOpts.fast(), 4096)  # no long-range pass
    s = {"best_len": torch.zeros(1)}
    assert enc.long_range(s) is s and enc.checksums(s) is s


def test_stage_timing_on_the_cpu(capsys):
    assert stage_timing.main(["--device", "cpu", "--batch", "2", "--emit", "4096",
                              "--reps", "1"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["stage"] for r in rows] == [*ChunkEncoder.STAGES, "forward"]
    for r in rows:
        assert (r["preset"], r["batch"], r["emit"], r["device"]) == ("default", 2, 4096, "cpu")
        # The host's times only: no device metric from a CPU run.
        assert not {"wall_ms", "busy_ms", "kernels", "top", "card"} & set(r)
        assert ("cpu_wall_ms" in r) == r["runs"]
    ran = {r["stage"] for r in rows if r["runs"]}
    assert ran == set(ChunkEncoder.STAGES) - {"checksums"} | {"forward"}
    assert rows[-1]["sum_of_stages"]["cpu_wall_ms"] > 0


def test_stage_timing_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert stage_timing.main(["--batch", "1", "--emit", "4096"]) == 1
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stage_timing.stage_rows(batch=1, emit=4096)


def test_batch_inputs_are_the_mix_chunks():
    data = mix.mix(3 * 4096)
    bufs, hist, ns, lasts = stage_timing.batch_inputs(data, 3, 4096)
    assert ns.tolist() == [4096] * 3 and not lasts.any()
    assert hist.tolist() == [0, 4096, 8192]
    assert bytes(bufs[2, HALO - 8192 : HALO + 4096]) == data


def test_the_mix_keeps_its_bytes():
    """The recipe moved out of ``chip_smoke.py`` unchanged (bench.py:85-97)."""
    m = mix.mix()
    assert len(m) == mix.MIX_BYTES == 16 << 20
    assert hashlib.sha256(m).hexdigest().startswith("293a722978642cdb")
    assert m[:65536] == mix.pg11()[:65536]  # the first chunk: pg11 text
    assert mix.mix(100_000) == m[:100_000]


def _trace():
    """``portbench``'s hand-built trace, its stages inside the range that
    ``stage_timing`` opens around the traced ``forward``."""
    return two_stage_trace(stage_timing.FORWARD)


def test_device_activity_splits_by_the_range_that_launched_it():
    """Each stage's row holds the activity its range launched; ``forward``'s
    the activity of its whole range, its stages' and its own (the
    compaction); activity launched outside it is in no row."""
    rows = stage_timing.stage_windows(_trace(), ("lz77", "parse"))
    tops = {k: sorted(t[0] for t in r["top"]) for k, r in rows.items()}
    assert tops == {"lz77": ["add_kernel", "sort_kernel"],
                    "parse": ["parse_scan_kernel(int const*)"],
                    "forward": ["add_kernel", "parse_scan_kernel(int const*)", "sort_kernel"]}
    # forward's fourth kernel is the compaction, launched in no stage.
    assert {k: (r["kernels"], r["copies"]) for k, r in rows.items()} == {
        "lz77": (2, 1), "parse": (1, 0), "forward": (4, 1)}


def test_stage_rows_come_from_the_activity_each_range_launched():
    """busy, kernels, copies and top of each stage's own activity; its host
    time; the idle gaps whose midpoint finds the host in it, edges
    included, as portbench's breakdown counts them.  ``forward``'s from its
    own range, held apart from the stages' sums."""
    rows = stage_timing.stage_windows(_trace(), ("lz77", "parse", "checksums"))
    lz, parse, none, forward = (rows[k] for k in ("lz77", "parse", "checksums", "forward"))
    # lz77: 10-20, 22-25, 30-45 busy; gaps -1-10 (the trace's edge), 20-22
    # and 25-30 in its range.
    assert lz == {"busy_ms": 0.028, "kernels": 2, "copies": 1,
                  "top": [["sort_kernel", 0.015, 1], ["add_kernel", 0.01, 1]],
                  "host_ms": 0.04, "gap_ms": pytest.approx(0.018)}
    # parse: 50-58 busy; the gap 45-50 has its midpoint in encoder.parse,
    # the gap 58-63 after the range.
    assert parse == {"busy_ms": 0.008, "kernels": 1, "copies": 0,
                     "top": [["parse_scan_kernel(int const*)", 0.008, 1]],
                     "host_ms": 0.02, "gap_ms": pytest.approx(0.005)}
    assert none == {"busy_ms": 0.0, "kernels": 0, "copies": 0, "top": [], "host_ms": 0.0,
                    "gap_ms": 0.0}
    # forward: the stages' work and the compaction (63-66); host -1-70; the
    # gaps of its stages and 58-63, in it outside them.
    assert (forward["kernels"], forward["copies"]) == (4, 1)
    assert forward["busy_ms"] == pytest.approx(0.039)
    assert forward["host_ms"] == pytest.approx(0.071)
    assert forward["gap_ms"] == pytest.approx(0.028)
