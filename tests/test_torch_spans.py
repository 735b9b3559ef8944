"""The program's profiler ranges (``deflate_rs_tpu_torch/runtime/trace.py``).

With ``DEFLATE_TPU_TRACE_CORPUS=1`` the corpus engine opens each of the
chunk encoder's stage ranges ``encoder.<stage>`` once a batch, in
``ChunkEncoder.STAGES`` order, inside its ``corpus.encode`` range; the
sharded step opens the same stage ranges once a device; with the switch off
neither opens a range; the streams are the same bytes either way.  On the
CPU, under a CPU ``torch.profiler``.  The tests marked ``cuda`` trace one
``forward`` on the card: every device activity lands under one key of
``portbench.launches.launched_in``, each hand-written kernel under its
stage, and no range leaves an event on the device's timeline.  On a GPU
machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_spans.py
"""

import collections

import pytest

torch = pytest.importorskip("torch")

from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from deflate_rs_tpu_torch import CompressionOptions  # noqa: E402
from deflate_rs_tpu_torch.ops.chunk_encode import ChunkEncoder  # noqa: E402
from deflate_rs_tpu_torch.parallel.corpus import compress_corpus  # noqa: E402
from deflate_rs_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from deflate_rs_tpu_torch.parallel.sharded import (  # noqa: E402
    assemble_host, make_sharded_encoder,
)
from deflate_rs_tpu_torch.runtime import trace  # noqa: E402
from deflate_rs_tpu_torch.tools import stage_timing  # noqa: E402
from deflate_rs_tpu_torch.utils.mix import mix  # noqa: E402
from portbench.launches import OUTSIDE, launched_in  # noqa: E402
from portbench.trace import kernel_base  # noqa: E402

EMIT = 4096
DATA = mix(5 * EMIT + 100)  # six chunks: three batches of two
BATCHES = 3
PROGRAM = ("corpus.", "encoder.")
STAGE_RANGES = ["encoder." + s for s in ChunkEncoder.STAGES]


def _traced(fn, switch):
    """(``fn()``, the program's ranges a CPU profiler saw in it, in order of
    their start) with the switch set to ``switch`` (None: unset)."""
    with pytest.MonkeyPatch.context() as mp:
        if switch is None:
            mp.delenv(trace.SWITCH, raising=False)
        else:
            mp.setenv(trace.SWITCH, switch)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = fn()
    ranges = sorted((e for e in prof.events() if e.name.startswith(PROGRAM)),
                    key=lambda e: e.time_range.start)
    return out, ranges


def _corpus(preset: str = "default"):
    return lambda: compress_corpus(DATA, getattr(CompressionOptions, preset)(), batch_size=2,
                                   queue_depth=1, chunk_size=EMIT, packed=True,
                                   device="cpu").deflate


def _sharded(devices: int = 2):
    """One step of the sharded encoder over ``devices`` logical CPU devices
    of one process, four chunks a device; its packed stream."""
    B = 4 * devices
    inputs = stage_timing.batch_inputs(mix(B * EMIT), B, EMIT)

    def run():
        step = make_sharded_encoder(make_mesh(devices, device="cpu"),
                                    CompressionOptions.default(), EMIT)
        return assemble_host(step(*inputs), B)

    return run


PATHS = {"corpus": _corpus(), "sharded": _sharded()}


@pytest.fixture(scope="module")
def corpus_on():
    return _traced(PATHS["corpus"], "1")


def _names(ranges):
    return [e.name for e in ranges]


def test_corpus_encode_opens_once_a_batch(corpus_on):
    _, ranges = corpus_on
    assert _names(ranges).count("corpus.encode") == BATCHES


@pytest.mark.parametrize("stage", ChunkEncoder.STAGES)
def test_each_stage_range_opens_once_a_batch_inside_corpus_encode(stage, corpus_on):
    _, ranges = corpus_on
    opened = [e for e in ranges if e.name == "encoder." + stage]
    assert len(opened) == BATCHES
    assert all(e.cpu_parent is not None and e.cpu_parent.name == "corpus.encode"
               for e in opened)


def test_the_stage_ranges_run_in_order_in_each_corpus_encode(corpus_on):
    _, ranges = corpus_on
    for enc in (e for e in ranges if e.name == "corpus.encode"):
        inner = sorted((c for c in enc.cpu_children if c.name.startswith("encoder.")),
                       key=lambda c: c.time_range.start)
        assert _names(inner) == STAGE_RANGES


@pytest.mark.parametrize("devices", [1, 2])
def test_the_sharded_step_opens_the_stage_ranges(devices):
    """The stages in turns over the devices: each stage range once a device,
    and no corpus range (the sharded step has none)."""
    _, ranges = _traced(_sharded(devices), "1")
    assert _names(ranges) == [r for r in STAGE_RANGES for _ in range(devices)]


@pytest.mark.parametrize("switch", [None, "0"])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_no_range_with_the_switch_off(path, switch):
    _, ranges = _traced(PATHS[path], switch)
    assert ranges == []


@pytest.mark.parametrize("case", ["corpus-default", "corpus-fast", "corpus-rle",
                                  "corpus-huffman_only", "sharded-default"])
def test_the_stream_is_the_same_with_the_switch_on_and_off(case):
    path, preset = case.split("-")
    fn = _corpus(preset) if path == "corpus" else PATHS["sharded"]
    on, ranges = _traced(fn, "1")
    off, none = _traced(fn, None)
    assert ranges and not none
    assert on == off


def test_span_reads_the_switch_at_each_call(monkeypatch):
    monkeypatch.delenv(trace.SWITCH, raising=False)
    with trace.span("encoder.lz77") as off:
        assert off is None  # a nullcontext
    monkeypatch.setenv(trace.SWITCH, "1")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("encoder.lz77"):
            torch.ones(2).add_(1)
    (r,) = [e for e in prof.events() if e.name == "encoder.lz77"]
    assert any(c.name.startswith("aten::") for c in r.cpu_children)


# On the card.

# The hand-written kernels (runtime/cuda.py, launched through ctypes) and the
# stage that launches each at Default.
KERNEL_STAGE = {"lr_measure_kernel": "encoder.long_range", "parse_scan_kernel": "encoder.parse",
                "quarter_hist_kernel": "encoder.histograms",
                "package_merge_kernel": "encoder.tables", "token_fields_kernel": "encoder.fields"}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_every_activity_of_a_traced_forward_lands_under_one_key(dev):
    from deflate_rs_tpu_torch.runtime import cuda

    cuda.load_library()
    B = 4
    bufs, hist, ns, lasts = (torch.from_numpy(a) for a in
                             stage_timing.batch_inputs(mix(B * 65536), B, 65536))
    enc = ChunkEncoder(CompressionOptions.default(), 65536).to(dev)
    dbufs = bufs.to(dev)
    with torch.no_grad():
        events = stage_timing._traced_forward(lambda: enc(dbufs, hist, ns, lasts))
    on_device = [e for e in events if e.device_type == DeviceType.CUDA]
    assert not [e for e in on_device if e.name.startswith(PROGRAM)]  # no mirror
    launched = launched_in(events, ("encoder.", stage_timing.FORWARD))
    assert sum(map(len, launched.values())) == len(on_device)
    # The two untraced calls around the traced one fall under no range.
    per_key = {k: len(v) for k, v in launched.items()}
    assert per_key[OUTSIDE] == 2 * sum(n for k, n in per_key.items() if k != OUTSIDE)
    where = collections.defaultdict(set)
    for key, acts in launched.items():
        for _, _, name in acts:
            base = kernel_base(name).split("::")[-1]
            if base in KERNEL_STAGE and key != OUTSIDE:
                where[base].add(key)
    assert {k: sorted(v) for k, v in where.items()} == {k: [v] for k, v in KERNEL_STAGE.items()}

