"""Host milliseconds inside ``corpus.meta_fetch``, ``corpus.words_fetch`` and
``corpus.splice`` (waiting for a batch's results and splicing its blocks
into the stream) per MB of input."""

LAYER = "fetch and splice (parallel/corpus.py, models/assembly.py, runtime/native.py)"
UNIT, BETTER, SOURCE, MOVES = "ms/MB", "lower", "program_span", "throughput_mbs"
WORKLOADS = ("corpus.default-64k.mix", "corpus.default-1m.mix")
RANGES = ("corpus.meta_fetch", "corpus.words_fetch", "corpus.splice")


def read(trace: dict):
    spans = [sp for name in RANGES for sp in trace["host_ranges"].get(name, ())]
    if not spans:
        return None
    return sum(e - s for s, e in spans) / 1e3 / trace["input_mb"]
