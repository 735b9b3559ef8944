"""Host milliseconds inside the corpus engine's ``corpus.encode`` range (the
host queuing the encoder's launches) per MB of input."""

LAYER = "corpus engine (parallel/corpus.py)"
UNIT, BETTER, SOURCE, MOVES = "ms/MB", "lower", "program_span", "throughput_mbs"
WORKLOADS = ("corpus.default-64k.mix", "corpus.default-1m.mix")


def read(trace: dict):
    spans = trace["host_ranges"].get("corpus.encode")
    if not spans:
        return None
    return sum(e - s for s, e in spans) / 1e3 / trace["input_mb"]
