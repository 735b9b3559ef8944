"""Device kernels in the trace (copies and memsets left out) per MB of
input: the launches the host pays for."""

from portbench.trace import is_copy

LAYER = "chunk encoder (ops/chunk_encode.py)"
UNIT, BETTER, SOURCE, MOVES = "launches/MB", "lower", "device_trace", "throughput_mbs"
WORKLOADS = ("corpus.default-64k.mix", "corpus.default-1m.mix")


def read(trace: dict):
    kernels = sum(1 for _, _, name in trace["device"] if not is_copy(name))
    return kernels / trace["input_mb"] if kernels else None
