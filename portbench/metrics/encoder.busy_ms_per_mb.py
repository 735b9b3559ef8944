"""Milliseconds in which anything ran on the device (the union of kernels,
copies and memsets) per MB of input."""

from portbench.trace import busy_us

LAYER = "chunk encoder (ops/chunk_encode.py)"
UNIT, BETTER, SOURCE, MOVES = "ms/MB", "lower", "device_trace", "throughput_mbs"
WORKLOADS = ("corpus.default-64k.mix", "corpus.default-1m.mix")


def read(trace: dict):
    if not trace["device"]:
        return None
    return busy_us(trace["device"]) / 1e3 / trace["input_mb"]
