"""The share of the traced window in which nothing ran on the card: 1 less
the union of its activities over the window's wall time."""

from portbench.trace import busy_us

LAYER = "device (H100)"
UNIT, BETTER, SOURCE, MOVES = "share", "lower", "device_trace", "throughput_mbs"
WORKLOADS = ("corpus.default-64k.mix", "corpus.default-1m.mix")


def read(trace: dict):
    if not trace["device"]:
        return None
    return 1 - busy_us(trace["device"]) / 1e6 / trace["window_s"]
