"""The five hand-written kernels' share of their bytes bound, in percent:
their counted launches times the least time their operands need (each
byte read or written once over the card's bandwidth, ``roofline.py``),
over their summed time in the trace.  Read at 1 MiB chunks only: there a
batch's operands (64 MiB of chunks) pass the 50 MB L2, so the bound holds;
at 64 KiB a kernel can read from L2 faster than the bound."""

from portbench.roofline import KERNELS, bound_seconds
from portbench.trace import kernel_base

LAYER = "hand-written kernels (csrc/*.cu)"
UNIT, BETTER, SOURCE, MOVES = "%", "higher", "device_trace", "throughput_mbs"
WORKLOADS = ("corpus.default-1m.mix",)


def read(trace: dict):
    names = {g for _, globals_ in KERNELS.values() for g in globals_}
    spent = sum(e - s for s, e, name in trace["device"]
                if kernel_base(name).split("::")[-1] in names) / 1e6
    if not spent:
        return None
    bound = bound_seconds(trace["launches"], trace["config"])
    return 100 * bound / spent if bound else None
