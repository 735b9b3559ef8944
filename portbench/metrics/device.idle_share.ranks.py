"""The idle share of each card in the ranks form, from each rank's own
profiler over its own traced jobs, averaged over the cards."""

LAYER = "device (H100)"
UNIT, BETTER, SOURCE, MOVES = "share", "lower", "device_trace", "sharded_throughput_mbs"
WORKLOADS = ("sharded.default-64k.ranks4",)


def read(trace: dict):
    cards = trace.get("cards") or []
    shares = [1 - c["busy_s"] / c["window_s"] for c in cards if c.get("busy_s")]
    if not shares or len(shares) < len(cards):
        return None
    return sum(shares) / len(shares)
