"""Rank 0's milliseconds a job in the part no other rank shares: from the
``gather_object`` of every rank's shards to the job's zlib stream, after
the packed splice (``assemble_host(packed=True)``); the harness's own span,
a mean over the window's jobs."""

LAYER = "sharded encoder (parallel/sharded.py, parallel/mesh.py)"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "host_clock", "sharded_throughput_mbs"
WORKLOADS = ("sharded.default-64k.ranks4",)


def read(trace: dict):
    serial = trace.get("serial_ms")
    return sum(serial) / len(serial) if serial else None
