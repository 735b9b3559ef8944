"""Cells cut to a size the CPU runs in seconds: the same configuration,
traffic recipe and limits, with short jobs.  The ranks cell is not in
``BENCHMARK.json`` (PERF.md, section 7); its files are, and it is built
from them here as a later entry would name them."""

import dataclasses

from portbench import spec

SEED = 2**31 + 7  # past 32 signed bits, as the benchmark's seeds may be
RANKS = {"name": "sharded.default-64k.ranks4", "config": "default-64k.ranks4",
         "traffic": "mix-64m", "chips": 4}
RANKS_METRICS = ("sharded_throughput_mbs", "peak_device_gib", "setup_s")
RANKS_LAYER = ("sharded.rank0_serial_ms_per_job", "device.idle_share.ranks")
TINY = {
    "corpus.default-64k.mix": {"traffic": {"job_bytes": 1 << 18, "warmup_jobs": 1}},
    RANKS["name"]: {"traffic": {"job_bytes": 1 << 19, "warmup_jobs": 1},
                    "config": {"step_chunks": 8}},
}


def _entry(kind: str, name: str) -> dict:
    r = spec.end_to_end(name) if kind == "end_to_end" else spec.metric(name)
    return {"name": name, "unit": r.UNIT, "better": r.BETTER, "source": r.SOURCE}


def ranks_cell() -> spec.Cell:
    """The ranks cell from its files."""
    bench = spec.load_json(spec.BENCHMARK)
    bench = dict(bench, workloads=[*bench["workloads"], RANKS],
                 configs=[*bench["configs"], {"name": RANKS["config"],
                                              "file": f"portbench/configs/{RANKS['config']}.json"}],
                 end_to_end=[_entry("end_to_end", n) for n in RANKS_METRICS],
                 per_layer=[_entry("metrics", n) for n in RANKS_LAYER])
    return spec.load_cell(RANKS["name"], bench)


def cell(name: str, **config):
    c = ranks_cell() if name == RANKS["name"] else spec.load_cell(name)
    cut = TINY[name]
    return dataclasses.replace(c, traffic=dict(c.traffic, **cut["traffic"]),
                               config=dict(c.config, **cut.get("config", {}), **config))
