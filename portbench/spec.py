"""Find a cell's parts by the names ``BENCHMARK.json`` gives them."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BENCHMARK = os.path.join(ROOT, "BENCHMARK.json")
# Top-level module names no run may load: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "deflate_rs_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is forbidden
    (``deflate_rs_tpu_torch`` is not ``deflate_rs_tpu``)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass(frozen=True)
class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""

    name: str
    chips: int
    config: dict
    traffic: dict
    check: dict
    end_to_end: tuple  # metric entries of BENCHMARK.json that this cell reports
    per_layer: tuple


def _reported_in(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(name: str, benchmark: dict | None = None) -> Cell:
    """The cell ``name``: its configuration, traffic mix and limits, and the
    metrics it reports.  Raises ``KeyError`` for a name the file lacks."""
    bench = load_json(BENCHMARK) if benchmark is None else benchmark
    (work,) = [w for w in bench["workloads"] if w["name"] == name] or [None]
    if work is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    (conf,) = [c for c in bench["configs"] if c["name"] == work["config"]]
    return Cell(
        name=name,
        chips=int(work["chips"]),
        config=load_json(os.path.join(ROOT, conf["file"])),
        traffic=load_json(os.path.join(HERE, "traffic", work["traffic"] + ".json")),
        check=load_json(os.path.join(HERE, "checks", name + ".json")),
        end_to_end=tuple(m for m in bench["end_to_end"] if _reported_in(m, name)),
        per_layer=tuple(m for m in bench["per_layer"] if _reported_in(m, name)),
    )


def driver(form: str):
    """The module ``drivers/<form>.py``."""
    return importlib.import_module(f"portbench.drivers.{form}")


def _by_path(kind: str, name: str):
    """The module ``<kind>/<name>.py`` (a metric's name may hold dots)."""
    path = os.path.join(HERE, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(f"portbench.{kind}.{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def end_to_end(name: str):
    """The reader ``end_to_end/<name>.py``: ``read(run) -> float``."""
    return _by_path("end_to_end", name)


def metric(name: str):
    """The reader ``metrics/<name>.py``: ``read(trace) -> float | None``."""
    return _by_path("metrics", name)
