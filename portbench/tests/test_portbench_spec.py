"""``BENCHMARK.json`` against its files: every name finds its file, every
reader declares what the file says, every limit of the contract holds."""

import json
import os
import re

import pytest

from portbench import spec

BENCH = spec.load_json(spec.BENCHMARK)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])


def test_names_units_and_lines():
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[key]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for text in ([c["why"] for c in BENCH["configs"]] + [w["why"] for w in BENCH["workloads"]]
                 + [c["source"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("work", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_finds_its_files(work):
    cell = spec.load_cell(work["name"])
    assert cell.chips in (1, 4) and cell.config["cards"] == cell.chips
    assert spec.driver(cell.config["form"]).run
    assert "setup_s" in [m["name"] for m in cell.end_to_end] and len(cell.end_to_end) >= 2
    assert cell.per_layer and set(cell.check["limits"]) >= {"bad_jobs", "size_excess"}
    for m in cell.end_to_end:
        assert spec.end_to_end(m["name"]).read
    moved = {m["name"] for m in cell.end_to_end}
    assert all(m["moves"] in moved for m in cell.per_layer)


@pytest.mark.parametrize("m", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_reader_declares_the_entry(m):
    r = spec.end_to_end(m["name"])
    assert (r.UNIT, r.BETTER, r.SOURCE) == (m["unit"], m["better"], m["source"])
    assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_reader_declares_the_entry(m):
    r = spec.metric(m["name"])
    assert (r.UNIT, r.BETTER, r.SOURCE, r.LAYER, r.MOVES) == (
        m["unit"], m["better"], m["source"], m["layer"], m["moves"])
    assert tuple(m["workloads"]) == r.WORKLOADS


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(c):
    assert c["file"].startswith("portbench/configs/")
    conf = spec.load_json(os.path.join(spec.ROOT, c["file"]))
    assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"] == []
    assert conf["source"] == c["source"] and "assumed" in conf
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_four_chip_cells_are_few():
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)
