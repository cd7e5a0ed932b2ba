"""BENCHMARK.json against the benchmark's contract and against the files
it names: names, units and lengths; each per-layer metric's end-to-end
metric reported by all its cells; the share of four-chip cells; every
cell's configuration, traffic, driver and metric files present; the time
a full check of 24 cells at ``run_seconds`` would take."""
import json
import re

import pytest

from bench.lib import common

MAN = common.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "bench/run.py"]
    assert MAN["paths"] == ["bench"]
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_text(kind):
    names = [e["name"] for e in MAN[kind]]
    assert len(names) == len(set(names))
    for e in MAN[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
            assert e["source"] in SOURCES
        for key in ("why", "layer", "source"):
            if key in e:
                assert TEXT.match(e[key]), (e["name"], key)


def test_entry_keys():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_each_metric_moves_one_reported_by_its_cells():
    cells = {w["name"] for w in MAN["workloads"]}
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e
    for m in MAN["per_layer"]:
        moves = e2e[m["moves"]]
        for cell in m.get("workloads", sorted(cells)):
            assert cell in cells
            assert cell in moves.get("workloads", [cell]), (m["name"], cell)
    for cell in cells:
        assert len(common.metrics_of(MAN, cell, "end_to_end")) >= 2
        assert common.metrics_of(MAN, cell, "per_layer")


def test_four_chip_share_and_config_use():
    four = [w for w in MAN["workloads"] if w["chips"] == 4]
    assert all(w["chips"] in (1, 4) for w in MAN["workloads"])
    assert len(four) <= max(1, len(MAN["workloads"]) // 4)
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_cell_files_agree_with_the_manifest(cell):
    w = next(w for w in MAN["workloads"] if w["name"] == cell)
    files = common.cell_files(cell)
    c = files["cell"]
    assert (c["config"], c["traffic"], c["chips"]) == (w["config"], w["traffic"], w["chips"])
    assert c["why"] and c["limits"]
    assert (common.BENCH / "drivers" / f"{c['driver']}.py").exists()
    conf = next(x for x in MAN["configs"] if x["name"] == w["config"])
    assert conf["file"] == f"bench/configs/{w['config']}.json"
    assert files["config"]["reduced"] == conf["reduced"]
    assert files["config"]["source"] == conf["source"]
    for m in common.metrics_of(MAN, cell, "per_layer"):
        assert (common.BENCH / "metrics" / f"{m['name']}.py").exists()


def test_full_check_fits_the_day():
    rs = MAN["run_seconds"]
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
