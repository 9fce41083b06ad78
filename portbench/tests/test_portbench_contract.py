"""BENCHMARK.json and the files it names: names, units and keys within the
contract's characters, every cell's files present, every per-layer
metric's cells reporting the end-to-end metric it moves."""

import json
import os
import re

import pytest

from portbench.cell import BENCHMARK, HERE, ROOT, load_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    with open(BENCHMARK) as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(BENCHMARK) <= 64 * 1024
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
    assert len(bench["command"]) <= 32
    for word in bench["command"]:
        assert LINE.match(word) and not word.startswith("/") and ".." not in word


def test_names_and_units(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"]) and LINE.match(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
        names.append(w["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        assert LINE.match(m["layer"])
    assert len(names) == len(set(names))
    assert {m["name"] for m in bench["end_to_end"]} == {"spp_per_s", "frame_ms_p95",
                                                       "setup_s"}
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)


def test_every_cell_finds_its_files(bench):
    configs = {c["name"]: c for c in bench["configs"]}
    used = set()
    for w in bench["workloads"]:
        cfg = configs[w["config"]]
        used.add(cfg["name"])
        assert cfg["file"].startswith(bench["paths"][0] + "/")
        assert os.path.exists(os.path.join(ROOT, cfg["file"]))
        cell = load_cell(w["name"])
        assert cell.config["name"] == cfg["name"]
        assert set(cfg["reduced"]) <= set(cell.config)
        assert cell.limits, f"{w['name']} has no limits file"
        w_, h_ = cell.resolution
        assert w_ % 16 == 0 and h_ % 8 == 0
    assert used == set(configs)
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))


def test_per_layer_metrics_read_where_their_end_to_end_metric_is(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    layers = {}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        reported = set(e2e[m["moves"]].get("workloads", cells))
        assert set(m.get("workloads", cells)) <= reported
        assert set(m.get("workloads", cells)) <= cells
        assert os.path.exists(os.path.join(HERE, "metrics", m["name"] + ".py"))
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    # metrics of one layer name it letter for letter alike
    assert all(len(v) == 1 for v in layers.values())
    for cell in cells:
        assert any(cell in m.get("workloads", cells) for m in bench["per_layer"])


def test_run_seconds_fit_the_full_check(bench):
    rs = bench["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
