"""BENCHMARK.json keeps the benchmark's contract: names, units, keys,
limits, and a file for every name it gives."""

import json
import os
import re

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
BENCH = harness.benchmark()
METRIC_KEYS = {"name", "unit", "better", "source", "workloads"}


def one_line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(harness.ROOT, p))
    assert len(BENCH["command"]) <= 32 and all(one_line(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    size = len(json.dumps(BENCH).encode())
    assert size <= 64 * 1024


def test_names_and_units():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["why"]) and one_line(c["source"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert os.path.isfile(os.path.join(harness.ROOT, c["file"]))
        names.append(c["name"])
    assert len(set(names)) == len(names)
    cells = []
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert one_line(w["why"])
        assert os.path.isfile(os.path.join(harness.HERE, "traffic",
                                           w["traffic"] + ".json"))
        cells.append(w["name"])
    assert len(set(cells)) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(cells)
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        for w in m.get("workloads", []):
            assert w in cells


def test_end_to_end():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= METRIC_KEYS | {"bound"} and "bound" in m
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for w in BENCH["workloads"]:
        reported = [m for m in BENCH["end_to_end"] if harness.applies(m, w["name"])]
        assert len(reported) >= 2


def test_per_layer():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= METRIC_KEYS | {"layer", "moves"}
        assert one_line(m["layer"])
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for w in m.get("workloads", []):
            assert harness.applies(e2e[m["moves"]], w)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        assert os.path.isfile(os.path.join(harness.HERE, "metrics",
                                           m["name"] + ".py"))
    for w in BENCH["workloads"]:
        assert any(harness.applies(m, w["name"]) for m in BENCH["per_layer"])


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_file(name):
    from portbench import build

    c = build.read_json("configs", name)
    assert c["name"] == name and "conf" in c and "bert" in c
    bench = next(x for x in BENCH["configs"] if x["name"] == name)
    assert c["reduced"] == bench["reduced"]
    widths = [k for k in c["reduced"] if k.endswith(("_dim", "_rank", "_size"))]
    assert not widths
