"""BENCHMARK.json against the contract's form, and every file it names found
by name."""

import json
import re

import pytest

from portbench import harness

SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51


@pytest.mark.parametrize("name", [x["name"] for x in SPEC["configs"] + SPEC["workloads"]
                                  + METRICS]
                         + [w[k] for w in SPEC["workloads"] for k in ("config", "traffic")]
                         + [k for c in SPEC["configs"] for k in c["reduced"]])
def test_names(name):
    assert NAME.match(name), name


def test_names_unique():
    for group in (SPEC["configs"], SPEC["workloads"], METRICS):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entry(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    per_layer = metric in SPEC["per_layer"]
    keys = {"name", "unit", "better", "source"} | (
        {"layer", "moves"} if per_layer else {"bound"})
    assert keys <= set(metric) <= keys | {"workloads"}
    if per_layer:
        assert metric["moves"] in [m["name"] for m in SPEC["end_to_end"]]
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
        assert 0 < len(metric["layer"]) <= 200
    else:
        assert metric["source"] in ("device_trace", "host_clock")
        assert 0.01 <= metric["bound"] <= 0.25
    for w in metric.get("workloads", []):
        assert w in [x["name"] for x in SPEC["workloads"]]


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(cell):
    c = harness.Cell.load(cell["name"])
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] in (1, 4) and len(cell["why"]) <= 200
    assert c.traffic["entry"] == "solve"
    assert (harness.BENCH / "kinds" / f"{c.config['kind']}.py").is_file()
    assert (harness.BENCH / "reference" / f"{c.config['kind']}.py").is_file()
    assert c.limits["rel_err"] > 0
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "throughput"}
    assert c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(harness.reader(m["name"]))


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_config_entry(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert config["file"].startswith("portbench/")
    body = json.loads((harness.ROOT / config["file"]).read_text())
    assert body["reduced"] == config["reduced"]
    for text in (config["source"], config["why"]):
        assert 0 < len(text) <= 200 and "\n" not in text and "\t" not in text
    assert any(w["config"] == config["name"] for w in SPEC["workloads"])
