"""``BENCHMARK.json`` against the benchmark's contract, and the cell files
the harness finds by name."""

import json
import os
import re

import pytest

from h100_bench import harness

BENCH = os.path.join(harness.ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    with open(BENCH) as f:
        return json.load(f)


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and \
        "\n" not in text and "\t" not in text


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(BENCH) <= 64 * 1024
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
        assert os.path.isdir(os.path.join(harness.ROOT, p))
    assert 1 <= len(bench["command"]) <= 32
    for word in bench["command"]:
        assert _line(word) and not word.startswith("/") and ".." not in word
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51


def test_names_and_units(bench):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
    assert len(set(names)) == len(names)
    metric_names = [m["name"] for m in bench["end_to_end"] +
                    bench["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        assert _line(w["why"])
    for c in bench["configs"]:
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_entry_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert _line(m["layer"])


def test_every_cell_reports_what_it_must(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    four = [w for w in bench["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(bench["workloads"]) // 4)
    for w in bench["workloads"]:
        mine = harness.metrics_of(bench, w["name"], False)
        assert "setup_s" in [m["name"] for m in mine]
        assert len(mine) >= 2
        layer = harness.metrics_of(bench, w["name"], True)
        assert layer
        for m in layer:
            assert m["moves"] in [x["name"] for x in mine], m["name"]
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}


def test_cell_files_found_by_name(bench):
    files = [c["file"] for c in bench["configs"]]
    assert len(set(files)) == len(files)
    for c in bench["configs"]:
        assert c["file"].startswith(bench["paths"][0] + "/")
        tree = harness._load_json(harness.ROOT, c["file"])
        assert tree["name"] == c["name"] and tree["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        cell = harness.load_cell(bench, w["name"])
        assert os.path.isfile(os.path.join(
            harness.BENCH_DIR, "drivers", cell.traffic["driver"] + ".py"))
        assert cell.limits["limits"]
    for m in bench["per_layer"]:
        assert os.path.isfile(os.path.join(harness.BENCH_DIR, "metrics",
                                           m["name"] + ".py"))


def test_layer_readers_read_nothing_from_nothing(bench):
    """A reader with nothing to read returns None, never 0."""
    for m in bench["per_layer"]:
        assert harness.read_layer_metric(m["name"], {}) is None
