"""BENCHMARK.json against the benchmark's rules, and the discovery of
every piece a cell names, by name."""

import os
import re

import pytest

from .cpu_run import BENCH  # noqa: F401  (puts the harness on sys.path)
from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}

MAN = harness.manifest()
CELLS = {w["name"]: w for w in MAN["workloads"]}
E2E = {m["name"]: m for m in MAN["end_to_end"]}


def line_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def reports(metric, cell):
    return cell in metric.get("workloads", [cell])


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= MAN["run_seconds"] <= 51
    assert isinstance(MAN["run_seconds"], int)
    assert 1 <= len(MAN["command"]) <= 32
    assert all(line_ok(w) for w in MAN["command"])
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert os.path.getsize(harness.MANIFEST) <= 64 * 1024


def test_command_stays_in_paths():
    for word in MAN["command"][1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in MAN["paths"])


@pytest.mark.parametrize("c", MAN["configs"], ids=lambda c: c["name"])
def test_config_entry(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(c["name"])
    assert line_ok(c["source"]) and line_ok(c["why"])
    assert any(c["file"].startswith(p + "/") for p in MAN["paths"])
    assert os.path.exists(os.path.join(harness.ROOT, c["file"]))
    assert len(c["reduced"]) <= 16
    assert any(w["config"] == c["name"] for w in MAN["workloads"])
    assert harness.config(MAN, c["name"])["name"] == c["name"]


def test_configs_have_their_own_files():
    files = [c["file"] for c in MAN["configs"]]
    assert len(set(files)) == len(files)


@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_entry_and_discovery(name):
    w = CELLS[name]
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert w["chips"] in (1, 4) and line_ok(w["why"])
    assert any(c["name"] == w["config"] for c in MAN["configs"])
    mix = harness.traffic(w["traffic"])
    assert harness.kind(mix["kind"]).run
    lim = harness.limits(name)
    assert lim and all(v >= 0 for v in lim.values())
    e2e = [m["name"] for m in harness.metrics_of(MAN, "end_to_end", name)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.metrics_of(MAN, "per_layer", name)


def test_cell_pairs_unique():
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert sum(w["chips"] == 4 for w in MAN["workloads"]) <= max(
        1, len(MAN["workloads"]) // 4)


def test_names_unique():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in MAN[group]]
        assert len(set(names)) == len(names)
    names = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(set(names)) == len(names)


@pytest.mark.parametrize("m", MAN["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metric(m):
    assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                      "source"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25
    assert all(c in CELLS for c in m.get("workloads", []))
    assert any(reports(m, c) for c in CELLS)


def test_setup_s():
    assert E2E["setup_s"]["bound"] <= 0.25
    assert "workloads" not in E2E["setup_s"]


@pytest.mark.parametrize("m", MAN["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric(m):
    assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                      "layer", "moves"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert m["source"] in SOURCES and line_ok(m["layer"])
    assert m["moves"] in E2E
    cells = m.get("workloads", list(CELLS))
    assert cells and all(c in CELLS for c in cells)
    # every cell the metric lists reports the metric it moves
    assert all(reports(E2E[m["moves"]], c) for c in cells)
    assert callable(harness.metric_reader(m["name"]).read)
    if m["name"].endswith("_roofline") or "roofline" in m["name"] \
            or "mfu" in m["name"]:
        assert m["unit"] == "%"


def test_each_layer_named_once():
    layers = {}
    for m in MAN["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
