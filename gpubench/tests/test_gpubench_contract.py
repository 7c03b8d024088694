"""BENCHMARK.json and the files it names: names, units, readers and
limits found by name."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def all_names():
    for c in BENCH["configs"]:
        yield c["name"]
    for w in BENCH["workloads"]:
        yield from (w["name"], w["config"], w["traffic"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        yield m["name"]


@pytest.mark.parametrize("name", sorted(set(all_names())))
def test_gpubench_names_use_the_allowed_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_gpubench_units_are_short_and_plain(metric):
    m = next(x for x in BENCH["end_to_end"] + BENCH["per_layer"] if x["name"] == metric)
    assert UNIT.match(m["unit"]), m["unit"]
    assert m["better"] in ("lower", "higher")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_gpubench_every_cell_finds_its_files(cell):
    from gpubench import check, harness

    wl = harness.load("workloads", cell)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert wl["config"] == entry["config"] and wl["chips"] == entry["chips"]
    cf = harness.load("configs", wl["config"])
    conf = next(c for c in BENCH["configs"] if c["name"] == wl["config"])
    assert (ROOT / conf["file"]).exists() and conf["source"] == cf["source"]
    assert conf["reduced"] == cf["reduced"]
    for mod in (f"gpubench.families.{cf['family']}", f"gpubench.reference.{cf['family']}",
                f"gpubench.counts.{cf['counts']}"):
        __import__(mod)
    assert set(wl["limits"]) == set(check.NUMBERS)
    assert all(0 < v < 1 for v in wl["limits"].values())


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_gpubench_every_per_layer_metric_has_a_reader(metric):
    from gpubench import harness

    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    assert callable(harness.reader(metric))
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", cells)) <= cells


def test_gpubench_paths_and_command():
    assert BENCH["paths"] == ["gpubench"]
    assert BENCH["command"][:2] == ["python3", "-m"] and BENCH["command"][2].startswith("gpubench.")
    assert {"setup_s", "ns_per_day"} <= {m["name"] for m in BENCH["end_to_end"]}
    assert all(m["bound"] <= 0.25 and m["bound"] >= 0.01 for m in BENCH["end_to_end"])
    assert 1 <= BENCH["run_seconds"] <= 51
