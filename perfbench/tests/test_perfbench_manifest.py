"""``BENCHMARK.json`` against the benchmark's contract, and every file a
cell names found by its name. CPU only; imports no JAX."""

import json
import os
import re
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path[:0] = [p for p in (ROOT, os.path.join(ROOT, "src"))
                if p not in sys.path]

from perfbench import bench  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def man():
    return bench.manifest()


def test_manifest_has_the_contracts_keys(man):
    assert set(man) == KEYS
    assert man["command"] == ["python3", "perfbench/run.py"]
    assert man["paths"] == ["perfbench"]
    assert 1 <= man["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_entries_have_just_their_keys(man):
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                           "source"}
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                           "layer", "moves"}


def test_names_and_units_keep_to_the_allowed_characters(man):
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in man[k]]
    names += [w["config"] for w in man["workloads"]]
    names += [w["traffic"] for w in man["workloads"]]
    names += [r for c in man["configs"] for r in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [x["name"] for x in man[k]]
        assert len(got) == len(set(got))
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in man["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
    for text in [x["why"] for k in ("configs", "workloads") for x in man[k]] \
            + [m["layer"] for m in man["per_layer"]] \
            + [c["source"] for c in man["configs"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_bounds_and_cells(man):
    for m in man["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m
    assert any(m["name"] == "setup_s" for m in man["end_to_end"])
    cells = man["workloads"]
    assert 1 <= len(cells) <= 24
    assert all(w["chips"] in (1, 4) for w in cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(pairs) == len(set(pairs))
    used = {w["config"] for w in cells}
    assert used == {c["name"] for c in man["configs"]}


def test_every_cell_reports_setup_another_end_to_end_and_a_layer(man):
    e2e = {m["name"]: m for m in man["end_to_end"]}
    for w in man["workloads"]:
        got = [m["name"] for m in bench.metrics_of(man, w["name"],
                                                   "end_to_end")]
        assert "setup_s" in got and len(got) >= 2
        layers = bench.metrics_of(man, w["name"], "per_layer")
        assert layers
        for m in layers:
            assert m["moves"] in got, (w["name"], m["name"])
        for m in man["per_layer"]:
            assert m["moves"] in e2e


def test_per_layer_names_share_a_layer_name_letter_for_letter(man):
    layers = {m["layer"] for m in man["per_layer"]}
    text = open(os.path.join(ROOT, "PERF.md")).read()
    for layer in layers:
        assert layer in text, layer


@pytest.mark.parametrize("kind", ["configs", "traffic", "limits",
                                  "reference", "readers"])
def test_every_cell_finds_its_files_by_name(man, kind):
    for w in man["workloads"]:
        cfg = json.load(open(os.path.join(
            ROOT, "perfbench", "configs", w["config"] + ".json")))
        if kind == "configs":
            assert cfg["name"] == w["config"]
            assert os.path.exists(os.path.join(
                ROOT, "perfbench", "configs", w["config"] + ".py"))
            assert os.path.exists(os.path.join(
                ROOT, "perfbench", "families", cfg["family"] + ".py"))
        elif kind == "traffic":
            t = bench.read_json("traffic", w["traffic"] + ".json")
            assert "kind" in t and "timing_steps" in t
        elif kind == "limits":
            limits = bench.read_json("limits", w["name"] + ".json")
            assert limits and all(v >= 0 for v in limits.values())
        elif kind == "reference":
            assert os.path.exists(os.path.join(
                ROOT, "perfbench", "reference", w["config"] + ".py"))
        else:
            for m in bench.metrics_of(man, w["name"], "per_layer"):
                assert callable(bench.load_reader(m["name"]))


def test_config_files_lie_under_paths_and_name_their_cut(man):
    for c in man["configs"]:
        assert c["file"].startswith("perfbench/configs/")
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]


def test_the_check_fits_the_run_budget(man):
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (man["run_seconds"] + 60) + cells * 180 + 1200 <= 43200
