"""The benchmark's files: BENCHMARK.json, each cell's, configuration's and
metric's file parse and agree with one another."""

import importlib
import importlib.util
import json
import re

import pytest

from ntp_bench.common import BENCH, ROOT

BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _reader(name):
    spec = importlib.util.spec_from_file_location(f"reader_{name}",
                                                  BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_top_level_keys_and_limits():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs", "workloads",
                              "end_to_end", "per_layer"}
    assert BENCHMARK["paths"] == ["ntp_bench"]
    assert 1 <= BENCHMARK["run_seconds"] <= 51
    cells = len(BENCHMARK["workloads"])
    assert 1 <= cells <= 24 and 1 <= len(BENCHMARK["configs"]) <= 24
    assert sum(w["chips"] == 4 for w in BENCHMARK["workloads"]) <= max(1, cells // 4)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("w", BENCHMARK["workloads"], ids=lambda w: w["name"])
def test_cell_file_parses_and_matches(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    f = json.loads((BENCH / "workloads" / f"{w['name']}.json").read_text())
    assert {k: f[k] for k in w} == w
    assert (BENCH / "traffic" / f"{f['driver']}.py").is_file()
    assert f["limits"] and all(v >= 0 for v in f["limits"].values())


@pytest.mark.parametrize("c", BENCHMARK["configs"], ids=lambda c: c["name"])
def test_config_file_parses_and_matches(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    f = json.loads((ROOT / c["file"]).read_text())
    assert f["name"] == c["name"] and f["source"] == c["source"]
    assert f["reduced"] == c["reduced"] == []
    assert (BENCH / "reference" / f"{f['network']}.py").is_file()
    assert (BENCH / "cost_models" / f"{f['network']}.py").is_file()
    assert isinstance(f["net_kwargs"], dict)
    assert any(w["config"] == c["name"] for w in BENCHMARK["workloads"])


TRAINING = [w["name"] for w in BENCHMARK["workloads"]
            if "objective" in json.loads((BENCH / "workloads" / f"{w['name']}.json").read_text())]


@pytest.mark.parametrize("cell", TRAINING)
def test_a_training_cells_objective_states_where_its_readout_runs(cell):
    f = json.loads((BENCH / "workloads" / f"{cell}.json").read_text())
    assert (BENCH / "objectives" / f"{f['objective']['name']}.py").is_file()
    assert "readout_on_kernel" not in f["objective"]
    obj = importlib.import_module(f"ntp_bench.objectives.{f['objective']['name']}")
    assert obj.READOUT_ON_KERNEL in (True, False)


def test_pairs_of_config_and_traffic_are_unique():
    pairs = [(w["config"], w["traffic"]) for w in BENCHMARK["workloads"]]
    assert len(set(pairs)) == len(pairs)


@pytest.mark.parametrize("m", BENCHMARK["end_to_end"] + BENCHMARK["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    if "bound" in m:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in BENCHMARK["workloads"]}
    assert set(m.get("workloads", cells)) <= cells


@pytest.mark.parametrize("m", BENCHMARK["per_layer"], ids=lambda m: m["name"])
def test_per_layer_moves_an_end_to_end_metric_its_cells_report(m):
    e2e = {e["name"]: e for e in BENCHMARK["end_to_end"]}
    assert m["moves"] in e2e
    all_cells = [w["name"] for w in BENCHMARK["workloads"]]
    reporting = set(e2e[m["moves"]].get("workloads", all_cells))
    assert set(m["workloads"]) <= reporting
    reader = _reader(m["name"])
    assert reader.MOVES == m["moves"]
    assert callable(reader.read)


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in BENCHMARK["workloads"]:
        e2e = [e["name"] for e in BENCHMARK["end_to_end"]
               if w["name"] in e.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in m["workloads"] for m in BENCHMARK["per_layer"])


def test_layer_names_are_one_line():
    for m in BENCHMARK["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
