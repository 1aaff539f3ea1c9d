"""BENCHMARK.json against the configuration, traffic, limit and metric
files it names, and the charsets and limits of its names and units."""

import json
import re

import pytest

from lrbench import spec

B = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def one_line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert (spec.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(B["command"]) <= 32 and all(one_line(w) for w in B["command"])
    assert 1 <= len(B["paths"]) <= 16
    for p in B["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (spec.ROOT / p).is_dir() and not p.endswith("_torch")


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = B["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cfg", B["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"]) and one_line(cfg["source"]) and one_line(cfg["why"])
    assert cfg["file"] == f"lrbench/configs/{cfg['name']}.json"
    data = json.loads((spec.ROOT / cfg["file"]).read_text())
    assert data["name"] == cfg["name"] and data["reduced"] == cfg["reduced"]
    assert len(cfg["reduced"]) <= 16 and all(NAME.match(k) for k in cfg["reduced"])
    assert (spec.HERE / "reference" / f"{data['reference']}.py").exists()
    assert any(w["config"] == cfg["name"] for w in B["workloads"])


@pytest.mark.parametrize("w", B["workloads"], ids=lambda w: w["name"])
def test_workload_files(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and one_line(w["why"])
    assert w["chips"] in (1, 4)
    cell = spec.cell(w["name"], B)
    assert cell.traffic["job"] in ("render",)
    assert set(cell.checks["limits"]) == {"off_share", "mean_gap"}
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer


def test_names_are_unique():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in B[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in B["end_to_end"] + B["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in B["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in B["workloads"]) <= max(1, len(B["workloads"]) // 4)


@pytest.mark.parametrize("m", B["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metrics(m):
    assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in B["workloads"]}
    assert set(m.get("workloads", cells)) <= cells


def test_setup_s_is_there_with_its_bound():
    setup = [m for m in B["end_to_end"] if m["name"] == "setup_s"]
    assert len(setup) == 1 and "workloads" not in setup[0] and setup[0]["bound"] <= 0.25


@pytest.mark.parametrize("m", B["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metrics_have_their_reader(m):
    assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert one_line(m["layer"])
    reader = spec.metric_reader(m["name"])
    assert reader.LAYER == m["layer"] and callable(reader.read)
    moves = next(e for e in B["end_to_end"] if e["name"] == m["moves"])
    cells = {w["name"] for w in B["workloads"]}
    assert m["workloads"] and set(m["workloads"]) <= set(moves.get("workloads", cells))
    if m["name"].endswith("_roofline") or "mfu" in m["name"]:
        assert m["unit"] == "%"


def test_every_reader_serves_a_metric():
    used = {spec.quantity(m["name"]) for m in B["per_layer"]}
    assert {p.stem for p in (spec.HERE / "metrics").glob("*.py")} == used


def test_end_to_end_values_are_the_jobs_quantities():
    kinds = {"render": {"samples_per_s", "image_ms_p95"}}
    for w in B["workloads"]:
        cell = spec.cell(w["name"], B)
        for m in cell.end_to_end:
            assert m["name"] == "setup_s" or spec.quantity(m["name"]) in kinds[cell.traffic["job"]]


def test_layers_of_one_name_are_spelt_alike():
    by_lower = {}
    for m in B["per_layer"]:
        by_lower.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_lower.values())
