"""BENCHMARK.json and the files it names: a cell's configuration, traffic,
limits and metric readers, each found by its name."""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import NamedTuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Cell(NamedTuple):
    name: str
    workload: dict  # the BENCHMARK.json entry
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<traffic>.json
    checks: dict  # checks/<cell>.json: the limits of `correct`
    end_to_end: list  # BENCHMARK.json entries this cell reports untraced
    per_layer: list  # ... and traced


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark():
    return load_json(ROOT / "BENCHMARK.json")


def applies(metric, cell_name):
    """Whether a metric entry is reported in this cell: the cells its
    `workloads` names, or every cell where it has none."""
    return cell_name in metric.get("workloads", [cell_name])


def cell(name, bench=None) -> Cell:
    bench = bench or benchmark()
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")
    w = by_name[name]
    e2e = [m for m in bench["end_to_end"] if applies(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if applies(m, name) and m["moves"] in e2e_names]
    return Cell(
        name=name, workload=w,
        config=load_json(HERE / "configs" / f"{w['config']}.json"),
        traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
        checks=load_json(HERE / "checks" / f"{name}.json"),
        end_to_end=e2e, per_layer=per_layer)


def quantity(name):
    """What a metric's name measures: the name up to its first dot. One
    quantity may be split by cells into metrics of their own bounds
    (`device_idle_pct.render`, `device_idle_pct.grad`); BENCHMARK.json
    holds what each moves."""
    return name.split(".")[0]


def metric_reader(name):
    """metrics/<quantity>.py, the one reader of every metric of that
    quantity, loaded by path."""
    q = quantity(name)
    path = HERE / "metrics" / f"{q}.py"
    spec = importlib.util.spec_from_file_location(f"lrbench_metric_{q}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference(name):
    """The plain reference module a configuration names."""
    return importlib.import_module(f"lrbench.reference.{name}")

