"""What a cell is made of, found by the names in ``BENCHMARK.json``.

A configuration is ``configs/<name>.json``, a traffic mix
``traffic/<name>.json`` and a metric ``metrics/<name>.py`` (a function
``read(run)`` that returns a number, or None where the run has nothing
for it to read).  Adding a cell, a configuration or a metric thus adds
files and entries and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # the entries of BENCHMARK.json this cell reports
    per_layer: list
    bench_dir: str = BENCH_DIR


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, cell: str, e2e_names: set) -> bool:
    """Whether ``cell`` reports ``metric``: it is listed, or the metric
    lists no cells (then every cell that reports what it moves)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def find_cell(name: str, bench: dict | None = None, bench_dir: str = BENCH_DIR) -> Cell:
    bench = bench if bench is not None else load_json(os.path.join(os.path.dirname(bench_dir),
                                                                   "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[name]
    config = load_json(os.path.join(bench_dir, "configs", w["config"] + ".json"))
    traffic = load_json(os.path.join(bench_dir, "traffic", w["traffic"] + ".json"))
    e2e = [m for m in bench["end_to_end"] if reports(m, name, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if reports(m, name, names)]
    return Cell(name, int(w["chips"]), config, traffic, e2e, per_layer, bench_dir)


def reader(metric: str, bench_dir: str = BENCH_DIR):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = os.path.join(bench_dir, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location("bench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(entries: list, run, bench_dir: str = BENCH_DIR) -> dict:
    """{name: {"value", "unit"}} of the metrics whose readers find something."""
    out = {}
    for m in entries:
        v = reader(m["name"], bench_dir)(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out
