"""Finds everything a cell needs by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix.  The configuration's file is the one ``configs`` gives it; the mix
is ``drexbench/traffic/<traffic>.json``, whose ``driver`` names the
module of ``drexbench/drivers/`` that generates and runs that kind of
traffic; each metric is read by ``drexbench/metrics/<metric>.py``, or,
where there is no such file, by the reader its name names before its
first dot (``device_idle.save`` by ``metrics/device_idle.py``: one
quantity that each cell's metric reads alike).  A
later cell, configuration or metric is a new file and a new entry.

``drexbench/pending.json`` holds entries of the same shape for cells
that are built but not measured (see its ``why``): ``run.py`` never
resolves them, the tests run them tiny through :func:`with_pending`.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib
from dataclasses import dataclass

__all__ = ["ROOT", "BENCH_DIR", "PENDING", "Cell", "load_benchmark", "with_pending", "resolve",
           "metric_reader"]

BENCH_DIR = pathlib.Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
PENDING = BENCH_DIR / "pending.json"
GROUPS = ("configs", "workloads", "end_to_end", "per_layer")


@dataclass(frozen=True)
class Cell:
    name: str
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    chips: int
    end_to_end: list   # metric entries of BENCHMARK.json this cell reports
    per_layer: list


def load_benchmark(path: pathlib.Path | None = None) -> dict:
    with open(path or ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def with_pending(bench: dict) -> dict:
    """``bench`` with the entries of ``pending.json`` added to each group."""
    with open(PENDING) as f:
        pending = json.load(f)
    return {**bench, **{g: bench[g] + pending.get(g, []) for g in GROUPS}}


def _reported(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(workload: str, bench: dict | None = None) -> Cell:
    """The cell named ``workload``, with its configuration and mix loaded."""
    bench = bench or load_benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; known: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    conf = configs[w["config"]]
    with open(ROOT / conf["file"]) as f:
        config = json.load(f)
    with open(BENCH_DIR / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    return Cell(
        name=workload,
        config_name=w["config"],
        config=config,
        traffic_name=w["traffic"],
        traffic=traffic,
        chips=int(w["chips"]),
        end_to_end=[m for m in bench["end_to_end"] if _reported(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _reported(m, workload)],
    )


def driver(cell: Cell):
    """The module that runs this cell's kind of traffic."""
    return importlib.import_module(f"drexbench.drivers.{cell.traffic['driver']}")


def metric_reader(name: str):
    """``read(record) -> float | None`` of ``drexbench/metrics/<name>.py``,
    else of ``metrics/<the name up to its first dot>.py``."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    if not path.exists():
        path = BENCH_DIR / "metrics" / f"{name.split('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(f"drexbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
