"""BENCHMARK.json against the benchmark contract, alone and with the
entries of pending.json, and every cell resolved from its files by name."""

import json
import re

import pytest

from drexbench import catalog

BENCH = catalog.load_benchmark()
WITH_PENDING = catalog.with_pending(BENCH)
BENCHES = {"committed": BENCH, "with_pending": WITH_PENDING}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CELLS = [w["name"] for w in BENCH["workloads"]]
PENDING_CELLS = [w["name"] for w in WITH_PENDING["workloads"] if w["name"] not in CELLS]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "drexbench/run.py"]
    assert BENCH["paths"] == ["drexbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("which", sorted(BENCHES))
def test_names_units_and_lines(which):
    bench = BENCHES[which]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[group]]
        assert len(names) == len(set(names)), group
        for e in bench[group]:
            assert NAME.match(e["name"]), e["name"]
            for key in ("why", "layer", "source"):
                if key in e:
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES


@pytest.mark.parametrize("which", sorted(BENCHES))
def test_configs(which):
    bench = BENCHES[which]
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("drexbench/") and c["file"].endswith(".json")
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        with open(catalog.ROOT / c["file"]) as f:
            conf = json.load(f)
        assert conf["name"] == c["name"] and sorted(conf["reduced"]) == sorted(c["reduced"])
        assert any(w["config"] == c["name"] for w in bench["workloads"])
    assert len({c["file"] for c in bench["configs"]}) == len(bench["configs"])


@pytest.mark.parametrize("which", sorted(BENCHES))
def test_metrics(which):
    bench = BENCHES[which]
    cells = [w["name"] for w in bench["workloads"]]
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        for w in m.get("workloads", cells):
            assert w in cells
            moved = e2e[m["moves"]]
            assert w in moved.get("workloads", cells), (m["name"], w)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("workload", CELLS + PENDING_CELLS)
def test_cell_resolves_from_its_files(workload):
    cell = catalog.resolve(workload, WITH_PENDING)
    assert cell.chips == 1
    driver = catalog.driver(cell)
    assert callable(driver.run)
    kinds = {"ckpt_save": "checkpoint", "ckpt_restore": "checkpoint", "place_replay": "placement"}
    assert kinds[cell.traffic["driver"]] == cell.config["kind"]
    names = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(catalog.metric_reader(m["name"]))
    assert cell.traffic["limits"]


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        catalog.resolve("no.such.cell")


@pytest.mark.parametrize("workload", PENDING_CELLS)
def test_pending_cell_is_not_run(workload):
    """A pending cell is in no group of BENCHMARK.json, and run.py's
    resolution refuses it."""
    with pytest.raises(KeyError):
        catalog.resolve(workload)
    pending = {e["name"] for g in catalog.GROUPS for e in WITH_PENDING[g] if e not in BENCH[g]}
    assert not pending & {e["name"] for g in catalog.GROUPS for e in BENCH[g]}
