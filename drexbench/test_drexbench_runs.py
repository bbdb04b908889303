"""Tiny CPU runs of every traffic mix, pending cells' too: the result line has the contract's
keys, a sound run is correct, and each control, put in the program's
place, is not."""

import json

import pytest
import torch

from drexbench import catalog, control, harness, tiny

CELLS = [w["name"] for w in catalog.with_pending(catalog.load_benchmark())["workloads"]]
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    with tiny.one_thread():
        yield


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_tiny_run_prints_the_contract_line(workload, trace):
    cell = tiny.tiny_cell(workload)
    rec = harness.run_cell(cell, 2**31 + 99, 0.3, bool(trace), CPU)
    line = json.loads(json.dumps(harness.result_line(rec)))
    assert set(line) == KEYS | ({"breakdown"} if trace else set())
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, harness.checks_text(rec)
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    want = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(line["metrics"]) <= want
    if not trace:
        assert set(line["metrics"]) == want
        assert all(m["value"] > 0 for m in line["metrics"].values())
    else:
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    for name, c in line["checks"].items():
        assert c["value"] <= c["limit"], name


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    cell = tiny.tiny_cell(workload)
    got = control.control_readings(cell, 4242, 0.3, CPU)
    assert got["correct"] is True
    limits = cell.traffic["limits"]
    assert any(v > limits[k] for k, v in got["control"].items() if k in limits), got


def test_no_card_no_result(capsys):
    from drexbench import run

    if torch.cuda.is_available():
        pytest.skip("a card is present: run.py runs the cell")
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""
