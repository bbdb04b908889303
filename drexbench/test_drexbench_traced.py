"""A traced run of each cell, tiny and on the CPU: the profiler covers a
second window after the measured one, so the host-clock and span metrics
never read a profiled operation."""

import pytest
import torch

from drexbench import catalog, harness, tiny

CELLS = [w["name"] for w in catalog.with_pending(catalog.load_benchmark())["workloads"]]
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    with tiny.one_thread():
        yield


@pytest.mark.parametrize("workload", CELLS)
def test_traced_run_profiles_a_second_window(workload):
    """Host-clock and span metrics read the untraced window; the profiler
    covers only the window after it, whose operations are counted apart."""
    cell = tiny.tiny_cell(workload)
    rec = harness.run_cell(cell, 2**31 + 3, 0.3, True, CPU)
    w0, w1 = rec.window_ns
    assert w0 < w1 <= rec.dev.t0_ns < rec.dev.t1_ns
    assert rec.facts["n_ops"] >= 1
    traced = rec.facts.get("traced_ops", rec.facts.get("traced_encode_bytes"))
    assert traced and traced > 0
    assert harness.result_line(rec)["correct"] is True
    if "place_many" in {s.name for s in rec.spans.spans}:
        timed = rec.spans.seconds("place_many", w0, w1)
        assert 0 < len(timed) < len(rec.spans.seconds("place_many"))
