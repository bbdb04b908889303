"""Every cell run on a card as the benchmark runs it, at its own size and a
short window: exit 0, a correct result line from the card.  Without a card
each case skips (decided inside the test).

    python3 -m pytest drexbench/test_drexbench_card.py
"""

import json
import subprocess
import sys

import pytest
import torch

from drexbench import catalog

CELLS = [w["name"] for w in catalog.load_benchmark()["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card(card, workload, trace):
    proc = subprocess.run(
        [sys.executable, str(catalog.BENCH_DIR / "run.py"), "--workload", workload,
         "--seed", str(2**31 + 1234 + trace), "--seconds", "5", "--trace", str(trace)],
        cwd=catalog.ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
