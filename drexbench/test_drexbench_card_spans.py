"""The program's spans on a card: both checkpoint cells at their own size,
traced for 5 s.  The card's copies lie inside the program spans that
issue them (so the spans and the profiler share a clock), and the
restore's idle time is named by the program's spans, not by the
benchmark's own.  Without a card each case skips (decided inside the
test).

    python3 -m pytest -s drexbench/test_drexbench_card_spans.py
"""

import json

import pytest
import torch

from drexbench import catalog, harness, program_spans, tiny


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    with tiny.one_thread():
        yield torch.device("cuda", 0)


@pytest.mark.parametrize("workload", ["ckpt.rwkv6_1b6.save", "ckpt.rwkv6_1b6.restore_node_lost"])
def test_program_spans_on_the_card(card, workload):
    cell = catalog.resolve(workload)
    driver = cell.traffic["driver"]
    rec = program_spans.run(cell, 2**31 + 4321, 5, True, card)
    assert harness.result_line(rec)["correct"] is True, harness.checks_text(rec)
    pattern, name = program_spans.CLOCK_CHECKS[driver]
    inside = program_spans.inside_share(rec.dev, pattern, rec.facts["program_spans"], name)
    fallback = program_spans.fallback_idle_share(rec.dev)
    values = {m: program_spans.read(rec, m) for m, (_, root) in program_spans.METRICS.items()
              if root == program_spans.ROOT_SPAN[driver]}
    print(json.dumps({"workload": workload, "device": torch.cuda.get_device_name(card),
                      f"{pattern} inside {name}": inside, "fallback_idle_share": fallback,
                      "busy_s": rec.dev.busy_s, "window_s": rec.dev.window_s,
                      "metrics": values, "idle_gaps": rec.dev.breakdown()["idle_gaps"]}))
    assert all(v is not None and v >= 0 for v in values.values()), values
    assert inside is not None and inside >= 0.95
    if driver == "ckpt_restore":
        assert fallback is not None and fallback <= 0.05
