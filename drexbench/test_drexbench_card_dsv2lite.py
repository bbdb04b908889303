"""The DeepSeek-V2-Lite restore cell on a card, at its own size, traced for
5 s with the program's spans: every restore byte-exact, a few dozen
``_load_groups`` calls a restore against 923 leaves, and the card's
host-to-device copies inside the ``ec.stage`` spans that issue them.
Without a card it skips (decided inside the test).

    python3 -m pytest -s drexbench/test_drexbench_card_dsv2lite.py
"""

import json

import pytest
import torch

from drexbench import catalog, harness, program_spans, tiny

CELL = "ckpt.dsv2lite_ep8.restore_node_lost"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    with tiny.one_thread():
        yield torch.device("cuda", 0)


def test_dsv2lite_restore_on_the_card(card):
    cell = catalog.resolve(CELL)
    held = []
    rec = program_spans.run(cell, 2**31 + 2828, 5, True, card,
                            hooks={"checkpointer": held.append})
    (ck,) = held
    checks = {c.name: c.value for c in rec.checks}
    restores = int(cell.traffic["warmup_restores"]) + rec.facts["restores_compared"]
    n_leaves = len(cell.config["payload"]["leaves"])
    inside = program_spans.inside_share(rec.dev, "Memcpy HtoD", rec.facts["program_spans"],
                                        "ec.stage")
    per_restore = {k: ck.stats[k] / restores for k in
                   ("restore_batches", "restore_staged_bytes", "restore_pad_bytes",
                    "restore_buffer_wait_s")}
    print(json.dumps({"workload": CELL, "device": torch.cuda.get_device_name(card),
                      "restores": restores, "per_restore": per_restore,
                      "Memcpy HtoD inside ec.stage": inside,
                      "metrics": harness.result_line(rec)["metrics"], "checks": checks}))
    assert harness.result_line(rec)["correct"] is True, harness.checks_text(rec)
    assert checks["restore_mismatch_bytes"] == 0
    assert ck.stats["restore_batches"] % restores == 0
    assert per_restore["restore_batches"] <= 48 < n_leaves
    assert inside is not None and inside >= 0.95
