"""The program's spans read by the benchmark (``program_spans.py``), in
tiny traced runs of the checkpoint cells on the CPU: every number of
``METRICS`` there, the split of the save's encode-and-copy adding up to
the checkpointer's own count, no span in an untraced run, and an idle
gap named after the program span around it."""

import pytest
import torch

from drexbench import catalog, harness, program_spans, tiny
from drexbench.devtrace import DeviceTrace
from repro_torch import telemetry
from repro_torch.telemetry import SpanRecord

CPU = torch.device("cpu")
SAVE, RESTORE = "ckpt.rwkv6_1b6.save", "ckpt.rwkv6_1b6.restore_node_lost"
ROOT = {w: program_spans.ROOT_SPAN[tiny.tiny_cell(w).traffic["driver"]] for w in (SAVE, RESTORE)}


@pytest.fixture(autouse=True)
def _one_thread():
    with tiny.one_thread():
        yield


def _metrics(workload):
    return [m for m, (_, root) in program_spans.METRICS.items() if root == ROOT[workload]]


@pytest.mark.parametrize("workload", [SAVE, RESTORE])
def test_traced_tiny_run_reads_every_program_span_metric(workload):
    rec = program_spans.run(tiny.tiny_cell(workload), 2**31 + 17, 0.3, True, CPU)
    assert harness.result_line(rec)["correct"] is True
    for m in _metrics(workload):
        value = program_spans.read(rec, m)
        assert isinstance(value, float) and value >= 0, m
    # the measured window's operations, not the traced window's
    w0, w1 = rec.window_ns
    roots = [s for s in rec.facts["program_spans"] if s.name == ROOT[workload]]
    timed = [s for s in roots if w0 <= s.start_ns and s.end_ns <= w1]
    assert len(timed) == rec.facts["n_ops"] < len(roots)
    # the other cell's spans are not there
    for m in set(program_spans.METRICS) - set(_metrics(workload)):
        assert program_spans.read(rec, m) is None, m


def test_encode_and_d2h_split_the_checkpointers_encode_copy():
    rec = program_spans.run(tiny.tiny_cell(SAVE), 2**31 + 23, 0.3, True, CPU)
    both = program_spans.read(rec, "save.encode_ms") + program_spans.read(rec, "save.d2h_ms")
    encode_copy = catalog.metric_reader("save.encode_copy_ms")(rec)
    assert 0 < both <= encode_copy * 1.05 + 1.0


@pytest.mark.parametrize("workload", [SAVE, RESTORE])
def test_untraced_run_records_no_program_span(workload):
    seen = []

    def hook(ck):
        seen.append(telemetry.span("a") is telemetry.span("b"))

    cell = tiny.tiny_cell(workload)
    rec = harness.run_cell(cell, 2**31 + 29, 0.3, True, CPU, hooks={"checkpointer": hook})
    assert seen == [True] and "program_spans" not in rec.facts
    assert all(program_spans.read(rec, m) is None for m in program_spans.METRICS)
    rec = program_spans.run(cell, 2**31 + 29, 0.3, False, CPU, tracing=False)
    assert "program_spans" not in rec.facts


def _span(name, start, end, op=1, thread=1):
    return SpanRecord(name, start, end, thread, span_id=start, parent_id=None, op=op)


def test_a_gap_takes_the_name_of_the_program_span_around_it():
    dev = DeviceTrace(t0_ns=0, t1_ns=1000, device=[("copy", 0, 100), ("copy", 900, 1000)],
                      spans=[("drexbench restore, no profiled host operation", 0, 1000)])
    assert dev.breakdown()["idle_gaps"] == [
        ["drexbench restore, no profiled host operation", 800 / 1e9]]
    program = [_span("ckpt.restore", 0, 1000), _span("ckpt.restore.gather", 150, 850)]
    dev.spans = [(s.name, s.start_ns, s.end_ns) for s in program] + dev.spans
    assert dev.breakdown()["idle_gaps"] == [["ckpt.restore.gather", 800 / 1e9]]
    assert program_spans.fallback_idle_share(dev) == 0.0


def test_a_gap_outside_every_span_counts_as_unnamed():
    """Gaps under the benchmark's span alone and under no span at all
    both count against the program's spans."""
    dev = DeviceTrace(t0_ns=0, t1_ns=1000, device=[
        ("copy", 0, 100), ("copy", 300, 400), ("copy", 600, 700), ("copy", 900, 1000)],
        spans=[("ckpt.restore.gather", 100, 300),
               ("drexbench restore, no profiled host operation", 400, 600)])
    assert sorted(dev.breakdown()["idle_gaps"]) == sorted([
        ["ckpt.restore.gather", 200 / 1e9],
        ["drexbench restore, no profiled host operation", 200 / 1e9],
        ["host, outside any profiled operation", 200 / 1e9]])
    assert program_spans.fallback_idle_share(dev) == 400 / 600


def test_inside_share_clips_and_merges():
    dev = DeviceTrace(t0_ns=0, t1_ns=1000, device=[
        ("Memcpy HtoD (Pageable -> Device)", 100, 200),   # inside, two spans overlap it
        ("Memcpy HtoD (Pageable -> Device)", 290, 310),   # half inside
        ("Memcpy HtoD (Pageable -> Device)", 990, 1100),  # clipped to 10 ns, outside
        ("kernel", 0, 1000),
    ])
    spans = [_span("ec.stage", 90, 150), _span("ec.stage", 140, 205),
             _span("ec.stage", 300, 400), _span("other", 0, 1000)]
    assert program_spans.inside_share(dev, "Memcpy HtoD", spans, "ec.stage") == 110 / 130
    assert program_spans.inside_share(dev, "Memcpy DtoH", spans, "ec.stage") is None


def test_read_is_a_mean_per_operation_of_the_window():
    class Rec:
        window_ns = (100, 1000)
        facts = {"program_spans": [
            _span("ckpt.restore", 50, 300, op=1),            # began before the window
            _span("ec.stage", 60, 80, op=1),
            _span("ckpt.restore", 300, 600, op=2),
            _span("ec.stage", 310, 320, op=2), _span("ec.stage", 330, 350, op=2),
            _span("ckpt.restore", 600, 900, op=3),            # no stage span
            _span("ckpt.save", 900, 950, op=4), _span("ec.stage", 910, 990, op=4),
        ]}

    assert program_spans.read(Rec, "restore.stage_ms") == 30 / 1e6 / 2
    assert program_spans.per_op(Rec, "ec.stage", "ckpt.restore") == ([30 / 1e6, 0.0], 2)
    assert program_spans.per_op(Rec, "ckpt.restore", "ckpt.restore")[0] == [300 / 1e6] * 2
    assert program_spans.read(Rec, "restore.gather_ms") is None
    Rec.facts = {}
    assert program_spans.read(Rec, "restore.stage_ms") is None
