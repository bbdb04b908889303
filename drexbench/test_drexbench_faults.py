"""A tiny CPU run of each cell with its timed path broken underneath: the
comparison has to find the fault, so ``correct`` comes out false."""

import dataclasses

import numpy as np
import pytest
import torch

from drexbench import harness, tiny

SAVE, PLACE, RESTORE = ("ckpt.rwkv6_1b6.save", "place.bb10k.sentinel2_750",
                        "ckpt.rwkv6_1b6.restore_node_lost")


@pytest.fixture(autouse=True)
def _one_thread():
    with tiny.one_thread():
        yield


def _run(workload, hooks):
    rec = harness.run_cell(tiny.tiny_cell(workload), 2**31 + 5, 0.3, False,
                           torch.device("cpu"), hooks=hooks)
    return harness.result_line(rec)


def test_sound_run_is_correct():
    assert _run(SAVE, {})["correct"] is True


# -- checkpoint save ------------------------------------------------------


def _save_puts(change):
    def hook(ck):
        put = ck._put_wave
        ck._put_wave = lambda entries: put(change(entries))
    return {"checkpointer": hook}


def _flip_first_byte(entries):
    out = []
    for g, chunks in entries:
        chunks = np.array(chunks, copy=True)
        chunks[0, 0] ^= 0xFF
        out.append((g, chunks))
    return out


def _stale_state():
    """Every save writes the state as the first save saw it."""
    def hook(ck):
        save, first = ck.save, {}

        def stale(state, step):
            if not first:
                first.update({k: v.clone() for k, v in state.items()})
            return save(first, step)
        ck.save = stale
    return {"checkpointer": hook}


SAVE_FAULTS = {
    "stale_state": _stale_state(),
    "state_unchanged": _save_puts(lambda entries: []),
    "half_the_batch": _save_puts(lambda entries: entries[: len(entries) // 2]),
    "answer_altered": _save_puts(_flip_first_byte),
}


@pytest.mark.parametrize("fault", sorted(SAVE_FAULTS))
def test_save_fault_is_found(fault):
    line = _run(SAVE, SAVE_FAULTS[fault])
    assert line["correct"] is False, line["checks"]


# -- checkpoint restore ---------------------------------------------------


def _restore_output(change):
    def hook(ck):
        restore = ck.restore_latest
        ck.restore_latest = lambda like: (lambda out: (change(out[0], like), out[1]))(restore(like))
    return {"checkpointer": hook}


def _flip_a_byte(out, like):
    name = next(iter(out))
    leaf = out[name].clone()
    leaf.view(-1).view(torch.uint8)[0] ^= 0xFF
    return dict(out, **{name: leaf})


RESTORE_FAULTS = {
    "state_unchanged": _restore_output(lambda out, like: dict(like)),
    "half_the_batch": _restore_output(lambda out, like: dict(list(out.items())[: len(out) // 2])),
    "answer_altered": _restore_output(_flip_a_byte),
}


@pytest.mark.parametrize("fault", sorted(RESTORE_FAULTS))
def test_restore_fault_is_found(fault):
    line = _run(RESTORE, RESTORE_FAULTS[fault])
    assert line["correct"] is False, line["checks"]


# -- placement service ------------------------------------------------------


def _records(change):
    def hook(engine):
        place_many = engine.place_many
        engine.place_many = lambda items, **kw: change(place_many(items, **kw), engine)
    return {"engine": hook}


def _no_commit(engine):
    engine.cluster.commit = lambda placement, chunk_mb: None


def _rotate_nodes(records, engine):
    n = engine.cluster.n_nodes
    out = []
    for r in records:
        if r.placement is not None:
            ids = tuple((i + 1) % n for i in r.placement.node_ids)
            r = dataclasses.replace(r, placement=dataclasses.replace(r.placement, node_ids=ids))
        out.append(r)
    return out


PLACE_FAULTS = {
    "state_unchanged": {"engine": _no_commit},
    "half_the_batch": _records(lambda records, engine: records[: max(1, len(records) // 2)]),
    "answer_altered": _records(_rotate_nodes),
}


@pytest.mark.parametrize("fault", sorted(PLACE_FAULTS))
def test_place_fault_is_found(fault):
    line = _run(PLACE, PLACE_FAULTS[fault])
    assert line["correct"] is False, line["checks"]
