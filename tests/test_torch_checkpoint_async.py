"""``save_async``'s contract, the port's against the JAX package's: the
caller is held for a snapshot of the state and nothing else; placement,
encode and puts run on a save-pool worker.

``ECCodec.encode_many`` is gated on a ``threading.Event`` (monkeypatched
on the class each package's manager imports, always opened in a
``finally``), so a save that encodes before it returns shows as a call
that does not return.  Every wait has a timeout: a save that holds its
caller fails these tests instead of hanging them.  Leaves are small
(``item_mb`` 0.25) and live on the CPU; comparisons are exact.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import pytest
import torch

import repro.checkpoint.manager as jmanager
import repro_torch.checkpoint.manager as tmanager
import repro_torch.configs as tconfigs
from repro.checkpoint import CheckpointPolicy as JPolicy
from repro.checkpoint import DRexCheckpointer as JCheckpointer
from repro.checkpoint import StorageFabric as JFabric
from repro.storage import make_node_set as j_node_set
from repro_torch.checkpoint import CheckpointPolicy as TPolicy
from repro_torch.checkpoint import DRexCheckpointer as TCheckpointer
from repro_torch.checkpoint import StorageFabric as TFabric
from repro_torch.checkpoint.interop import state_dict_from_numpy
from repro_torch.data import DataConfig
from repro_torch.optim import AdamWConfig
from repro_torch.prng import PRNGKey
from repro_torch.storage import make_node_set as t_node_set
from repro_torch.train import (
    Trainer,
    TrainerConfig,
    TrainStateCheckpointer,
    init_train_state,
    train_state_dict,
)

SCALE = 1e-5
ITEM_MB = 0.25
#: how long ``save_async`` may take to return while its encode is held.
RETURN_S = 10.0
#: how long a held encode waits for its gate before it fails the save.
GATE_S = 30.0


def _leaves(seed=0):
    rng = np.random.default_rng(seed)
    return [
        ("w", rng.standard_normal((300, 1000)).astype(np.float32)),  # 5 groups
        ("bucket", rng.standard_normal(16_384).astype(np.float32)),  # 65,536 B: a bucket
        ("ids", rng.integers(-2**31, 2**31 - 1, size=(50_000,), dtype=np.int32)),
        ("bytes", rng.integers(0, 256, size=(70_001,), dtype=np.uint8)),
        ("empty", np.zeros((0, 4), dtype=np.float32)),
        ("scalar", np.array(3.5, dtype=np.float32)),
    ]


def _pair(**kw):
    kw = dict(item_mb=ITEM_MB, **kw)
    return (
        JCheckpointer(JFabric(j_node_set("most_used", capacity_scale=SCALE)), "drex_sc",
                      JPolicy(**kw)),
        TCheckpointer(TFabric(t_node_set("most_used", capacity_scale=SCALE)), "drex_sc",
                      TPolicy(**kw), device="cpu"),
    )


def _state(leaves):
    return state_dict_from_numpy([(n, a.copy()) for n, a in leaves], "cpu")


@contextlib.contextmanager
def gated_encode(monkeypatch, codec_cls):
    """``codec_cls.encode_many`` held until the yielded gate is set;
    ``entered`` is set once an encode is waiting on it."""
    gate, entered = threading.Event(), threading.Event()
    encode_many = codec_cls.encode_many

    def held(self, payloads):
        entered.set()
        if not gate.wait(GATE_S):
            raise TimeoutError("the encode's gate was never opened")
        return encode_many(self, payloads)

    monkeypatch.setattr(codec_cls, "encode_many", held)
    try:
        yield gate, entered
    finally:
        gate.set()


def _call_within(fn, timeout: float):
    """``fn()`` on a helper thread: (thread, box), ``box["out"]`` set if it
    returned within ``timeout`` seconds."""
    box: dict = {}
    t = threading.Thread(target=lambda: box.setdefault("out", fn()), daemon=True)
    t.start()
    t.join(timeout)
    return t, dict(box)


def _assert_restores(state, leaves):
    assert list(state) == [n for n, _ in leaves]
    for name, arr in leaves:
        assert tuple(state[name].shape) == arr.shape
        np.testing.assert_array_equal(state[name].numpy(), arr)


def _groups(manifest):
    return [(g["key"], g["k"], g["p"], tuple(g["node_ids"]), g["orig_nbytes"])
            for meta in manifest["leaves"] for g in meta["groups"]]


@pytest.mark.parametrize("package", ["port", "reference"])
def test_save_async_returns_before_the_encode(monkeypatch, package):
    """(a) With the encode held, ``save_async`` returns a pending future,
    in the JAX package and in the port; the held encode then runs on the
    worker, and the save completes once it is let go."""
    leaves = _leaves()
    jck, tck = _pair()
    if package == "port":
        codec_cls = tmanager.ECCodec
        call = lambda: tck.save_async(_state(leaves), 1)  # noqa: E731
    else:
        codec_cls = jmanager.ECCodec
        call = lambda: jck.save_async([a.copy() for _, a in leaves], 1)  # noqa: E731
    with gated_encode(monkeypatch, codec_cls) as (gate, entered):
        t, box = _call_within(call, RETURN_S)
        assert "out" in box, f"save_async held its caller for over {RETURN_S} s"
        fut = box["out"]
        assert not fut.done()
        assert entered.wait(GATE_S), "the worker never reached the encode"
        assert not fut.done()
        gate.set()
        manifest = fut.result(timeout=GATE_S)
    t.join(GATE_S)
    assert manifest["step"] == 1
    if package == "port":
        _assert_restores(tck.restore(1), leaves)
        tck.close()


def test_snapshot_survives_in_place_mutation(monkeypatch):
    """(b) Every leaf mutated in place right after ``save_async``
    returns (a leaf of exactly one bucket, one of five groups among
    them): the save holds the bytes as they were, chunk for chunk the
    JAX package's save of those bytes."""
    leaves = _leaves(1)
    jck, tck = _pair()
    jman = jck.save([a.copy() for _, a in leaves], 1)
    state = _state(leaves)
    with gated_encode(monkeypatch, tmanager.ECCodec) as (gate, _):
        fut = tck.save_async(state, 1)
        for t in state.values():  # what an in-place training step does
            t.reshape(-1).view(torch.uint8).bitwise_not_()
        gate.set()
        tman = fut.result(timeout=GATE_S)
    for name, arr in leaves:
        if arr.size:
            assert not np.array_equal(state[name].numpy(), arr), name
    assert _groups(tman) == _groups(jman)
    assert tck.fabric._blobs == jck.fabric._blobs
    np.testing.assert_array_equal(tck.fabric.cluster.used_mb, jck.fabric.cluster.used_mb)
    _assert_restores(tck.restore(1), leaves)
    tck.close()


def _trainer(checkpointer, steps, ckpt_every):
    tc = tconfigs.get_config("rwkv6_1_6b", True)
    return Trainer(tc, AdamWConfig(lr=5e-3, warmup_steps=2),
                   TrainerConfig(steps=steps, log_every=1, ckpt_every=ckpt_every, seed=3,
                                 async_ckpt=True),
                   data_cfg=DataConfig(vocab_size=tc.vocab_size, seq_len=16, global_batch=2,
                                       seed=3),
                   checkpointer=checkpointer, log_fn=lambda s, m: None, device="cpu")


def test_trainer_steps_while_the_save_is_pending(monkeypatch):
    """(c) The port's Trainer with ``async_ckpt``: with the encode held,
    step ``ckpt_every + 1`` runs while the save is pending (the gate opens
    after it), and the final state is bit-equal to the same run with the
    encode free; the last checkpoint restores to it."""
    steps, every = 4, 2
    tc = tconfigs.get_config("rwkv6_1_6b", True)

    def run(gate):
        ck = TCheckpointer(TFabric(t_node_set("most_used", capacity_scale=1e-4)), "drex_sc",
                           TPolicy(item_mb=0.01), device="cpu")
        adapter = TrainStateCheckpointer(ck, init_train_state(tc, PRNGKey(0), device="meta"))
        trainer = _trainer(adapter, steps, every)
        inner, pending_at, calls = trainer.step_fn, [], []

        def step(state, batch):
            calls.append(len(calls) + 1)  # the step's number
            fut = trainer._pending_ckpt
            if fut is not None and not fut.done():
                pending_at.append(calls[-1])
            out = inner(state, batch)
            if gate is not None and calls[-1] == every + 1:
                gate.set()
            return out

        trainer.step_fn = step
        final = {n: t.clone() for n, t in train_state_dict(trainer.run()).items()}
        restored, at = adapter.restore_latest()
        ck.close()
        return final, pending_at, train_state_dict(restored), at

    free, _, _, _ = run(None)
    with gated_encode(monkeypatch, tmanager.ECCodec) as (gate, _):
        held, pending_at, restored, at = run(gate)
    assert every + 1 in pending_at, f"steps begun with the save pending: {pending_at}"
    assert list(held) == list(free) and list(restored) == list(free) and at == steps
    for name in free:
        assert held[name].dtype == free[name].dtype and torch.equal(held[name], free[name]), name
        assert torch.equal(restored[name], free[name]), name


def _fail_encode(self, payloads):
    raise RuntimeError("encode failed")


@pytest.mark.parametrize("phase", ["placement", "encode"])
def test_failure_surfaces_through_the_future(monkeypatch, phase):
    """(d) A placement that finds no room and an encode that raises each
    surface through ``result()``, not on the caller, and register no
    manifest."""
    scale = 1e-9 if phase == "placement" else SCALE
    tck = TCheckpointer(TFabric(t_node_set("most_used", capacity_scale=scale)), "drex_sc",
                        TPolicy(item_mb=ITEM_MB), device="cpu")
    if phase == "encode":
        monkeypatch.setattr(tmanager.ECCodec, "encode_many", _fail_encode)
    fut = tck.save_async(_state(_leaves()[:2]), 1)
    with pytest.raises(IOError if phase == "placement" else RuntimeError):
        fut.result(timeout=GATE_S)
    assert 1 not in tck._manifests and tck.restore_latest() is None
    tck.close()


def test_cuda_save_runs_on_its_own_stream(monkeypatch):
    """On the card (skipped without one): the worker's encodes run on the
    checkpointer's stream, not the caller's, and the restore is exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    leaves = _leaves(2)
    ck = TCheckpointer(TFabric(t_node_set("most_used", capacity_scale=SCALE)), "drex_sc",
                       TPolicy(item_mb=ITEM_MB), device="cuda")
    streams = []
    encode_many = tmanager.ECCodec.encode_many

    def recording(self, payloads):
        streams.append(torch.cuda.current_stream().cuda_stream)
        return encode_many(self, payloads)

    monkeypatch.setattr(tmanager.ECCodec, "encode_many", recording)
    state = state_dict_from_numpy(leaves, "cuda")
    fut = ck.save_async(state, 1)
    for t in state.values():
        t.reshape(-1).view(torch.uint8).bitwise_not_()
    fut.result(timeout=120)
    assert streams and set(streams) == {ck._stream.cuda_stream}
    assert ck._stream.cuda_stream != torch.cuda.current_stream().cuda_stream
    restored = ck.restore(1)
    for name, arr in leaves:
        np.testing.assert_array_equal(restored[name].cpu().numpy(), arr)
    ck.close()
