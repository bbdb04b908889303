"""The port's training path (``repro_torch.data``, ``repro_torch.train``'s
trainer and interop, ``repro_torch.launch.train``) held against the JAX
package's on the CPU.  The train step is held in
``test_torch_train_step.py``, ``loss_fn`` and its gradients in
``test_torch_loss.py``, the optimizers in ``test_torch_optim.py``.

Train states are made by the JAX package and carried across with
``train_state_from_numpy`` (bit for bit); batches come from the data
pipelines, which are bit-equal.  Tolerances:

* batches, restores, resumed runs, checkpoint layouts: bit-equal;
* the reference's trainer setup in f32: losses within ``TRAINER_REL`` =
  1e-4 relative (measured <= 7.3e-6), grad norms within
  ``TRAINER_NORM_REL`` = 1e-2 (measured 1.1e-3).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.checkpoint import CheckpointPolicy as JPolicy
from repro.checkpoint import DRexCheckpointer as JCheckpointer
from repro.checkpoint import StorageFabric as JFabric
from repro.data import DataConfig as JDataConfig
from repro.data import LMDataPipeline as JPipeline
from repro.optim import AdamWConfig as JAdamWConfig
from repro.storage import make_node_set as j_node_set
from repro.train import Trainer as JTrainer
from repro.train import TrainerConfig as JTrainerConfig
from repro.train import init_train_state as j_state

import repro_torch.configs as tconfigs
from repro_torch.checkpoint import CheckpointPolicy, DRexCheckpointer, StorageFabric
from repro_torch.checkpoint.interop import import_manifest
from repro_torch.data import DataConfig, LMDataPipeline
from repro_torch.launch import train as launch_train
from repro_torch.models import flatten_params
from repro_torch.optim import AdamWConfig
from repro_torch.storage import make_node_set
from repro_torch.train import (
    Trainer,
    TrainerConfig,
    TrainState,
    TrainStateCheckpointer,
    init_train_state,
    train_state_dict,
    train_state_from_dict,
    train_state_from_numpy,
)
from repro_torch.prng import PRNGKey

TRAINER_REL, TRAINER_NORM_REL = 1e-4, 1e-2


def configs(arch: str, **kw):
    jc, tc = jconfigs.get_config(arch, True), tconfigs.get_config(arch, True)
    return jc.with_(**kw), tc.with_(**kw)


# -- data --------------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_batches_bit_equal(seed):
    kw = dict(vocab_size=1000, seq_len=32, global_batch=4, seed=seed)
    jp, tp = JPipeline(JDataConfig(**kw)), LMDataPipeline(DataConfig(**kw), device="cpu")
    for _ in range(4):
        a, b = jp.next_batch(), tp.next_batch()
        for k in ("tokens", "labels"):
            assert b[k].dtype == torch.int32 and b[k].device.type == "cpu"
            np.testing.assert_array_equal(np.asarray(a[k]), b[k].numpy())
    assert jp.step == tp.step == 4


def test_straggler_plan_equal():
    kw = dict(vocab_size=10, seq_len=4, global_batch=4)
    jp, tp = JPipeline(JDataConfig(**kw)), LMDataPipeline(DataConfig(**kw), device="cpu")
    lat = np.random.default_rng(3).uniform(0.01, 0.05, size=(12, 5))
    lat[:, 3] *= 10  # host 3 straggles
    for row in lat:
        for h, v in enumerate(row):
            jp.record_host_latency(h, float(v))
            tp.record_host_latency(h, float(v))
    assert tp._latency_ewma == jp._latency_ewma
    assert tp.straggler_hosts() == jp.straggler_hosts() == [3]
    for per_host in (1, 8, 9):
        assert tp.plan_host_batches(list(range(5)), per_host) == jp.plan_host_batches(
            list(range(5)), per_host)


class TestDataPipeline:
    """The reference suite's pipeline tests, on the port."""

    def test_deterministic(self):
        cfg = DataConfig(vocab_size=1000, seq_len=32, global_batch=4, seed=7)
        a = LMDataPipeline(cfg, device="cpu").next_batch()
        b = LMDataPipeline(cfg, device="cpu").next_batch()
        assert torch.equal(a["tokens"], b["tokens"])

    def test_labels_are_shifted_tokens(self):
        p = LMDataPipeline(DataConfig(vocab_size=1000, seq_len=32, global_batch=4),
                           device="cpu")
        toks = p._tokens_for(0, 4)
        b = p.next_batch()
        assert b["tokens"].shape == b["labels"].shape == (4, 32)
        np.testing.assert_array_equal(b["tokens"].numpy(), toks[:, :-1])
        np.testing.assert_array_equal(b["labels"].numpy(), toks[:, 1:])

    def test_straggler_plan_thins_and_rebalances(self):
        p = LMDataPipeline(DataConfig(vocab_size=10, seq_len=4, global_batch=4), device="cpu")
        for _ in range(10):
            p.record_host_latency(0, 0.01)
            p.record_host_latency(1, 0.01)
            p.record_host_latency(2, 0.5)  # straggler
        assert p.straggler_hosts() == [2]
        plan = p.plan_host_batches([0, 1, 2], per_host=8)
        assert plan[2] < 8
        assert sum(plan.values()) == 24  # total preserved

    def test_no_stragglers_on_uniform_latency(self):
        p = LMDataPipeline(DataConfig(vocab_size=10, seq_len=4, global_batch=4), device="cpu")
        for h in range(4):
            p.record_host_latency(h, 0.1)
        assert p.straggler_hosts() == []


# -- train step and trainer ----------------------------------------------------------------


def _np_state(jstate):
    """The JAX TrainState's leaves as host copies (before a donating step)."""
    return jax.tree.map(np.array, jstate)


def test_trainer_matches_reference():
    """The reference suite's TestTrainer setup (RWKV6 smoke) through both
    trainers from the same initial state, in f32: every logged loss, nll
    and lr within TRAINER_REL (measured <= 7.3e-6), grad_norm within
    TRAINER_NORM_REL (measured 1.1e-3: the norm sums the squares of
    gradients that a free trajectory has moved apart).  In bf16 the two
    trajectories' losses drift ~1% apart through rounding within 12
    steps."""
    jc, tc = configs("rwkv6_1_6b", dtype="float32")
    dkw = dict(vocab_size=jc.vocab_size, seq_len=32, global_batch=4)
    jtrainer = JTrainer(jc, JAdamWConfig(lr=5e-3, warmup_steps=5),
                        JTrainerConfig(steps=12, log_every=4), data_cfg=JDataConfig(**dkw),
                        log_fn=lambda s, m: None)
    init = train_state_from_numpy(_np_state(j_state(jc, jax.random.PRNGKey(0))), device="cpu")
    jtrainer.run()
    trainer = Trainer(tc, AdamWConfig(lr=5e-3, warmup_steps=5),
                      TrainerConfig(steps=12, log_every=4), data_cfg=DataConfig(**dkw),
                      log_fn=lambda s, m: None, device="cpu")
    trainer.run(init)
    assert [h["step"] for h in trainer.history] == [h["step"] for h in jtrainer.history] \
        == [1, 4, 8, 12]
    for a, b in zip(jtrainer.history, trainer.history):
        for k in ("loss", "nll", "lr"):
            assert abs(a[k] - b[k]) <= TRAINER_REL * abs(a[k]), k
        assert abs(a["grad_norm"] - b["grad_norm"]) <= TRAINER_NORM_REL * a["grad_norm"]
        assert b["steps_per_s"] > 0


def test_trainer_end_to_end_loop():
    """The reference suite's own TestTrainer check, on the port (bf16)."""
    _, tc = configs("rwkv6_1_6b")
    trainer = Trainer(tc, AdamWConfig(lr=5e-3, warmup_steps=5),
                      TrainerConfig(steps=12, log_every=4),
                      data_cfg=DataConfig(vocab_size=tc.vocab_size, seq_len=32, global_batch=4),
                      log_fn=lambda s, m: None, device="cpu")
    state = trainer.run()
    assert len(trainer.history) >= 3
    assert trainer.history[-1]["loss"] < trainer.history[0]["loss"] + 0.5
    assert state.params["embed"].dtype == torch.bfloat16
    assert int(state.opt.step) == 12


def _resume_setup(checkpointer=None, steps=6):
    _, tc = configs("rwkv6_1_6b")
    return Trainer(tc, AdamWConfig(lr=5e-3, warmup_steps=2),
                   TrainerConfig(steps=steps, log_every=1, ckpt_every=4, seed=3),
                   data_cfg=DataConfig(vocab_size=tc.vocab_size, seq_len=16,
                                       global_batch=2, seed=3),
                   checkpointer=checkpointer, log_fn=lambda s, m: None, device="cpu")


def _clone(state: TrainState) -> dict:
    return {n: t.clone() for n, t in train_state_dict(state).items()}


def _assert_bit_equal(a: dict, b: dict):
    assert list(a) == list(b)
    for name in a:
        assert a[name].dtype == b[name].dtype and torch.equal(a[name], b[name]), name


def test_trainer_resumes_bit_exactly_after_a_node_loss():
    """An async save at step 4, two more in-place steps, a node holding
    chunks lost, a restore, and steps 5-6 again: the restored state equals
    the state at step 4 and the resumed run the uninterrupted one."""
    at4 = _clone(_resume_setup(steps=4).run())
    straight = _resume_setup()
    final = _clone(straight.run())

    _, tc = configs("rwkv6_1_6b")
    fabric = StorageFabric(make_node_set("most_used", capacity_scale=1e-4))
    ck = DRexCheckpointer(fabric, "drex_sc", CheckpointPolicy(item_mb=0.01), device="cpu")
    like = init_train_state(tc, PRNGKey(0), device="meta")
    adapter = TrainStateCheckpointer(ck, like)
    saved = _resume_setup(adapter)
    _assert_bit_equal(_clone(saved.run()), final)
    manifest = ck._manifests[4]
    assert [m["name"] for m in manifest["leaves"]] == list(final)
    groups = [g for m in manifest["leaves"] for g in m["groups"]]
    assert len(groups) > len(manifest["leaves"])  # big leaves span groups
    fabric.fail_node(groups[0]["node_ids"][0])

    resumed = _resume_setup(adapter)
    state = resumed.init_or_restore()
    assert resumed.start_step == 4 and resumed.data.step == 0
    # As the reference's, the restored pipeline starts at batch 0; steps
    # 5-6 of the uninterrupted run trained on batches 4-5.
    resumed.data.step = resumed.start_step
    _assert_bit_equal(_clone(state), at4)
    _assert_bit_equal(_clone(resumed.run(state)), final)
    assert [h["step"] for h in resumed.history] == [5, 6]
    for h in resumed.history:
        want = straight.history[h["step"] - 1]
        assert {k: h[k] for k in ("loss", "nll", "grad_norm", "lr")} == {
            k: want[k] for k in ("loss", "nll", "grad_norm", "lr")}
    ck.close()


def test_trainer_resumes_as_the_reference_does():
    """Both trainers from the same f32 state (the reference's, carried
    across) to a save at step 4, a node lost, a restore and steps 5-6:
    each restored pipeline starts at batch 0, as the reference's does, and
    the resumed histories agree within TRAINER_REL (grad_norm within
    TRAINER_NORM_REL)."""
    jc, tc = configs("rwkv6_1_6b", dtype="float32")
    opt, dkw = dict(lr=5e-3, warmup_steps=2), dict(vocab_size=jc.vocab_size, seq_len=16,
                                                     global_batch=2, seed=3)
    tkw = dict(log_every=1, ckpt_every=4, seed=3)
    init = train_state_from_numpy(_np_state(j_state(jc, jax.random.PRNGKey(3))), device="cpu")

    jfabric = JFabric(j_node_set("most_used", capacity_scale=1e-4))
    jck = JCheckpointer(jfabric, "drex_sc", JPolicy(item_mb=0.1))
    jlike = j_state(jc, jax.random.PRNGKey(0))

    class JAdapter:
        def save(self, st, step): jck.save(st, step)
        def save_async(self, st, step): return jck.save_async(st, step)
        def restore_latest(self, _): return jck.restore_latest(jlike)

    fabric = StorageFabric(make_node_set("most_used", capacity_scale=1e-4))
    ck = DRexCheckpointer(fabric, "drex_sc", CheckpointPolicy(item_mb=0.1), device="cpu")
    adapter = TrainStateCheckpointer(ck, init_train_state(tc, PRNGKey(0), device="meta"))

    def both(steps):
        j = JTrainer(jc, JAdamWConfig(**opt), JTrainerConfig(steps=steps, **tkw),
                     data_cfg=JDataConfig(**dkw), checkpointer=JAdapter(),
                     log_fn=lambda s, m: None)
        t = Trainer(tc, AdamWConfig(**opt), TrainerConfig(steps=steps, **tkw),
                    data_cfg=DataConfig(**dkw), checkpointer=adapter,
                    log_fn=lambda s, m: None, device="cpu")
        return j, t

    def agree(jhist, thist):
        assert [h["step"] for h in thist] == [h["step"] for h in jhist]
        for a, b in zip(jhist, thist):
            for k in ("loss", "nll", "lr"):
                assert abs(a[k] - b[k]) <= TRAINER_REL * abs(a[k]), (a["step"], k)
            assert abs(a["grad_norm"] - b["grad_norm"]) <= TRAINER_NORM_REL * a["grad_norm"]

    j, t = both(4)
    j.run(j_state(jc, jax.random.PRNGKey(3)))
    t.run(init)
    agree(j.history, t.history)
    jfabric.fail_node(0)
    fabric.fail_node(0)

    j, t = both(6)
    jstate, tstate = j.init_or_restore(), t.init_or_restore()
    assert j.start_step == t.start_step == 4
    assert j.data.step == t.data.step == 0
    j.run(jstate)
    t.run(tstate)
    assert [h["step"] for h in t.history] == [5, 6]
    agree(j.history, t.history)
    ck.close()


def test_train_state_dict_round_trip():
    _, tc = configs("qwen3_8b")
    state = init_train_state(tc, PRNGKey(0), compression=True,
                             device="cpu")
    d = train_state_dict(state)
    names = list(d)
    n = len(flatten_params(state.params))
    assert names[:n] == ["params." + k for k in flatten_params(state.params)]
    assert names[n] == "opt.step"
    assert [x.split(".")[1] for x in names[n + 1:]] == (
        ["mu"] * n + ["nu"] * n + ["master"] * n + ["error"] * n)
    back = train_state_from_dict(d, init_train_state(tc, PRNGKey(0), True, "meta"))
    assert all(a is b for a, b in zip(train_state_dict(back).values(), d.values()))
    with pytest.raises(ValueError, match="leaf names"):
        train_state_from_dict(d, init_train_state(tc, PRNGKey(0), False, "meta"))


# -- across packages ---------------------------------------------------------------------------


def _groups(manifest):
    return [(g["key"], g["k"], g["p"], tuple(g["node_ids"]), g["orig_nbytes"])
            for meta in manifest["leaves"] if meta is not None for g in meta["groups"]]


@pytest.mark.parametrize("compression", [False, True])
def test_jax_train_state_checkpoint_restores_in_port(tmp_path, compression):
    """A TrainState saved by the JAX package's DRexCheckpointer restores in
    the port under train_state_dict's names, bit-equal to the carried
    state; the port's own save of that state lays out the same groups,
    placements and chunk bytes."""
    jc, tc = configs("rwkv6_1_6b")
    jstate = j_state(jc, jax.random.PRNGKey(2), compression)
    np_state = _np_state(jstate)
    carried = train_state_from_numpy(np_state, device="cpu")
    names = list(train_state_dict(carried))
    assert len(names) == len(jax.tree.leaves(jstate))
    kw = dict(item_mb=0.25)
    jck = JCheckpointer(JFabric(j_node_set("most_used", capacity_scale=1e-4),
                                persist_dir=str(tmp_path)), "drex_sc", JPolicy(**kw))
    jman = jck.save(jstate, 3)

    tfab = StorageFabric(make_node_set("most_used", capacity_scale=1e-4),
                         persist_dir=str(tmp_path))
    tfab.fail_node(jman["leaves"][0]["groups"][0]["node_ids"][0])
    tck = DRexCheckpointer(tfab, "drex_sc", CheckpointPolicy(**kw), device="cpu")
    import_manifest(tck, 3, jman, names=names)
    restored, step = tck.restore_latest()
    assert step == 3
    like = init_train_state(tc, PRNGKey(0), compression, device="meta")
    _assert_bit_equal(train_state_dict(train_state_from_dict(restored, like)),
                      train_state_dict(carried))

    own = DRexCheckpointer(StorageFabric(make_node_set("most_used", capacity_scale=1e-4)),
                           "drex_sc", CheckpointPolicy(**kw), device="cpu")
    tman = own.save(train_state_dict(carried), 3)
    assert _groups(tman) == _groups(jman)
    assert own.fabric._blobs == jck.fabric._blobs
    assert [m["dtype"] for m in tman["leaves"]] == [m["dtype"] for m in jman["leaves"]]
    own.close()
    tck.close()


# -- launcher and the device rule -----------------------------------------------------------


def test_launcher_smoke_on_cpu(capsys):
    launch_train.main(["--arch", "rwkv6_1_6b", "--smoke", "--device", "cpu", "--steps", "4",
                       "--ckpt-every", "2", "--seq", "16", "--batch", "2", "--log-every", "2"])
    out = capsys.readouterr().out
    assert "[launch] arch=rwkv6-smoke" in out and "device=cpu" in out
    assert "[launch] loss " in out and "over 4 steps" in out


def test_training_entry_points_need_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, tc = configs("yi_6b")
    calls = [
        lambda: init_train_state(tc, PRNGKey(0)),
        lambda: LMDataPipeline(DataConfig(10, 4, 2)),
        lambda: Trainer(tc, AdamWConfig(), TrainerConfig()),
        lambda: launch_train.main(["--arch", "yi_6b", "--smoke", "--steps", "1"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
