"""Seeded params of the port held against the JAX package's on the CPU,
each package drawing its own from ``PRNGKey(seed)`` (nothing carried
across).

``repro_torch.models.init_params`` walks the reference's key tree
(``split`` and ``fold_in`` as ``repro.models`` calls them) and draws every
dense leaf through ``repro_torch.prng.normal``, whose f32 draws are
``jax.random.normal``'s bit for bit; the multiply by ``std`` and the cast
round as the reference's do.  So the stated bound on every leaf, bf16 and
f32 alike, is equality: ``LEAF_UNEQUAL_SHARE`` = 0 of the elements differ.
The trainer's fresh ``TrainState`` is the reference's
``init_train_state(cfg, PRNGKey(seed))``.  Served tokens from the two
packages' own params (greedy, and sampled at temperatures 0.7 and 1.0)
are held equal for all ten configs in ``tests/test_torch_serve_engine.py``.

The reference is ``repro.models.init_params`` called eagerly, as its
trainer, launcher and examples call it.  Under one ``jax.jit`` around the
whole init XLA fuses the draws with their scaling and rounds a few
elements otherwise (measured: 1e-5 to 2.4e-4 of a bf16 leaf's elements,
by 1 ulp, in two smoke configs), so the reference is never jitted here
(``tests/jax_reference_params.py``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax_reference_params import eager_params

import repro.configs as jconfigs
from repro.train import init_train_state as j_state

import repro_torch.configs as tconfigs
from repro_torch.checkpoint.manager import dtype_name
from repro_torch.data import DataConfig
from repro_torch.models import flatten_params, init_params
from repro_torch.optim import AdamWConfig
from repro_torch.prng import PRNGKey
from repro_torch.train import (
    Trainer,
    TrainerConfig,
    train_state_dict,
    train_state_from_numpy,
)

SUPPORTED = ["qwen3_8b", "yi_6b", "nemotron_4_15b", "nemotron_4_340b",
             "chameleon_34b", "rwkv6_1_6b", "recurrentgemma_9b", "qwen2_moe_a2_7b",
             "qwen3_moe_30b_a3b", "whisper_tiny"]
#: a second seed on one config of each init family (dense, RWKV6, Griffin,
#: MoE, encoder-decoder).
SECOND_SEED_ARCHS = ["qwen3_8b", "rwkv6_1_6b", "recurrentgemma_9b", "qwen2_moe_a2_7b",
                     "whisper_tiny"]
#: the share of a leaf's elements allowed to differ from the reference's.
LEAF_UNEQUAL_SHARE = 0.0


def _jax_leaves(tree) -> list[tuple[str, np.ndarray]]:
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = ".".join(str(k.idx if isinstance(k, jax.tree_util.SequenceKey) else k.key)
                        for k in path)
        out.append((name, np.asarray(leaf)))
    return out


@functools.lru_cache(maxsize=None)
def _reference(seed: int) -> dict:
    archs = SUPPORTED if seed == 0 else SECOND_SEED_ARCHS
    return {a: _jax_leaves(p) for a, (_, p) in eager_params(archs, seed).items()}


@pytest.mark.parametrize("arch,seed", [(a, 0) for a in SUPPORTED]
                         + [(a, 3) for a in SECOND_SEED_ARCHS])
def test_init_params_equal_reference(arch, seed):
    want = _reference(seed)[arch]
    got = flatten_params(init_params(tconfigs.get_config(arch, smoke=True), PRNGKey(seed),
                                     device="cpu"))
    assert [n for n, _ in want] == list(got)
    for (name, w), g in zip(want, got.values()):
        assert tuple(g.shape) == w.shape and dtype_name(g.dtype) == jnp.dtype(w.dtype).name
        gf, wf = g.float().numpy(), w.astype(np.float32)
        unequal = float(np.mean(gf.view(np.int32) != wf.view(np.int32))) if gf.size else 0.0
        assert unequal <= LEAF_UNEQUAL_SHARE, (name, unequal)


@pytest.mark.parametrize("arch", ["rwkv6_1_6b"])
def test_trainer_fresh_state_equals_reference(arch):
    """``Trainer.init_or_restore`` without a checkpoint: params, moments,
    master copy and step equal the reference's ``init_train_state`` at
    the trainer's seed, bit for bit."""
    jc = jconfigs.get_config(arch, smoke=True)
    tc = tconfigs.get_config(arch, smoke=True)
    trainer = Trainer(tc, AdamWConfig(), TrainerConfig(steps=1, seed=5),
                      data_cfg=DataConfig(vocab_size=tc.vocab_size, seq_len=8, global_batch=2),
                      log_fn=lambda s, m: None, device="cpu")
    got = train_state_dict(trainer.init_or_restore())
    want = train_state_dict(train_state_from_numpy(
        jax.tree.map(np.array, j_state(jc, jax.random.PRNGKey(5))), device="cpu"))
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert np.array_equal(got[name].float().numpy(), want[name].float().numpy()), name
