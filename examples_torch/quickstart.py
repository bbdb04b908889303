"""Quickstart on the port: an end-to-end training run.

Trains a dense LM for a few hundred steps on synthetic data through the
full production stack: config -> train step on a one-device mesh ->
AdamW (f32 master) -> D-Rex EC-protected checkpoints on a heterogeneous
storage fabric -> kill/restore drill at the end.

The PyTorch counterpart of ``examples/quickstart.py``, with the same
flags, defaults and printed lines.  By default a reduced ~8M model, 200
steps; ``--full`` is the 124,649,472-param configuration (by
``n_params()``), whose ``TrainState`` is 1.75 GB.  Everything runs on
``--device`` (the default is the GPU).  With ``--steps`` below 10 no
checkpoint is written and the drill fails, as the reference's does.

    python examples_torch/quickstart.py [--full] [--steps N] [--device cpu]
"""

import argparse
import sys
import time

import torch

sys.path.insert(0, "src")

from repro_torch._device import resolve_device
from repro_torch.checkpoint import CheckpointPolicy, DRexCheckpointer, StorageFabric
from repro_torch.data import DataConfig
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig
from repro_torch.prng import PRNGKey
from repro_torch.storage import make_node_set
from repro_torch.train import (Trainer, TrainerConfig, TrainStateCheckpointer,
                               init_train_state, train_state_dict)


def model_config(full: bool) -> ModelConfig:
    if full:  # 124,649,472 params
        return ModelConfig(
            name="quickstart-100m", family="dense", n_layers=12, d_model=768,
            n_heads=12, n_kv_heads=4, d_ff=2048, vocab_size=32_000,
            activation="silu",
        )
    return ModelConfig(  # ~8M params: same family, laptop-scale
        name="quickstart-8m", family="dense", n_layers=4, d_model=256,
        n_heads=8, n_kv_heads=4, d_ff=1024, vocab_size=4096,
        activation="silu",
    )


def quickstart(full: bool = False, steps: int = 200, *, device=None,
               item_mb: float = 8.0, global_batch: int = 8, seq_len: int = 256) -> dict:
    """Train, checkpoint, lose two storage nodes, restore; print the
    example's lines and return what they show."""
    dev = resolve_device(device)
    cfg = model_config(full)
    print(f"model: {cfg.name} ({cfg.n_params()/1e6:.1f}M params), devices: 1")

    # D-Rex-protected checkpointing over the paper's Most Used node set.
    fabric = StorageFabric(make_node_set("most_used", capacity_scale=1e-4))
    ck = DRexCheckpointer(
        fabric, "drex_sc",
        # Five nines over a 1-year retention forces P>=2 on this node
        # set (over 30 days these drives are reliable enough that D-Rex
        # correctly buys only P=1); the drill below kills two nodes.
        CheckpointPolicy(item_mb=item_mb, reliability_target=0.99999,
                         retention_days=365.0),
        device=dev,
    )
    checkpointer = TrainStateCheckpointer(ck, init_train_state(cfg, PRNGKey(0),
                                                               device="meta"))

    ckpt_every = min(50, max(10, steps // 4))
    trainer = Trainer(
        cfg,
        AdamWConfig(lr=3e-3, warmup_steps=20),
        TrainerConfig(steps=steps, log_every=10, ckpt_every=ckpt_every),
        data_cfg=DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                            global_batch=global_batch),
        mesh=make_local_mesh(1, 1, device=dev),
        checkpointer=checkpointer,
        device=dev,
    )
    state = trainer.run()

    # Failure drill: lose two storage nodes, prove the checkpoint survives.
    print("\nfailure drill: killing storage nodes 0 and 3 ...")
    fabric.fail_node(0)
    fabric.fail_node(3)
    t0 = time.perf_counter()
    restored = checkpointer.restore_latest()
    if restored is None:
        raise RuntimeError(f"no checkpoint to restore: {steps} steps never reach "
                           f"ckpt_every={ckpt_every}")
    restored, step = restored
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    restore_s = time.perf_counter() - t0
    have, got = train_state_dict(state), train_state_dict(restored)
    ok = list(have) == list(got) and all(
        torch.equal(have[n], got[n].to(have[n].device)) for n in have)
    overhead = ck.stats["bytes_stored"] / max(ck.stats["bytes_raw"], 1)
    print(f"restored checkpoint from step {step} after 2/10 node failures: "
          f"bit-exact={ok}")
    print(f"checkpoint storage overhead: {overhead:.2f}x "
          f"(vs 3.0x for HDFS-style replication)")
    state_bytes = sum(t.numel() * t.element_size() for t in have.values())
    ck.close()
    return {"model": cfg.name, "params": cfg.n_params(), "history": trainer.history,
            "ckpt_every": ckpt_every, "restored_step": step, "bit_exact": ok,
            "overhead": overhead, "stats": dict(ck.stats), "state_bytes": state_bytes,
            "tokens_per_step": global_batch * seq_len, "restore_s": restore_s}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default=None, help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    return quickstart(args.full, args.steps, device=args.device)


if __name__ == "__main__":
    main()
