"""Fault-tolerance drill on the port: train, checkpoint via D-Rex EC, kill
storage nodes mid-run, repair proactively, restart the trainer
elastically on a different mesh, and keep training.

The PyTorch counterpart of ``examples/elastic_failover.py``, with the
same printed lines.  Everything runs on ``--device`` (the default is the
GPU).  As in the reference, the restarted trainer's data pipeline starts
again at batch 0.

    python examples_torch/elastic_failover.py [--device cpu]
"""

import argparse
import sys

sys.path.insert(0, "src")

from repro_torch._device import resolve_device
from repro_torch.checkpoint import CheckpointPolicy, DRexCheckpointer, StorageFabric
from repro_torch.configs import get_config
from repro_torch.data import DataConfig
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.optim import AdamWConfig
from repro_torch.prng import PRNGKey
from repro_torch.storage import make_node_set
from repro_torch.train import (Trainer, TrainerConfig, TrainStateCheckpointer,
                               init_train_state, reshard_state)


def failover(*, device=None, steps: int = 30, ckpt_every: int = 10, resume_to: int = 45,
             item_mb: float = 1.0, seq_len: int = 64, global_batch: int = 4) -> dict:
    """The three phases; print the example's lines and return what they
    show."""
    dev = resolve_device(device)
    cfg = get_config("qwen3-8b", smoke=True)
    fabric = StorageFabric(make_node_set("most_unreliable", capacity_scale=1e-4))
    ck = DRexCheckpointer(fabric, "drex_sc",
                          CheckpointPolicy(item_mb=item_mb, reliability_target=0.9999),
                          device=dev)
    checkpointer = TrainStateCheckpointer(ck, init_train_state(cfg, PRNGKey(0),
                                                               device="meta"))

    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len, global_batch=global_batch)
    print(f"phase 1: train {steps} steps with EC checkpoints every {ckpt_every}")
    t1 = Trainer(cfg, AdamWConfig(lr=3e-3),
                 TrainerConfig(steps=steps, log_every=10, ckpt_every=ckpt_every),
                 data_cfg=dc, mesh=make_local_mesh(1, 1, device=dev),
                 checkpointer=checkpointer, device=dev)
    t1.run()

    print("\nphase 2: storage nodes 0 and 2 fail; checkpoint health:")
    fabric.fail_node(0); fabric.fail_node(2)
    rel = ck.group_reliability()
    print(f"  min group reliability: {min(rel):.6f} (target 0.9999)")
    # Repair goes through PlacementEngine.plan_repair — one repair policy
    # shared with the simulator; strict mode raises if any group's lost
    # chunks cannot all be re-placed (no silent under-repair).
    n = ck.repair()
    st = ck.engine.stats
    rel_after = ck.group_reliability()
    print(f"  proactive repair rebuilt {n} chunks "
          f"({st['n_repairs_planned']} repair plans, "
          f"{st['n_repairs_failed']} infeasible); "
          f"min reliability now {min(rel_after):.6f}")

    print(f"\nphase 3: elastic restart on a fresh mesh, resume to step {resume_to}")
    t2 = Trainer(cfg, AdamWConfig(lr=3e-3), TrainerConfig(steps=resume_to, log_every=5),
                 data_cfg=dc, mesh=make_local_mesh(1, 1, device=dev),
                 checkpointer=checkpointer, device=dev)
    state = t2.init_or_restore()
    restored_step, data_step = t2.start_step, t2.data.step
    state = reshard_state(state, cfg, make_local_mesh(1, 1, device=dev))
    t2.run(state)
    print("\nsurvived node failures + elastic restart; training continued.")
    ck.close()
    return {"history": t1.history, "min_reliability": min(rel),
            "repaired_chunks": n, "repairs_planned": st["n_repairs_planned"],
            "repairs_failed": st["n_repairs_failed"],
            "min_reliability_after_repair": min(rel_after),
            "restored_step": restored_step, "data_step_after_restore": data_step,
            "resumed_history": t2.history,
            "final_step": t2.history[-1]["step"] if t2.history else restored_step}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    return failover(device=args.device)


if __name__ == "__main__":
    main()
