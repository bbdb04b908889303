"""Training launcher of the port:
``python -m repro_torch.launch.train --arch rwkv6_1_6b --steps N --ckpt-every K``.

The reference's wiring (``repro.launch.train``): config registry, the
sharded train step on a one-device mesh (``make_local_mesh(1, 1)``, as
the reference builds when it sees one device), data pipeline, AdamW, and
D-Rex EC-protected checkpointing of the whole ``TrainState`` over a
heterogeneous storage fabric (the ``most_used`` node set, 4 MB groups).
``--smoke`` runs the reduced config; ``--device cpu`` runs on the CPU
(the default is CUDA).  In a process with no process group the launcher
starts a one-rank group for the mesh and ends it on exit.
"""

from __future__ import annotations

import argparse

import torch
import torch.distributed as dist

from repro_torch._device import resolve_device
from repro_torch.checkpoint import CheckpointPolicy, DRexCheckpointer, StorageFabric
from repro_torch.configs import get_config
from repro_torch.data import DataConfig
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.optim import AdamWConfig
from repro_torch.storage import make_node_set
from repro_torch.train import Trainer, TrainerConfig, TrainStateCheckpointer, init_train_state


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--ckpt-scheduler", default="drex_sc")
    ap.add_argument("--compression", action="store_true", help="EF-int8 grads")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    print(f"[launch] arch={cfg.name} params~{cfg.n_params()/1e6:.1f}M device={dev}")
    started_group = not dist.is_initialized()
    one_device = started_group or dist.get_world_size() == 1
    mesh = make_local_mesh(1, 1, device=dev) if one_device else None

    checkpointer = None
    ck = None
    if args.ckpt_every:
        fabric = StorageFabric(make_node_set("most_used", capacity_scale=1e-4))
        ck = DRexCheckpointer(fabric, args.ckpt_scheduler, CheckpointPolicy(item_mb=4.0),
                              device=dev)
        like = init_train_state(cfg, torch.Generator(), args.compression, device="meta")
        checkpointer = TrainStateCheckpointer(ck, like)

    trainer = Trainer(
        cfg,
        AdamWConfig(lr=args.lr, warmup_steps=max(5, args.steps // 20)),
        TrainerConfig(
            steps=args.steps,
            log_every=args.log_every,
            ckpt_every=args.ckpt_every,
            seed=args.seed,
            compression=args.compression,
        ),
        data_cfg=DataConfig(
            vocab_size=cfg.vocab_size,
            seq_len=args.seq,
            global_batch=args.batch,
            seed=args.seed,
        ),
        mesh=mesh,
        checkpointer=checkpointer,
        device=dev,
    )
    try:
        trainer.run()
    finally:
        if ck is not None:
            ck.close()
        if started_group:
            dist.destroy_process_group()
    if trainer.history:
        first, last = trainer.history[0], trainer.history[-1]
        print(f"[launch] loss {first['loss']:.4f} -> {last['loss']:.4f} "
              f"over {args.steps} steps")


if __name__ == "__main__":
    main()
