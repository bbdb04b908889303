"""Architecture registry of the port: the JAX package's ``repro.configs``.

Every architecture module exposes ``CONFIG`` (the exact published
configuration) and ``SMOKE`` (a reduced same-family configuration used by
the CPU tests), as data equal to the JAX package's.  ``input_specs``
gives the dry run's abstract inputs: meta-device tensors (shapes and
dtypes, no storage) for every model input of a cell.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any

import torch

from repro_torch.models.config import ModelConfig

ARCH_IDS = [
    "whisper_tiny",
    "qwen3_8b",
    "yi_6b",
    "nemotron_4_15b",
    "nemotron_4_340b",
    "qwen2_moe_a2_7b",
    "qwen3_moe_30b_a3b",
    "rwkv6_1_6b",
    "chameleon_34b",
    "recurrentgemma_9b",
]

# canonical external ids (--arch flag) -> module names
_ALIASES = {
    "whisper-tiny": "whisper_tiny",
    "qwen3-8b": "qwen3_8b",
    "yi-6b": "yi_6b",
    "nemotron-4-15b": "nemotron_4_15b",
    "nemotron-4-340b": "nemotron_4_340b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "chameleon-34b": "chameleon_34b",
    "recurrentgemma-9b": "recurrentgemma_9b",
}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def normalize(arch: str) -> str:
    a = _ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    if a not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch!r}; known: {sorted(_ALIASES)}")
    return a


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{normalize(arch)}")
    return mod.SMOKE if smoke else mod.CONFIG


def cell_supported(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """Is (arch x shape) a valid dry-run cell? (DESIGN.md §5 skip rules)."""
    spec = SHAPES[shape]
    if spec.name == "long_500k" and not cfg.sub_quadratic:
        return False, (
            "long_500k needs sub-quadratic attention; "
            f"{cfg.name} is full-attention (skip per DESIGN.md §5)"
        )
    return True, ""


def input_specs(cfg: ModelConfig, shape) -> dict[str, Any]:
    """Meta-device stand-ins for every model input of this cell (the
    reference's ``ShapeDtypeStruct``s: same shapes and dtypes).  ``shape``
    names one of :data:`SHAPES`, or is a :class:`ShapeSpec`."""
    from repro_torch.models.model import init_serve_state

    spec = shape if isinstance(shape, ShapeSpec) else SHAPES[shape]
    b, t = spec.global_batch, spec.seq_len

    def sd(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    frames = lambda: sd((b, cfg.encoder.n_frames, cfg.d_model), cfg.dt)
    if spec.kind == "train":
        batch = {"tokens": sd((b, t), torch.int32), "labels": sd((b, t), torch.int32)}
        if cfg.is_encdec:
            batch["frames"] = frames()
        return {"batch": batch}
    if spec.kind == "prefill":
        out = {"tokens": sd((b, t), torch.int32)}
        if cfg.is_encdec:
            out["frames"] = frames()
        return out
    # decode: one new token against a seq_len-deep state
    cache_len = t if not cfg.sub_quadratic else (cfg.attn_window or 2048)
    return {
        "token": sd((b, 1), torch.int32),
        "pos": sd((), torch.int32),
        "state": init_serve_state(cfg, b, cache_len, device="meta"),
    }


def all_cells() -> list[tuple[str, str, bool, str]]:
    """(arch, shape, supported, skip_reason) for the full 40-cell grid."""
    out = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES:
            ok, why = cell_supported(cfg, shape)
            out.append((arch, shape, ok, why))
    return out
