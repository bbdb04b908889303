"""Serving example on the port: batched requests through prefill + decode
with a KV cache (or recurrent state for rwkv6/recurrentgemma smoke
configs).

The PyTorch counterpart of ``examples/serve_batch.py``, with the same
flags, defaults, prompts (``np.random.default_rng(0)``) and printed
lines; the params come from ``PRNGKey(0)`` as the reference's do, drawn
on ``--device`` (the default is the GPU), so the f32 tokens are the
reference's.

    python examples_torch/serve_batch.py --arch yi-6b --batch 4 [--device cpu]
"""

import argparse
import sys
import time

import numpy as np

sys.path.insert(0, "src")

from repro_torch._device import resolve_device
from repro_torch.configs import get_config
from repro_torch.prng import PRNGKey
from repro_torch.models import init_params
from repro_torch.serve import ServeConfig, ServingEngine


def serve(cfg, params, batch: int = 4, prompt_len: int = 32, new_tokens: int = 24,
          temperature: float = 0.0, *, device=None) -> dict:
    """Serve ``batch`` prompts drawn as the reference draws them; print the
    example's lines and return the tokens and the numbers printed."""
    engine = ServingEngine(
        cfg, params,
        ServeConfig(max_new_tokens=new_tokens, temperature=temperature),
        device=device,
    )

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, size=(batch, prompt_len)).astype(np.int32)
    frames = None
    if cfg.is_encdec:
        frames = (rng.normal(size=(batch, cfg.encoder.n_frames, cfg.d_model)) * 0.1).astype(np.float32)

    t0 = time.perf_counter()
    out = engine.generate(prompts, frames)
    dt = time.perf_counter() - t0
    print(f"arch={cfg.name} batch={batch} prompt={prompt_len} "
          f"new={out.shape[1]-prompt_len}")
    print(f"wall={dt:.2f}s decode throughput={engine.decode_tokens_per_s:.1f} tok/s")
    for i in range(min(2, batch)):
        print(f"  request {i}: ...{out[i, prompt_len-4:prompt_len].tolist()} "
              f"-> {out[i, prompt_len:prompt_len+8].tolist()}...")
    return {"arch": cfg.name, "tokens": out, "new": out.shape[1] - prompt_len,
            "wall_s": dt, "decode_tokens_per_s": engine.decode_tokens_per_s}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None, help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=True)  # reduced config
    params = init_params(cfg, PRNGKey(0), device=dev)
    return serve(cfg, params, args.batch, args.prompt_len, args.new_tokens,
                 args.temperature, device=dev)


if __name__ == "__main__":
    main()
