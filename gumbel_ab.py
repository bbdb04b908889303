"""Compare versions of the ``gumbel_argmax`` CUDA source on one NVIDIA GPU.

Run from the repository root::

    python3 gumbel_ab.py NAME=path/to/threefry.cu [NAME=path ...] [--rounds N]

Each source is built with the kernels' flags (``nvcc`` for ``sm_90a``) and
loaded on its own.  Its C interface is read from the source: the first
design's ``gumbel_argmax(k0, k1, logits, rows, vocab, tokens, stream)`` (one
block a row), or the sliced one that also takes a scratch buffer and its
size (``kernels/threefry.py``'s ``GUMBEL_SLICE`` sizes it).  At each shape
the paths launch (a decode batch of 4 at RWKV6-1.6B's and Qwen3-8B's
vocabularies, and 64 rows) every version must give the plain version's
tokens (``kernels.ref.gumbel_argmax_ref``); then all are timed in turns
(A, B, ..., then the reverse order) on the same card, each as
``chip_smoke.py`` times the kernel: device ms a call in 20 queued calls
(``ms``) and one call at a time (``ms_single``).  Prints the card's name
and power limit and one JSON line per shape, and exits non-zero without a
card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SHAPES = ((4, 65_536), (4, 151_936), (64, 151_936))


class Version:
    def __init__(self, name: str, source: pathlib.Path):
        from repro_torch.kernels import nvcc

        m = re.search(r"int gumbel_argmax\(([^)]*)\)", source.read_text())
        if not m:
            raise ValueError(f"{source}: no gumbel_argmax entry point")
        self.name = name
        self.sliced = "scratch" in m.group(1)
        self.lib = ctypes.CDLL(str(nvcc.build(source)))
        args = [ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_longlong]
        if self.sliced:
            args += [ctypes.c_void_p, ctypes.c_longlong]
        self.lib.gumbel_argmax.argtypes = args + [ctypes.c_void_p, ctypes.c_void_p]
        self.lib.gumbel_argmax.restype = ctypes.c_int

    def __call__(self, key, logits: torch.Tensor) -> torch.Tensor:
        from repro_torch.kernels import threefry

        rows, vocab = logits.shape
        out = torch.empty((rows,), dtype=torch.int64, device=logits.device)
        args = [int(key[0]), int(key[1]), logits.data_ptr(), rows, vocab]
        if self.sliced:
            parts = rows * -(-vocab // threefry.GUMBEL_SLICE)
            scratch = torch.empty((2 * parts,), dtype=torch.int32, device=logits.device)
            args += [scratch.data_ptr(), 8 * parts]
        err = self.lib.gumbel_argmax(*args, out.data_ptr(),
                                     torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{self.name}: CUDA error {err}")
        return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("versions", nargs="+", help="NAME=path/to/threefry.cu")
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gumbel_ab: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch import prng
    from repro_torch.kernels import ref, threefry

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    versions = [Version(n, ROOT / p) for n, p in (v.split("=", 1) for v in args.versions)]
    key = prng.PRNGKey(0)
    for rows, vocab in SHAPES:
        logits = prng.normal(prng.split(key, 2)[1], (rows, vocab), device="cuda")
        want = ref.gumbel_argmax_ref(key, logits)
        for v in versions:
            if not torch.equal(v(key, logits), want):
                raise AssertionError(f"{v.name} != plain version at ({rows}, {vocab})")
        ms = {v.name: [] for v in versions}
        single = {v.name: [] for v in versions}
        for v in versions + versions[::-1]:
            ms[v.name].append(chip_smoke.queued_ms(lambda: v(key, logits),
                                                   rounds=args.rounds))
            single[v.name].append(chip_smoke.cuda_time_ms(lambda: v(key, logits),
                                                          warmup=2, reps=20))
        bound_s, by = threefry.gumbel_bound_s(rows, vocab)
        print(json.dumps({"rows": rows, "vocab": vocab, "equal_plain": True, "ms": ms,
                          "ms_single": single, "bound_ms": bound_s * 1e3, "bound_by": by}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
