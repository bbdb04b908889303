"""PyTorch/CUDA port of the D-Rex reproduction.

Mirrors the JAX package's layout (``repro.X.Y`` <-> ``repro_torch.X.Y``)
for the modules ported so far.  Imports ``torch`` and ``numpy`` only:
never ``jax`` and nothing of the JAX package.  Device entry points run
on ``cuda`` unless the caller passes ``device="cpu"``.
"""
