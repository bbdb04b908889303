"""The benchmark of the PyTorch and CUDA port of D-Rex (``repro_torch``).

Run a cell with ``python3 drexbench/run.py``; see ``drexbench/README.md``.
Nothing here imports JAX or the JAX package the port was made from.
"""
