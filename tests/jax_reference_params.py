"""The JAX package's ``init_params`` for several smoke configs at once.

Called eagerly, as the JAX package's trainer and examples call it (under
one ``jax.jit`` XLA fuses each draw with its scaling and rounds other
elements, so a jitted init is not the reference).  Eager jax compiles
every op at every new shape, ~1-7 s a config on the CPU; the configs are
made on threads, since XLA compiles outside the GIL.
"""

from __future__ import annotations

import concurrent.futures

import jax

import repro.configs as jconfigs
from repro.models import init_params


def eager_params(archs, seed: int, dtype: str | None = None, threads: int = 8) -> dict:
    """``{arch: (cfg, params)}``: each smoke config (its dtype replaced by
    ``dtype`` when given) initialised from ``jax.random.PRNGKey(seed)``."""
    def one(arch):
        cfg = jconfigs.get_config(arch, smoke=True)
        cfg = cfg if dtype is None else cfg.with_(dtype=dtype)
        params = init_params(cfg, jax.random.PRNGKey(seed))
        return cfg, jax.block_until_ready(params)

    with concurrent.futures.ThreadPoolExecutor(threads) as pool:
        return dict(zip(archs, pool.map(one, archs)))
