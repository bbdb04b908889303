"""Serving layer of the port: the streaming **placement** service
(:mod:`repro_torch.serve.placement` — admission queue, micro-batched
``place_many`` windows, snapshot-epoch reads over a
:class:`~repro_torch.core.engine.PlacementEngine`).

The JAX package's ``repro.serve`` also exports the batched token-serving
engine (``ServeConfig``, ``ServingEngine``, ``TokenServingEngine``); it
serves the model zoo and is ported with the LM stack, not here.
"""

from . import placement

__all__ = ["placement"]
