"""Serving layer of the port — two unrelated planes, namespaced apart:

* :mod:`repro_torch.serve.engine` — the batched **token**-serving engine
  (prefill + decode loop over the model zoo);
* :mod:`repro_torch.serve.placement` — the streaming **placement**
  service (admission queue, micro-batched ``place_many`` windows,
  snapshot-epoch reads over a
  :class:`~repro_torch.core.engine.PlacementEngine`).

``TokenServingEngine`` is the unambiguous name for the former;
``ServingEngine`` remains as the original alias.
"""

from . import placement
from .engine import ServeConfig, ServingEngine

#: explicit name so call sites never conflate the token-serving engine
#: with the storage placement service in :mod:`repro_torch.serve.placement`.
TokenServingEngine = ServingEngine

__all__ = ["ServeConfig", "ServingEngine", "TokenServingEngine", "placement"]
