"""EC-protected checkpointing with D-Rex placement (paper integration)."""

from .fabric import StorageFabric
from .manager import CheckpointPolicy, DRexCheckpointer

__all__ = ["StorageFabric", "CheckpointPolicy", "DRexCheckpointer"]
