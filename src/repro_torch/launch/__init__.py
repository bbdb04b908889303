"""Launchers of the port: the training driver (``launch/train.py``), the
mesh constructors (``launch/mesh.py``) and the multi-pod dry run
(``launch/dryrun.py``)."""

__all__: list[str] = []
