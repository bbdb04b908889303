"""Launchers of the port: the training driver (``launch/train.py``).  The
mesh constructors and the multi-pod dry run wait for ``ROADMAP.md``
Queue 1, item 4."""

__all__: list[str] = []
