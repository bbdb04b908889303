"""Traffic drivers: each runs one kind of traffic mix, named by the mix
file's ``driver`` key, and fills the run's :class:`~drexbench.harness.Record`."""
