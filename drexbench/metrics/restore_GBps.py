"""Checkpoint bytes restored a second: the state's bytes times the
restores the window ran, over the window's wall time.  A restore ends
when its leaves are on the card."""


def read(rec):
    return rec.facts["state_bytes"] * rec.facts["n_ops"] / rec.window_s / 1e9
