"""Checkpoint bytes saved a second: the state's bytes times the saves the
window ran, over the window's wall time (first save's start to the last
one's end)."""


def read(rec):
    return rec.facts["state_bytes"] * rec.facts["n_ops"] / rec.window_s / 1e9
