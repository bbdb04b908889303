"""Items the placement service decided (placed, or rejected because no
mapping meets the item's target and capacity) over the window's wall
time."""


def read(rec):
    return rec.facts["n_ops"] / rec.window_s
