"""Seconds from the start of the process to the start of the window:
imports, inputs from the seed, kernel builds, the warm-up operation."""


def read(rec):
    return rec.setup_s
