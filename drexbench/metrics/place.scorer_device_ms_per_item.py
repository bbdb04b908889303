"""Device time of the placement path other than the frontier kernel
(the scorer's kernels, copies and fills) per item decided in the traced window."""


def read(rec):
    if rec.dev is None or not rec.facts.get("traced_ops"):
        return None
    t = rec.dev.device_s(".", exclude="pb_frontier")
    return 1e3 * t / rec.facts["traced_ops"] if t > 0 else None
