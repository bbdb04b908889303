"""Host time per restore in the traced window spent in the CUDA runtime's
``cudaEventSynchronize`` and ``cudaStreamSynchronize``: the program's
waits for the card inside a restore (the staging's waits for its copies
to the card).  The benchmark's own ``cudaDeviceSynchronize`` after each
restore is not counted.  A restore that never waits reads 0."""

WAITS = ("cudaEventSynchronize", "cudaStreamSynchronize")


def read(rec):
    if rec.dev is None or not rec.dev.host or not rec.facts.get("traced_ops"):
        return None
    t0, t1 = rec.dev.t0_ns, rec.dev.t1_ns
    ns = sum(max(0, min(e, t1) - max(s, t0)) for name, s, e in rec.dev.host if name in WAITS)
    return ns / 1e6 / rec.facts["traced_ops"]
