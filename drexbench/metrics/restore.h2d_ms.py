"""Device time of host-to-device copies per restore in the traced window."""


def read(rec):
    if rec.dev is None or not rec.facts.get("traced_ops"):
        return None
    t = rec.dev.device_s("Memcpy HtoD")
    return 1e3 * t / rec.facts["traced_ops"] if t > 0 else None
