"""Mean placement time of a save in the measured (untraced) window: the
checkpointer's own ``stats["place_s"]`` (its ``place_many`` over the
save's groups)."""


def read(rec):
    vals = rec.facts.get("place_s")
    return 1e3 * sum(vals) / len(vals) if vals else None
