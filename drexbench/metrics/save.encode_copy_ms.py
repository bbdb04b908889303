"""Mean coding time of a save in the measured (untraced) window: the
checkpointer's own ``stats["encode_s"]``, which times each wave's encode
together with its one copy of the chunks to the host."""


def read(rec):
    vals = rec.facts.get("encode_s")
    return 1e3 * sum(vals) / len(vals) if vals else None
