"""Share of its roofline the coding kernel reached in the traced window's
restores: the least time the decodes' bytes need at the HBM rate (for
each group that lost a data chunk, K surviving chunks read once and each
lost data chunk written once) over the kernel's device time."""

from drexbench import yardstick


def read(rec):
    if rec.dev is None:
        return None
    t = rec.dev.device_s("rs_bitmatmul")
    if t <= 0 or not rec.facts.get("traced_ops"):
        return None
    per = yardstick.decode_bytes(rec.facts["groups"], rec.facts["lost_rows"])
    return 100.0 * per * rec.facts["traced_ops"] / yardstick.HBM_BYTES_PER_S / t
