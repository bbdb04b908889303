"""Share of its roofline the coding kernel reached in the traced window's
saves: the least time the encodes' bytes need at the HBM rate (every data
chunk byte read once and every parity byte written once, from the manifests)
over the kernel's device time in the trace."""

from drexbench import yardstick


def read(rec):
    if rec.dev is None:
        return None
    t = rec.dev.device_s("rs_bitmatmul")
    if t <= 0 or not rec.facts.get("traced_encode_bytes"):
        return None
    return 100.0 * rec.facts["traced_encode_bytes"] / yardstick.HBM_BYTES_PER_S / t
