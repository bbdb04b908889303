"""Share of its roofline the frontier kernel reached: the least time the
frontier DP needs at the FP64 vector peak, counted as the oracle defines
the DP for each decision's live nodes, over the kernel's device time,
both in the traced window."""

from drexbench import yardstick


def read(rec):
    if rec.dev is None:
        return None
    t = rec.dev.device_s("pb_frontier")
    if t <= 0 or not rec.facts.get("traced_ops"):
        return None
    ops = yardstick.frontier_ops(rec.facts["traced_ops"], rec.facts["n_live"])
    return 100.0 * ops / yardstick.FP64_OPS_PER_S / t
