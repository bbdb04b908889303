"""What the checkpoint cells share: the checkpointer over the configured
cluster, the state from the seed, and the manifest facts the yardstick
and the reference read."""

from __future__ import annotations

from drexbench import inputs
from drexbench.reference import rs

__all__ = ["build", "state_bytes", "toucher", "groups_of", "leaf_bytes",
           "manifest_error_bytes"]


def build(rec):
    """(checkpointer, fabric, cluster arrays, state) for the record's cell."""
    from repro_torch.checkpoint import CheckpointPolicy, DRexCheckpointer, StorageFabric
    from repro_torch.core.types import StorageNode

    conf = rec.cell.config
    arr = inputs.cluster_arrays(conf["cluster"])
    nodes = [
        StorageNode(node_id=i, capacity_mb=float(arr.capacity_mb[i]),
                    write_bw=float(arr.write_bw[i]), read_bw=float(arr.read_bw[i]),
                    annual_failure_rate=float(arr.afr[i]), name=arr.names[i],
                    used_mb=float(arr.used_mb[i]), rack=int(arr.rack[i]))
        for i in range(arr.n)
    ]
    fabric = StorageFabric(nodes)
    ck = DRexCheckpointer(fabric, conf["scheduler"], CheckpointPolicy(**conf["policy"]),
                          device=rec.device)
    state = inputs.make_state(conf["payload"], rec.seed, rec.device)
    return ck, fabric, arr, state


def state_bytes(state) -> int:
    return sum(t.numel() * t.element_size() for t in state.values())


def toucher(state, stride_bytes: int):
    """``touch(step)``: in every leaf, the two bytes at each multiple of
    ``stride_bytes`` (offset 0 included) take the step's number, so that
    each group of a leaf changes with every step.  One strided write a
    leaf, queued on the current stream."""
    import torch

    views = []
    for t in state.values():
        v = t.view(-1).view(torch.int16)
        views.append(v[:: max(1, stride_bytes // 2)])

    def touch(step: int) -> None:
        value = (int(step) % 0x7FFF) + 1
        for v in views:
            v.fill_(value)

    return touch


def groups_of(manifest) -> list[dict]:
    """Every group of a manifest in order, with its chunk length."""
    out = []
    for leaf in manifest["leaves"]:
        for g in leaf["groups"]:
            out.append(dict(g, chunk_len=rs.chunk_len(g["orig_nbytes"], g["k"])))
    return out


def leaf_bytes(state) -> dict:
    """Each leaf's raw bytes as a flat uint8 tensor on its own device."""
    import torch

    return {name: t.contiguous().view(-1).view(torch.uint8) for name, t in state.items()}


def manifest_error_bytes(manifest, conf, state) -> int:
    """Bytes of the leaves whose manifest entry differs from the state's
    layout (name, shape, dtype, the cut into groups, each group's
    length): a restore could not give them back as they were."""
    leaves = manifest["leaves"]
    if [m["name"] for m in leaves] != list(state):
        return state_bytes(state)
    group = int(float(conf["policy"]["item_mb"]) * 1e6)
    bad = 0
    for m in leaves:
        t = state[m["name"]]
        n = t.numel() * t.element_size()
        want = [min(group, n - off) if n else 0 for off in range(0, max(n, 1), group)]
        if (list(m["shape"]) != list(t.shape) or m["dtype"] != str(t.dtype).removeprefix("torch.")
                or [g["orig_nbytes"] for g in m["groups"]] != want):
            bad += n
    return bad
