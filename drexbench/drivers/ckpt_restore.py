"""Closed-loop restores after a storage node is lost.

Set-up saves the state once, then fail-stops the node holding the most
chunks (ties to the lowest id), so every group that had a data chunk
there has to be decoded from its survivors; one restore warms up.  The
window runs ``restore_latest`` back to back, each ending when the
restored leaves are on the card.  The reference is the state the
benchmark made: right after each restore's span, every restored leaf is
compared with it byte for byte on the card (a few milliseconds of reads
a restore, queued behind the restore), the count of bytes that differ
is added up there, and nothing of the restore is kept.
"""

from __future__ import annotations

import collections

from drexbench.harness import Check, window
from . import _ckpt


def _sync(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def run(rec, hooks: dict) -> None:
    import torch

    mix = rec.cell.traffic
    ck, fabric, arr, state = _ckpt.build(rec)
    try:
        manifest = ck.save(state, 1)
        groups = _ckpt.groups_of(manifest)
        held = collections.Counter(n for g in groups for n in g["node_ids"])
        victim = min(held, key=lambda n: (-held[n], n))
        ck.on_node_failure(victim)
        lost = [sum(1 for row, n in enumerate(g["node_ids"]) if n == victim and row < g["k"])
                for g in groups]
        readable = sum(1 for g in groups for row, n in enumerate(g["node_ids"])
                       if n == victim and fabric.get(n, f"{g['key']}_r{row}") is not None)
        if readable:
            raise RuntimeError(f"{readable} chunks of failed node {victim} are still readable")
        if "checkpointer" in hooks:
            hooks["checkpointer"](ck)
        # a state with the leaf names on the card: where restored leaves land
        like = {name: torch.empty(0, device=rec.device) for name in state}
        bad = torch.zeros((), dtype=torch.int64, device=rec.device)
        for _ in range(int(mix["warmup_restores"])):
            out, _step = ck.restore_latest(like)
            bad.add_(mismatch_bytes(out, state))
            del out
            _sync(rec.device)
        done = []

        def one_restore() -> None:
            with rec.spans.span("restore"):
                out, _step = ck.restore_latest(like)
                _sync(rec.device)
            bad.add_(mismatch_bytes(out, state))
            done.append(1)

        n = window(rec, one_restore)
        rec.attempted, rec.failed = n, 0
        rec.facts.update(state_bytes=_ckpt.state_bytes(state), n_ops=n, victim=victim,
                         traced_ops=len(done) - n, restores_compared=len(done),
                         groups=groups, lost_rows=lost,
                         degraded_groups=sum(1 for e in lost if e))
        if "capture" in hooks:
            hooks["capture"](dict(state=state))
        rec.checks.append(Check("restore_mismatch_bytes", float(int(bad)),
                                float(mix["limits"]["restore_mismatch_bytes"])))
    finally:
        ck.close()


def mismatch_bytes(out, state):
    """Bytes of the restored state that differ from the state made, as a
    0-d tensor on the state's device (no wait for the card)."""
    import torch

    bad = torch.zeros((), dtype=torch.int64, device=next(iter(state.values())).device)
    for name, want in state.items():
        nbytes = want.numel() * want.element_size()
        got = out.get(name) if isinstance(out, dict) else None
        if (got is None or got.dtype != want.dtype or tuple(got.shape) != tuple(want.shape)
                or got.device != want.device):
            bad += nbytes
            continue
        a = got.contiguous().view(-1).view(torch.uint8)
        b = want.contiguous().view(-1).view(torch.uint8)
        bad += (a != b).sum()
    extra = set(out) - set(state) if isinstance(out, dict) else set()
    return bad + len(extra)
