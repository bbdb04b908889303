"""The DeepSeek-V2-Lite expert-parallel configuration: its payload table
against the plain reference at the published widths, the eight ranks'
shares against the published parameter count, and a small cut of the
same leaf pattern through the port's save, node loss, batched restore
and repair on the CPU, byte for byte."""

import collections
import copy
import dataclasses
import json
import math

import pytest
import torch

from drexbench import catalog, harness, tiny
from drexbench.drivers import _ckpt
from drexbench.drivers.ckpt_restore import mismatch_bytes
from drexbench.reference import dsv2_lite_leaves

CONFIG = "drex_sc.most_used.dsv2lite_ep8"
CELL = "ckpt.dsv2lite_ep8.restore_node_lost"


def _conf() -> dict:
    entry = {c["name"]: c for c in catalog.load_benchmark()["configs"]}[CONFIG]
    with open(catalog.ROOT / entry["file"]) as f:
        return json.load(f)


def _published(conf: dict) -> dict:
    """The model's published config: the file's top-level keys with the
    whole expert count in place of the share's."""
    ep = conf["expert_parallel"]
    return dict(conf, n_routed_experts=ep["n_routed_experts_published"])


def test_payload_is_the_reference_share_at_the_published_widths():
    conf = _conf()
    ep = conf["expert_parallel"]
    want = dsv2_lite_leaves.leaves(_published(conf), ep["ep_size"], ep["ep_rank"])
    got = [(name, tuple(shape)) for name, shape in conf["payload"]["leaves"]]
    assert got == want
    assert len(got) == 923
    assert dsv2_lite_leaves.param_count(got) == conf["payload"]["params"] == 3_110_989_312
    experts = [n for n, _ in got if ".mlp.experts." in n]
    assert len(experts) == 26 * 8 * 3
    assert {n.split(".")[5] for n in experts} == {str(e) for e in range(8)}
    assert conf["n_routed_experts"] * ep["ep_size"] == ep["n_routed_experts_published"] == 64
    assert conf["reduced"] == ["n_routed_experts"]


def test_config_file_is_one_json_object_within_64_kib():
    """The 923-leaf table keeps one leaf a line and no padding, so the file
    stays within the 64 KiB that the benchmark's files are held to."""
    entry = {c["name"]: c for c in catalog.load_benchmark()["configs"]}[CONFIG]
    raw = (catalog.ROOT / entry["file"]).read_bytes()
    assert len(raw) <= 64 * 1024
    assert raw.isascii()
    assert isinstance(json.loads(raw), dict)


def test_the_eight_shares_make_the_published_model():
    """Tensors every rank holds alike counted once, each rank's experts
    its own: the published 15,706,484,224 parameters, as the whole model
    (one rank) gives."""
    conf = _conf()
    pub, ep = _published(conf), conf["expert_parallel"]
    seen: dict = {}
    for rank in range(ep["ep_size"]):
        for name, shape in dsv2_lite_leaves.leaves(pub, ep["ep_size"], rank):
            assert seen.setdefault(name, shape) == shape
    total = sum(math.prod(s) for s in seen.values())
    assert total == dsv2_lite_leaves.param_count(dsv2_lite_leaves.leaves(pub))
    assert total == ep["params_published"] == 15_706_484_224


def _small_cut(conf: dict) -> list:
    """The share's leaf pattern with every width divided by 16, layer 0
    (dense) and two MoE layers, 8 experts a rank."""
    pub = _published(conf)
    for key in ("hidden_size", "intermediate_size", "moe_intermediate_size", "kv_lora_rank",
                "qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim", "vocab_size"):
        pub[key] = -(-pub[key] // 16)
    pub["num_hidden_layers"] = 3
    ep = conf["expert_parallel"]
    return [[n, list(s)] for n, s in dsv2_lite_leaves.leaves(pub, ep["ep_size"], ep["ep_rank"])]


def _expected_batches(manifest, fabric, limit: int) -> int:
    """Batches of whole consecutive leaves whose staged bytes (K chunk
    rows a group, as stored) stay within ``limit``, a larger leaf alone."""
    batches, size = 0, None
    for leaf in manifest["leaves"]:
        n = 0
        for g in leaf["groups"]:
            row = next(fabric.get(node, f"{g['key']}_r{r}") for r, node in enumerate(g["node_ids"])
                       if fabric.get(node, f"{g['key']}_r{r}") is not None)
            n += g["k"] * len(row)
        if size is None or size + n > limit:
            batches, size = batches + 1, 0
        size += n
    return batches


@pytest.mark.parametrize("batch_bytes", [1 << 18, 1 << 20])
def test_small_cut_restores_in_batches_byte_exact(batch_bytes, monkeypatch):
    from repro_torch.checkpoint import manager

    monkeypatch.setattr(manager, "_RESTORE_BATCH_BYTES", batch_bytes)
    cell = tiny.tiny_cell(CELL)
    config = copy.deepcopy(cell.config)
    config["payload"]["leaves"] = _small_cut(_conf())
    config["policy"]["item_mb"] = 0.05
    cell = dataclasses.replace(cell, config=config)
    rec = harness.Record(cell, 2**31 + 28, 0.0, False, torch.device("cpu"), 0.0)
    with tiny.one_thread():
        ck, fabric, _arr, state = _ckpt.build(rec)
        try:
            manifest = ck.save(state, 1)
            groups = _ckpt.groups_of(manifest)
            held = collections.Counter(n for g in groups for n in g["node_ids"])
            victim = min(held, key=lambda n: (-held[n], n))
            ck.on_node_failure(victim)
            assert any(g["node_ids"].index(victim) < g["k"] for g in groups
                       if victim in g["node_ids"])
            want = _expected_batches(manifest, fabric, batch_bytes)
            n_leaves = len(state)
            assert n_leaves == 83 and 1 < want < n_leaves
            like = {name: torch.empty(0) for name in state}
            out, step = ck.restore_latest(like)
            assert step == 1 and list(out) == list(state)
            assert int(mismatch_bytes(out, state)) == 0
            assert ck.stats["restore_batches"] == want
            staged = sum(g["k"] * g["chunk_len"] for g in groups)
            assert ck.stats["restore_staged_bytes"] == staged
            assert ck.stats["restore_pad_bytes"] == staged - _ckpt.state_bytes(state)
            assert ck.repair() > 0
            assert ck.repair() == 0
            again = ck.restore(1, like)
            assert int(mismatch_bytes(again, state)) == 0
            assert ck.stats["restore_batches"] == 2 * want
        finally:
            ck.close()
