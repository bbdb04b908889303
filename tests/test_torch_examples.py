"""The port's examples (``examples_torch/``) held against the JAX
package's (``examples/``) on the CPU: the placement explorer and the
serving example, and the import hygiene of all four.  The training
examples are held in ``test_torch_examples_quickstart.py``,
``test_torch_examples_no_checkpoint.py`` and
``test_torch_examples_failover.py``.

Each JAX example runs as its command line does (``runpy`` with its
stdout captured); its port runs through ``main(argv)`` with ``--device
cpu``.

* ``placement_explorer``: every printed line equal, the two wall-time
  columns (``ms/item``, ``amort``) left out; the default table also equal
  to the reference values written below.
* ``serve_batch``: with the config in f32, each package drawing its own
  params from ``PRNGKey(0)`` as its example does, the served tokens equal
  the JAX engine's on the example's prompts; in bf16 the example runs and
  prints the reference's lines.
"""

from __future__ import annotations

import ast
import contextlib
import functools
import importlib.util
import io
import pathlib
import re
import runpy
import sys

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import init_params as j_init
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JServingEngine

import repro_torch.configs as tconfigs
from repro_torch.models import init_params
from repro_torch.prng import PRNGKey

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ("placement_explorer", "serve_batch", "quickstart", "elastic_failover")


def port_example(name: str):
    """The module ``examples_torch/<name>.py``."""
    spec = importlib.util.spec_from_file_location(f"examples_torch_{name}",
                                                  ROOT / "examples_torch" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_reference(name: str, *argv: str) -> str:
    """Run ``examples/<name>.py`` as its command line does; its stdout."""
    out = io.StringIO()
    saved = sys.argv
    sys.argv = [f"examples/{name}.py", *argv]
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(str(ROOT / "examples" / f"{name}.py"), run_name="__main__")
    finally:
        sys.argv = saved
    return out.getvalue()


def run_port(name: str, *argv: str) -> tuple[dict, str]:
    """``examples_torch/<name>.py``'s ``main(argv)``: (its result, its stdout)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = port_example(name).main(list(argv))
    return result, out.getvalue()


# -- import hygiene ------------------------------------------------------------------------


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_imports_neither_jax_nor_repro(name):
    tree = ast.parse((ROOT / "examples_torch" / f"{name}.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add((node.module or "").split(".")[0])
    assert "repro_torch" in roots
    assert not roots & {"jax", "jaxlib", "repro"}, roots


def test_every_example_has_a_port():
    assert sorted(p.stem for p in (ROOT / "examples").glob("*.py")) == sorted(EXAMPLES)
    assert sorted(p.stem for p in (ROOT / "examples_torch").glob("*.py")) == sorted(EXAMPLES)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_defaults_to_the_card(name, monkeypatch):
    """No device given means CUDA; without a card the example raises
    before it runs anything, and nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_example(name).main([])


# -- placement_explorer --------------------------------------------------------------------

#: a batched row: name, caps, placed/n, then the two wall-time columns.
_BATCHED = re.compile(r"^(\S+ +\S+ +\d+/\d+) +[\d.]+ +[\d.]+x(.*)$")


def without_wall_time(text: str) -> list[str]:
    return [(m.group(1) + " | " + m.group(2)) if (m := _BATCHED.match(line)) else line
            for line in text.splitlines()]


@functools.lru_cache(maxsize=None)
def explorer(argv: tuple) -> tuple:
    """(the reference's stdout, the port's result, the port's stdout) for
    ``argv``, each run once per test process."""
    want = run_reference("placement_explorer", *argv)
    got, printed = run_port("placement_explorer", *argv, "--device", "cpu")
    return want, got, printed


EXPLORER_ARGS = pytest.mark.parametrize("argv", [(), ("--fill", "0.1")],
                                        ids=["defaults", "fill0.1"])


def sections(text: str) -> list[list[str]]:
    """The header, the §5 table and the batched rows (wall time left out)."""
    return [without_wall_time(part) for part in text.strip("\n").split("\n\n")]


@EXPLORER_ARGS
def test_explorer_table_equals_reference(argv):
    want, _, printed = explorer(argv)
    want, got = sections(want), sections(printed)
    assert len(got) == len(want) == 3
    assert got[:2] == want[:2]


@EXPLORER_ARGS
def test_explorer_batched_rows_equal_reference(argv):
    want, _, printed = explorer(argv)
    want, got = sections(want)[2], sections(printed)[2]
    assert len(got) == len(want) == 10
    assert got == want


@EXPLORER_ARGS
def test_explorer_result_matches_its_lines(argv):
    _, got, printed = explorer(argv)
    assert [r["algorithm"] for r in got["table"]] == [r["algorithm"] for r in got["batched"]]
    assert all(r["placed"] == sum(p is not None for p in r["placements"])
               for r in got["batched"])
    assert f"{got['n_items']} items" in printed.splitlines()[0]


#: examples/placement_explorer.py with its defaults (most_used, meva,
#: random_nines, fill 0.95): stored share, throughput, top (K, P) choices;
#: then placed of 200 and the top reject reason.
REFERENCE_TABLE = {
    "drex_sc": ("69.2%", "94.74", "(4, 1)x137, (3, 3)x82, (3, 2)x70"),
    "drex_lb": ("64.5%", "92.12", "(2, 1)x116, (2, 2)x95, (2, 3)x80"),
    "greedy_min_storage": ("76.7%", "78.93", "(9, 1)x187, (7, 3)x97, (6, 4)x96"),
    "greedy_least_used": ("54.4%", "100.57", "(2, 1)x246, (2, 3)x166, (2, 2)x151"),
    "ec(3,2)": ("60.1%", "104.29", "(3, 2)x647"),
    "ec(4,2)": ("53.5%", "100.26", "(4, 2)x564"),
    "ec(6,3)": ("60.1%", "77.14", "(6, 3)x632"),
    "daos": ("43.5%", "95.62", "(1, 3)x173, (4, 2)x75, (8, 1)x75"),
}
REFERENCE_BATCHED = {"drex_sc": 200, "drex_lb": 200, "greedy_min_storage": 200,
                     "greedy_least_used": 200, "ec(3,2)": 139, "ec(4,2)": 128,
                     "ec(6,3)": 163, "daos": 200}
FIXED_REJECT = "fixed (K,P) cannot meet reliability target"


def test_explorer_defaults_give_the_reference_values():
    _, got, printed = explorer(())
    assert printed.splitlines()[0] == ("nodes=most_used (raw 126 GB), dataset=meva, "
                                       "1055 items, RT=random_nines")
    table = {line.split()[0]: line.split(None, 3)[1:] for line in sections(printed)[1][1:]}
    assert list(table) == list(REFERENCE_TABLE) == [r["algorithm"] for r in got["table"]]
    for name, (stored, thr, top) in REFERENCE_TABLE.items():
        assert table[name] == [stored, thr, top]
    for row in got["batched"]:
        assert (row["placed"], row["n"]) == (REFERENCE_BATCHED[row["algorithm"]], 200)
        assert row["top_reject"] == ("" if row["placed"] == 200 else FIXED_REJECT)


# -- serve_batch ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["yi_6b", "qwen3_8b", "rwkv6_1_6b", "recurrentgemma_9b",
                                  "whisper_tiny"])
def test_serve_batch_f32_tokens_equal_jax_engine(arch, capsys):
    """The example's serving at its defaults (B = 4, 32-token prompts, 24
    new tokens, greedy), its prompts (and whisper's frames) drawn as the
    reference draws them, in f32, each package's params from its own
    ``PRNGKey(0)`` (nothing carried across)."""
    jc = jconfigs.get_config(arch, smoke=True).with_(dtype="float32")
    tc = tconfigs.get_config(arch, smoke=True).with_(dtype="float32")
    jp = j_init(jc, jax.random.PRNGKey(0))
    got = port_example("serve_batch").serve(
        tc, init_params(tc, PRNGKey(0), device="cpu"), device="cpu")

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, jc.vocab_size, size=(4, 32)).astype(np.int32)
    frames = None
    if jc.is_encdec:
        frames = (rng.normal(size=(4, jc.encoder.n_frames, jc.d_model)) * 0.1).astype(np.float32)
    want = JServingEngine(jc, jp, JServeConfig(max_new_tokens=24)).generate(prompts, frames)
    np.testing.assert_array_equal(got["tokens"], np.asarray(want))
    assert got["new"] == 24 and got["decode_tokens_per_s"] > 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f"arch={tc.name} batch=4 prompt=32 new=24"
    assert lines[2] == (f"  request 0: ...{got['tokens'][0, 28:32].tolist()} "
                        f"-> {got['tokens'][0, 32:40].tolist()}...")


@pytest.mark.parametrize("argv", [(), ("--arch", "rwkv6-1.6b", "--batch", "2")],
                         ids=["defaults", "rwkv6"])
def test_serve_batch_bf16_prints_the_reference_lines(argv):
    want = run_reference("serve_batch", *argv).splitlines()
    got, printed = run_port("serve_batch", *argv, "--device", "cpu")
    printed = printed.splitlines()
    assert len(printed) == len(want)
    assert printed[0] == want[0]
    assert re.fullmatch(r"wall=[\d.]+s decode throughput=[\d.]+ tok/s", printed[1])
    for a, b in zip(printed[2:], want[2:]):
        assert a.split(":")[0] == b.split(":")[0]
    b = 2 if argv else 4
    assert got["tokens"].shape == (b, 32 + 24) and got["tokens"].dtype == np.int32
