"""Nothing under drexbench/ imports JAX or the JAX package the port was
made from, the reference imports nothing of the port, and nothing reads
the JAX package's benchmark folder."""

import ast
import pathlib

import pytest

BENCH = pathlib.Path(__file__).resolve().parent
FILES = sorted(p for p in BENCH.rglob("*.py") if ".cache" not in p.parts)
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("__import__", "import_module") and node.args
              and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)):
            names.add(node.args[0].value.split(".", 1)[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_or_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    """Plain numpy or PyTorch only: nothing of the port, nor of the
    harness around the reference."""
    names = top_level_imports(path)
    assert names <= {"__future__", "concurrent", "dataclasses", "math", "typing", "numpy",
                     "torch"}, names


def test_the_guard_compares_whole_top_level_names():
    from drexbench import harness

    assert "repro" in harness.FORBIDDEN and "repro_torch" not in harness.FORBIDDEN
    assert top_level_imports(pathlib.Path(harness.__file__)) & FORBIDDEN == set()


def test_nothing_reads_the_jax_benchmarks():
    for path in FILES + sorted(BENCH.rglob("*.json")):
        text = path.read_text()
        if path.name == "test_drexbench_imports.py":
            continue
        assert "benchmarks/" not in text and "import benchmarks" not in text, path
