"""No file of the benchmark imports JAX, the JAX package, the repo's
JAX-side benchmark or evaluation; the plain reference imports nothing of
the port either. Names are compared whole, by their top-level part:
``srla_tpu_torch`` is not ``srla_tpu``."""

import ast
import sys
from pathlib import Path

import pytest

from perfbench import harness

HERE = Path(__file__).resolve().parent.parent
BANNED = {"jax", "jaxlib", "flax", "srla_tpu", "bench", "evaluation"}


def imported(path: Path) -> set:
    """Top-level names a file imports, statically or by a constant given
    to importlib.import_module."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", None)) \
                == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            names.add(node.args[0].value.split(".")[0])
    return names


def test_the_wrapped_layers_are_the_ports():
    from perfbench import spans
    assert {m.split(".")[0] for m, _, _ in spans.WRAPPED} == {
        "srla_tpu_torch"}


FILES = sorted(p for p in HERE.rglob("*.py"))


def test_the_walk_sees_every_file():
    assert HERE / "run.py" in FILES and HERE / "reference" / "srla.py" in FILES
    assert len(FILES) >= 20


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(
    HERE)))
def test_no_banned_import(path):
    names = imported(path)
    assert not names & BANNED, path
    if "reference" in path.relative_to(HERE).parts:
        assert "srla_tpu_torch" not in names, path


def test_the_walk_tells_the_port_from_the_jax_package(tmp_path):
    f = tmp_path / "x.py"
    f.write_text("import srla_tpu_torch.encoder\nfrom srla_tpu import x\n"
                 "importlib.import_module('jax.numpy')\n")
    assert imported(f) == {"srla_tpu_torch", "srla_tpu", "jax"}


def test_the_run_time_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "srla_tpu_torch_fake", object())
    assert "srla_tpu" not in harness.banned_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    assert harness.banned_modules() == ["jaxlib"]
