"""The import check compares top-level names whole, and no file of the
benchmark imports JAX or the JAX package; the references import nothing
of the port."""
from __future__ import annotations

import ast
import sys
import types

import pytest

from portbench import harness

FILES = sorted(p for p in (harness.ROOT / "portbench").rglob("*.py"))


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("name,caught", [
    ("legosnark_tpu", True), ("legosnark_tpu.curve", True), ("jax", True),
    ("jaxlib", True), ("flax", True), ("legosnark_tpu_torch", False),
    ("legosnark_tpu_torch.curve", False), ("jaxtyping", False)])
def test_forbidden_modules_by_whole_top_level_name(monkeypatch, name, caught):
    for mod in harness.FORBIDDEN_MODULES:
        monkeypatch.delitem(sys.modules, mod, raising=False)
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert (name.split(".")[0] in harness.forbidden_modules()) is caught


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(harness.ROOT)))
def test_no_jax_import(path):
    assert not set(_imports(path)) & set(harness.FORBIDDEN_MODULES)


@pytest.mark.parametrize("path", sorted(
    (harness.ROOT / "portbench" / "reference").glob("*.py")),
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "legosnark_tpu_torch" not in set(_imports(path))
    assert "portbench" not in set(_imports(path))
