"""The import guard compares whole top-level names, and the reference and
the FLOP counter load nothing of the program or of JAX."""

import ast
import subprocess
import sys
import types
from pathlib import Path

import pytest

from benchmark import harness, spec


@pytest.mark.parametrize("name,refused", [("rick_tpu_torch", False), ("rick_tpu_torch.ops", False),
                                          ("rick_tpu", True), ("rick_tpu.nn", True), ("jax.numpy", True),
                                          ("jaxlib", True), ("flax.linen", True), ("jaxtyping", False)])
def test_guard_compares_whole_top_level_names(monkeypatch, name, refused):
    for mod in list(sys.modules):
        if mod.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert bool(harness.forbidden_modules()) is refused


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


@pytest.mark.parametrize("path", sorted((spec.ROOT / "reference").glob("*.py")) + [spec.ROOT / "flops.py",
                                                                                  spec.ROOT / "roofline.py"],
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {"rick_tpu_torch", "rick_tpu", "jax", "jaxlib", "flax"}, tops


def test_reference_loads_nothing_of_the_program():
    code = ("import sys, benchmark.reference.train, benchmark.reference.fid, benchmark.flops, benchmark.inputs; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'rick_tpu_torch', 'rick_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.REPO, capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
