"""The reference imports nothing of JAX, the JAX package or the program, and
no module of the harness imports JAX or the JAX package (whole top-level
names: the port's name begins with the JAX package's)."""

import ast
from pathlib import Path

import pytest

from portbench import run

PORTBENCH = Path(__file__).resolve().parents[1]
JAX_SIDE = {"jax", "jaxlib", "flax", "blurred_gan_tpu"}


def imported_top_levels(path: Path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted((PORTBENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_neither_jax_nor_the_program(path):
    assert not imported_top_levels(path) & (JAX_SIDE | {"blurred_gan_tpu_torch"})


@pytest.mark.parametrize("path", sorted(p for p in PORTBENCH.rglob("*.py")
                                        if "tests" not in p.parts),
                         ids=lambda p: str(p.relative_to(PORTBENCH)))
def test_harness_imports_no_jax(path):
    assert not imported_top_levels(path) & JAX_SIDE


def test_the_module_check_compares_whole_top_level_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "blurred_gan_tpu_torch_x", types.ModuleType("x"))
    before = run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "blurred_gan_tpu.ops", types.ModuleType("y"))
    assert run.forbidden_modules() == sorted(set(before) | {"blurred_gan_tpu"})
    assert "blurred_gan_tpu_torch" not in run.FORBIDDEN_MODULES
