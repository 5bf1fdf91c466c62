"""Nothing under benchmark/ imports JAX, jaxlib, flax or the JAX package
(the top-level module name compared whole: the program's
``pose_refine_tpu_torch`` begins with ``pose_refine_tpu``), and the
reference imports nothing of the program."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "pose_refine_tpu"}
PROGRAM = "pose_refine_tpu_torch"


def _top_imports(path: Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            out.add(str(node.args[0].value).split(".")[0])
    return out


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    assert not _top_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = _top_imports(path)
    assert PROGRAM not in names
    assert names <= {"__future__", "contextlib", "typing", "numpy", "torch", "reference"}


def test_the_check_is_by_whole_top_level_name():
    src = "import pose_refine_tpu_torch\nfrom pose_refine_tpu_torch.ops import x\n"
    tree = ast.parse(src)
    tops = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names}
    assert tops == {PROGRAM} and not tops & FORBIDDEN
    assert "pose_refine_tpu" in FORBIDDEN


def test_run_refuses_a_loaded_jax_module(monkeypatch):
    import sys
    import types

    import run
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert run.forbidden_modules() == ["jax.numpy"]
    monkeypatch.delitem(sys.modules, "jax.numpy")
    monkeypatch.setitem(sys.modules, "pose_refine_tpu", types.ModuleType("pose_refine_tpu"))
    assert "pose_refine_tpu" in run.forbidden_modules()
