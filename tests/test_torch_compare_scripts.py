"""The repo-root measurement scripts of the port (compare_*.py,
profile_port.py) run on a CUDA card only. They build their workloads from
chip_smoke.py's helpers (imported as ``CS``), so a helper renamed or removed
there breaks them where no CPU test reaches: compare_lift.py called
``most_kernels`` after chip_smoke.py had replaced it with
``checked_kernels``, and failed on the card. This test reads each script and
holds every ``CS.<name>`` it uses to a top-level name of chip_smoke.py."""

from __future__ import annotations

import ast
import pathlib
import re

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
SCRIPTS = ("compare_lift.py", "compare_icp.py", "compare_nn_flash.py", "compare_kdtree.py",
           "compare_raster.py", "profile_port.py")


def top_level_names(path: pathlib.Path) -> set:
    """The functions, classes and assigned names at the top of a module."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            names |= {n.id for t in targets for n in ast.walk(t) if isinstance(n, ast.Name)}
    return names


@pytest.mark.parametrize("script", SCRIPTS)
def test_script_uses_chip_smoke_helpers_that_exist(script):
    used = set(re.findall(r"\bCS\.(\w+)", (REPO / script).read_text()))
    assert used, f"{script} uses no chip_smoke.py helper through CS"
    missing = sorted(used - top_level_names(REPO / "chip_smoke.py"))
    assert not missing, f"{script} calls chip_smoke.py names it does not define: {missing}"
