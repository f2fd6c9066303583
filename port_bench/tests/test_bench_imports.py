"""Nothing the benchmark runs imports JAX, flax or the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's), and the reference imports nothing of the program."""
from __future__ import annotations

import ast
import subprocess
import sys
import types

import pytest

from port_bench import run
from port_bench.spec import HERE, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "scene_generation_tpu"}


def imported_tops(path) -> set:
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_source_imports_jax(path):
    assert not imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = imported_tops(path)
    assert "scene_generation_tpu_torch" not in tops
    assert tops <= {"__future__", "contextlib", "math", "typing", "torch",
                    "port_bench"}


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "scene_generation_tpu_torch_x",
                        types.ModuleType("scene_generation_tpu_torch_x"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "scene_generation_tpu.models",
                        types.ModuleType("scene_generation_tpu.models"))
    assert run.forbidden_modules() == ["scene_generation_tpu"]


def test_a_run_loads_no_jax():
    """A serving and a training run at a CPU test's size, in a fresh
    process: what the program loads counts too."""
    code = (
        "import torch, sys\n"
        "from port_bench import run\n"
        "from port_bench.tests.bench_cells import tiny_cell\n"
        "for w in ('coco128.serve_b16', 'coco128.train_b12'):\n"
        "    run.execute(tiny_cell(w), 5, 0.3, False, torch.device('cpu'),\n"
        "                run.program_entries(), 0.0)\n"
        "print(run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
