"""The import guard: nothing the benchmark runs imports ``jax``,
``jaxlib``, ``flax`` or the JAX package ``segtpu``, and the reference
imports nothing of the program (``segtpu_torch``). Names are compared
whole, by their top-level part: ``segtpu_torch`` is not ``segtpu``.

    python -m pytest benchmark/tests -q
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
FORBIDDEN = {"jax", "jaxlib", "flax", "segtpu"}


def run_modules():
    """Every module of the benchmark but its tests."""
    return sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".", 1)[0])
    return names


def test_the_walk_sees_every_module():
    mods = run_modules()
    assert BENCH / "run.py" in mods
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert {BENCH / "metrics" / f"{m['name']}.py"
            for m in man["per_layer"]} <= set(mods)
    assert "segtpu_torch" in top_level_imports(BENCH / "program.py")


@pytest.mark.parametrize("path", run_modules(),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_nor_the_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert not names & (FORBIDDEN | {"segtpu_torch"})
    assert names <= {"__future__", "contextlib", "typing", "torch",
                     "benchmark"}


def test_whole_names_are_compared():
    from_text = lambda s: {n.split(".", 1)[0] for n in s}  # noqa: E731
    assert not from_text(["segtpu_torch.engine"]) & FORBIDDEN
    assert from_text(["segtpu.engine"]) & FORBIDDEN


def _in_a_fresh_process(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_none_of_them():
    """A whole run of a cell on the CPU, at a small size, in a process of
    its own: after it, ``sys.modules`` holds none of the names."""
    got = _in_a_fresh_process(
        "import json, sys; sys.path.insert(0, '.');"
        "from benchmark import harness;"
        "r = harness.execute('serve_arch0_city_b8', 5, 0.2, True, "
        "device='cpu', overrides={'batch': 1, 'height': 64, 'width': 64, "
        "'ring': 2, 'trace_seconds': 0.1});"
        "print(json.dumps({'found': harness.forbidden_modules(), "
        "'program': 'segtpu_torch' in sys.modules}))")
    assert got == {"found": [], "program": True}


def test_the_reference_loads_nothing_of_the_program():
    got = _in_a_fresh_process(
        "import json, sys; sys.path.insert(0, '.');"
        "import benchmark.reference.model, benchmark.reference.train;"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'jax', 'jaxlib', 'flax', 'segtpu', 'segtpu_torch'})))")
    assert got == []
