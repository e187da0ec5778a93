"""What the benchmark loads: no JAX and no JAX package in any process it
runs, and a reference that takes nothing of the program."""
import ast
import json
import subprocess
import sys
import types
from pathlib import Path

from portbench import run

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "portbench"


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def test_the_reference_imports_nothing_of_the_program():
    for path in (PKG / "reference").glob("*.py"):
        tops = {n.split(".")[0] for n in _imports(path)}
        assert not tops & {"repro_torch", "repro", "jax", "jaxlib"}, path
    code = ("import sys; sys.path[:0] = [%r]; "
            "import portbench.reference.graph, portbench.reference.spectral;"
            " print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    assert "repro_torch" not in json.loads(out.replace("'", '"'))


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in PKG.rglob("*.py"):
        tops = {n.split(".")[0] for n in _imports(path)}
        assert not tops & set(run.FORBIDDEN), path


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_x", types.ModuleType("x"))
    assert "repro" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("x"))
    assert "repro" in run.forbidden_modules()


def test_a_run_loads_no_jax(tiny_root):
    code = f"""
import sys
sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]
from pathlib import Path
from portbench import cells, harness, run
for w in ("tiny.analysis", "tiny.synthesis", "tiny.jacobi"):
    cell = cells.resolve(Path({str(tiny_root)!r}), w)
    assert harness.run(cell, 3, 0.1, False, "cpu", 0.0)["correct"]
print(run.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
