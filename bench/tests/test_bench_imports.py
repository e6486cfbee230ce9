"""What the benchmark may import: nothing of JAX, of the JAX package
(``repro``) or of the JAX-era ``benchmarks/`` (top-level names compared
whole, so ``repro_torch`` passes), and, in ``bench/reference/``, nothing
of the program either."""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
JAX_SIDE = ("jax", "jaxlib", "flax", "repro", "benchmarks")

# a finder that refuses the named top-level modules, then imports
BLOCKED_IMPORT = """
import importlib, importlib.abc, sys
BLOCKED = set(sys.argv[1].split(","))
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
sys.path[:0] = [sys.argv[2], sys.argv[2] + "/src"]
from bench.harness import cells
for mod in sys.argv[3].split(","):
    if mod.endswith(".py"):
        kind, name = mod.split("/")[-2], mod.split("/")[-1][:-3]
        cells.load_module(kind, name)
    else:
        importlib.import_module(mod)
loaded = sorted({m.split(".")[0] for m in sys.modules} & BLOCKED)
assert not loaded, loaded
print("ok")
"""


def _modules(sub: str | None = None) -> list[str]:
    """Every module of bench/ (or of its ``sub`` folder) but the tests,
    as dotted names, or as paths for the folders loaded by path."""
    out = []
    for path in sorted(BENCH.rglob("*.py")):
        rel = path.relative_to(BENCH)
        if rel.parts[0] in ("tests",) or (sub and rel.parts[0] != sub):
            continue
        if rel.parts[0] in ("traffic", "metrics"):
            out.append(str(rel))
        elif len(rel.parts) > 1:
            out.append("bench." + ".".join(rel.with_suffix("").parts)
                       .replace(".__init__", ""))
    return out


def _import_blocked(blocked, modules, script: str = BLOCKED_IMPORT
                    ) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-c", script, ",".join(blocked), str(ROOT),
         ",".join(modules)], capture_output=True, text=True, timeout=600,
        cwd=ROOT)


def test_every_module_imports_without_jax():
    done = _import_blocked(JAX_SIDE, _modules())
    assert done.returncode == 0 and "ok" in done.stdout, done.stderr[-3000:]


def test_entry_points_import_without_jax():
    done = _import_blocked(JAX_SIDE, ["bench.run", "bench.calibrate"])
    assert done.returncode == 0 and "ok" in done.stdout, done.stderr[-3000:]


# a small run of every cell on the CPU, the program's modules imported as a
# run imports them, with the JAX side refused
BLOCKED_RUN = BLOCKED_IMPORT.replace("from bench.harness import cells", """
import torch
from bench.harness import cells, runner
from bench.tests.test_bench_checks import small
for name in [w["name"] for w in cells.manifest()["workloads"]]:
    out = runner.run(small(cells.load(name)), seed=5, seconds=0.05, traced=False,
                     device=torch.device("cpu"), t_start=0.0)
    assert out["correct"], (name, out["checks"])
    assert not runner.forbidden_modules()""")


def test_cells_run_without_jax():
    done = _import_blocked(JAX_SIDE, ["repro_torch"], BLOCKED_RUN)
    assert done.returncode == 0 and "ok" in done.stdout, done.stderr[-3000:]


def test_reference_imports_nothing_of_the_program():
    done = _import_blocked(JAX_SIDE + ("repro_torch",),
                           _modules("reference"))
    assert done.returncode == 0 and "ok" in done.stdout, done.stderr[-3000:]


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_source_names_no_program_module(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in JAX_SIDE + ("repro_torch",), (path, name)
            if top == "bench":
                assert name.startswith("bench.reference"), (path, name)
