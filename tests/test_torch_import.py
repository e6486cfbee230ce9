"""The port stands alone: `repro_torch` (and `chip_smoke.py`) import with
`jax` and `repro` blocked, and no source file of the port names either. Its
entry points run on the card unless the caller asks for the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

BLOCKED_IMPORT = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m in sys.modules if sys.modules[m] is not None)
print(len(names))
"""


def test_imports_with_jax_and_repro_blocked():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", BLOCKED_IMPORT], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 30  # every module of the slice


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [*PORT.rglob("*.py"),
                                       ROOT / "chip_smoke.py"]))
def test_source_names_neither_jax_nor_repro(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_resolve_defaults_to_the_card():
    from repro_torch.device import resolve

    assert resolve("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve()


def test_entry_points_need_the_card_or_an_explicit_cpu():
    from repro_torch.models.cnn import StudentConfig, init_student
    from repro_torch.serve.control import HybridService
    from repro_torch.serve.spec import ServiceSpec

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        HybridService.from_spec(ServiceSpec())
    with pytest.raises(RuntimeError, match="CUDA"):
        init_student(torch.Generator().manual_seed(0),
                     StudentConfig(filters=(2, 2, 2, 1)))
    svc = HybridService.from_spec(ServiceSpec(), device="cpu")
    assert svc.device == torch.device("cpu")


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Alone in a directory, or without CUDA, chip_smoke exits non-zero and
    prints no result."""
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(tmp_path / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
