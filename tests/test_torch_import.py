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
slice3 = {"repro_torch.kernels.kd_loss.kd_loss", "repro_torch.kernels.kd_loss.ops",
          "repro_torch.kernels.kd_loss.ref",
          "repro_torch.kernels.flash_attention.flash_attention",
          "repro_torch.kernels.flash_attention.ops",
          "repro_torch.kernels.flash_attention.ref",
          "repro_torch.models.layers", "repro_torch.core.distill",
          "repro_torch.core.prune", "repro_torch.data.synthetic",
          "repro_torch.data.pipeline", "repro_torch.optim.optimizers",
          "repro_torch.train.cnn_trainer"}
assert slice3 <= set(names), sorted(slice3 - set(names))
assert "repro_torch.core.matching" in names  # slice 4: the shims
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
    assert int(out.stdout.strip()) >= 60  # every module of the four slices


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


def test_device_physics_entry_points_need_the_card_or_an_explicit_cpu():
    """`acam.program`, `ACAMHead.to_acam` and
    `MatchEngine.sweep_program_noise` resolve ``device=None`` to the card,
    and raise without one."""
    from repro_torch import match
    from repro_torch.core import acam
    from repro_torch.core.hybrid import ACAMHead
    from repro_torch.core.templates import TemplateBank

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    rows = torch.zeros((2, 1, 4))
    bank = TemplateBank(rows, rows, rows, torch.ones((2, 1), dtype=torch.bool),
                        torch.zeros(4))
    valid = torch.ones(2, dtype=torch.bool)
    eng = match.engine_for(backend="device")
    with pytest.raises(RuntimeError, match="CUDA"):
        acam.program(rows[:, 0], rows[:, 0], valid, acam.ACAMConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        ACAMHead(bank).to_acam()
    with pytest.raises(RuntimeError, match="CUDA"):
        eng.sweep_program_noise(torch.zeros((3, 4)), bank, 2)
    assert acam.program(rows[:, 0], rows[:, 0], valid, acam.ACAMConfig(),
                        device="cpu").lower.device == torch.device("cpu")
    assert ACAMHead(bank).to_acam(device="cpu").valid.device.type == "cpu"
    pred, _ = eng.sweep_program_noise(torch.zeros((3, 4)), bank, 2,
                                      device="cpu")
    assert pred.shape == (2, 3) and pred.device.type == "cpu"


def test_training_entry_points_need_the_card_or_an_explicit_cpu():
    """The teacher, both trainers and the weight carrier resolve
    ``device=None`` to the card, and raise without one."""
    import numpy as np

    from repro_torch import convert
    from repro_torch.models.cnn import TeacherConfig, init_teacher
    from repro_torch.train import cnn_trainer

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg = TeacherConfig(in_channels=1, width=2, blocks_per_stage=1)
    x = np.zeros((4, 32, 32, 1), np.float32)
    y = np.zeros(4, np.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_teacher(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        cnn_trainer.train_teacher(x, y, cfg, epochs=1, batch_size=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        cnn_trainer.train_student(x, y)
    teacher = init_teacher(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.teacher_from_numpy(convert.to_numpy(teacher))


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


def test_registry_defaults_to_the_card():
    """`TemplateBankRegistry` resolves its device like every entry point:
    the card by default, a raise without one, the CPU only when asked."""
    from repro_torch.serve.registry import TemplateBankRegistry

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        TemplateBankRegistry(8)
    reg = TemplateBankRegistry(8, device="cpu")
    assert reg.device == torch.device("cpu") and len(reg) == 0
