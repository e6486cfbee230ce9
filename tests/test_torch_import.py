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
slice5 = {"repro_torch.kernels.tuning", "repro_torch.examples.quickstart",
          *(f"repro_torch.benchmarks.{m}" for m in (
              "common", "energy_model", "fig1_thresholds",
              "fig6_7_confusion", "kernel_bench", "run",
              "table1_compression", "table2_templates"))}
assert slice5 <= set(names), sorted(slice5 - set(names))
slice6 = {"repro_torch.checkpoint.checkpointer", "repro_torch.serve.snapshot",
          "repro_torch.fleet", "repro_torch.fleet.manifest",
          "repro_torch.fleet.policy", "repro_torch.fleet.autopilot",
          "repro_torch.benchmarks.traces",
          "repro_torch.benchmarks.serving_bench",
          "repro_torch.examples.serve_batched"}
assert slice6 <= set(names), sorted(slice6 - set(names))
slice7 = {"repro_torch.models.lm", "repro_torch.serve.engine",
          "repro_torch.serve.semantic_cache",
          "repro_torch.examples.lm_semantic_cache", "repro_torch.configs",
          *(f"repro_torch.configs.{m}" for m in (
              "qwen2_5_14b", "tinyllama_1_1b", "qwen3_1_7b", "qwen1_5_32b",
              "phi3_5_moe", "deepseek_v3", "qwen2_vl_72b", "hymba_1_5b",
              "hubert_xlarge", "mamba2_2_7b"))}
assert slice7 <= set(names), sorted(slice7 - set(names))
slice9 = {"repro_torch.launch.steps", "repro_torch.launch.train",
          "repro_torch.optim.compression",
          "repro_torch.examples.acam_head_for_hubert"}
assert slice9 <= set(names), sorted(slice9 - set(names))
slice10 = {"repro_torch.distributed", "repro_torch.distributed.context",
           "repro_torch.distributed.forcemesh", "repro_torch.launch.mesh",
           "repro_torch.match.plan", "repro_torch.fleet.reshard"}
assert slice10 <= set(names), sorted(slice10 - set(names))
slice11 = {"repro_torch.distributed.sharding", "repro_torch.ft.elastic",
           "repro_torch.launch.steps", "repro_torch.launch.mesh"}
assert slice11 <= set(names), sorted(slice11 - set(names))
slice12 = {"repro_torch.analysis", "repro_torch.analysis.census",
           "repro_torch.analysis.roofline", "repro_torch.analysis.report",
           "repro_torch.launch.shapes", "repro_torch.launch.dryrun"}
assert slice12 <= set(names), sorted(slice12 - set(names))
from repro_torch.distributed import sharding
from repro_torch.ft import elastic
from repro_torch.launch import mesh, steps
from repro_torch.core import quant
from repro_torch.models import layers, lm
assert all(hasattr(sharding, n) for n in (
    "P", "dp_axes", "param_spec", "fit_spec", "fit_tree", "param_specs",
    "opt_state_specs", "batch_specs", "cache_specs", "to_shardings",
    "register_zero3_constraints", "validate_divisibility"))
assert all(hasattr(steps, n) for n in (
    "build_train_step", "build_prefill_step", "build_decode_step",
    "build_layer_probe", "build_embed_head_probe"))
from repro_torch.analysis import census, report, roofline
from repro_torch.launch import dryrun, shapes
assert all(hasattr(census, n) for n in (
    "Census", "collective_bytes", "total_collective_bytes", "op_census",
    "bytes_with_trailing_dims", "bytes_with_chunk_pair",
    "bytes_of_layout_ops"))
assert all(hasattr(report, n) for n in (
    "load", "fmt_s", "table", "compare", "candidates", "main"))
assert hasattr(roofline, "Roofline") and hasattr(roofline, "model_flops")
assert all(hasattr(shapes, n) for n in (
    "SHAPES", "SHAPE_IDS", "applicable", "CellSpecs", "input_specs"))
assert hasattr(dryrun, "run_cell") and hasattr(dryrun, "main")
assert hasattr(lm, "_layer_decode")
assert all(hasattr(elastic, n) for n in (
    "remesh_restore", "rescale_schedule", "Heartbeat", "StragglerMonitor"))
assert hasattr(mesh, "make_production_mesh")
assert hasattr(quant, "binarize_with_stats")
assert hasattr(layers, "moe_shardmap") and hasattr(lm, "padded_heads")
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
    assert int(out.stdout.strip()) >= 114  # every module of the slices


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


def test_mesh_entry_points_need_the_card_or_an_explicit_cpu(monkeypatch):
    """The device list a mesh is built over, a serving mesh and a forced
    mesh all default to the card; on the CPU they are asked for."""
    from repro_torch.distributed import context, forcemesh
    from repro_torch.launch.mesh import make_serving_mesh

    monkeypatch.delenv("REPRO_FORCE_MESH", raising=False)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    context.clear()  # an earlier test's service may have installed one
    try:
        for fn in (context.devices, make_serving_mesh,
                   lambda: forcemesh.install((1, 2))):
            with pytest.raises(RuntimeError, match="CUDA"):
                fn()
        assert context.get_mesh() is None
        assert forcemesh.install((1, 2), device="cpu").virtual
        assert context.devices() == [torch.device("cpu")] * 2
    finally:
        context.clear()


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


def test_evaluation_entry_points_need_the_card_or_an_explicit_cpu(
        monkeypatch, tmp_path):
    """The paper benchmarks' models, the quickstart, the kernel bench and
    the tuning search resolve ``device=None`` to the card, and raise
    without one; each runs where the caller asks."""
    from repro_torch.benchmarks import common, kernel_bench
    from repro_torch.examples import quickstart
    from repro_torch.kernels import tuning

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    monkeypatch.setenv("REPRO_BENCH_SCALE", "4")
    monkeypatch.setenv("REPRO_TORCH_TUNING_CACHE", str(tmp_path / "t.json"))
    tuning.clear_cache_for_tests()
    with pytest.raises(RuntimeError, match="CUDA"):
        common.models()
    with pytest.raises(RuntimeError, match="CUDA"):
        quickstart.main(["--n-per-class", "4"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tuning.autotune_acam([(2, 3, 8)])
    with pytest.raises(RuntimeError, match="CUDA"):
        kernel_bench.compare_kernels((1,))
    assert set(tuning.autotune_acam([(2, 3, 8)], iters=1,
                                    device="cpu")) == {
        "acam_match|cpu|b2_m3_n8|float32",
        "acam_similarity|cpu|b2_m3_n8|float32"}
    tuning.clear_cache_for_tests()


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


def test_lm_entry_points_need_the_card_or_an_explicit_cpu():
    """The LM's weights, caches, the layers' inits, the semantic cache and
    the launcher's LM workloads resolve ``device=None`` to the card, and
    raise without one; the engine runs where its weights live."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import layers, lm
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.semantic_cache import SemanticCacheService
    from repro_torch.serve.spec import CascadeSpec, ServiceSpec

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg = configs.get("tinyllama-1.1b", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_params(0, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_cache(cfg, 1, 8)
    for init in (layers.rmsnorm_init, layers.layernorm_init, layers.RMSNorm,
                 layers.LayerNorm, lambda d: layers.rope_freqs(d, 1e4)):
        with pytest.raises(RuntimeError, match="CUDA"):
            init(8)
    assert layers.rmsnorm_init(8, device="cpu").scale.device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        SemanticCacheService.from_spec(
            ServiceSpec(cascade=CascadeSpec(backend="lm")))
    for workload in ("lm", "lm-cached"):
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.main(["--workload", workload, "--requests", "1"])
    eng = Engine(cfg, lm.init_params(0, cfg, device="cpu"))
    assert eng.device == torch.device("cpu")


def test_lm_training_entry_points_need_the_card_or_an_explicit_cpu():
    """The training launcher, its synthetic batches and the HuBERT example
    resolve ``device=None`` to the card, and raise without one."""
    from repro_torch import configs
    from repro_torch.examples import acam_head_for_hubert
    from repro_torch.launch import train

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg = configs.get("tinyllama-1.1b", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train.synthetic_batch(cfg, 1, 4, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        acam_head_for_hubert.main(["--steps", "1"])
    assert train.synthetic_batch(cfg, 1, 4, 0, device="cpu")[
        "inputs"].device.type == "cpu"
    assert train.main(["--smoke", "--steps", "1", "--batch", "1", "--seq",
                       "4"], device="cpu")["losses"][0] > 0
