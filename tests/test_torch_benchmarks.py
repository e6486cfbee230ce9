"""The port's paper benchmarks (`repro_torch.benchmarks`) on the CPU: the
energy model equals the JAX package's dict exactly, Table I's analytic
columns equal the JAX package's analytic functions, the harness writes
every row the JAX harness writes (finite, at a tiny scale), and the kernel
bench's JSON keeps the JAX schema with ``"kernels": "plain"``."""
import importlib.util
import json
import math
from pathlib import Path

import jax
import pytest

from repro.models import cnn as jcnn
from repro_torch.benchmarks import (energy_model, kernel_bench, run,
                                    table1_compression)

ROOT = Path(__file__).resolve().parents[1]
PAPER_ROWS = ("train_models", "table1_compression", "table2_templates",
              "fig1_thresholds", "fig6_7_confusion", "energy_model")
# the JAX kernel bench's entries (its sharded rows need a forced mesh)
KERNEL_ROWS = ("acam_match", "acam_similarity", "acam_match_classify_fused",
               "acam_device_classify", "acam_match_serve",
               "acam_similarity_serve")
SHAPES = (1, 3)


def _jax_benchmark(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", ROOT / "benchmarks" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def tiny(monkeypatch):
    """10 images a class (no full training batch: every step is skipped),
    kernel bench at B 1 and 3 with a 20-class big bank, one timed call."""
    monkeypatch.setenv("REPRO_BENCH_FAST", "1")
    monkeypatch.setenv("REPRO_BENCH_SCALE", "10")
    monkeypatch.setattr(kernel_bench, "SMOKE_SHAPES", SHAPES)
    monkeypatch.setattr(kernel_bench, "BIG_CLASSES", 20)
    monkeypatch.setattr(kernel_bench, "ITERS", 1)


def test_energy_model_equals_jax():
    assert energy_model.run() == _jax_benchmark("energy_model").run()


def test_table1_analytic_columns_equal_jax(tiny):
    rows = {r["model"]: r for r in table1_compression.run(device="cpu")}
    key = jax.random.PRNGKey(0)
    tc, tg = jcnn.TeacherConfig(width=16, blocks_per_stage=2), \
        jcnn.TeacherConfig(in_channels=1, width=16, blocks_per_stage=2)
    macs_c, macs_g = jcnn.teacher_macs(tc), jcnn.teacher_macs(tg)
    s_macs = jcnn.student_macs()["total"]
    s_params = jcnn.count_params(jcnn.init_student(key))
    want = {
        "teacher_colour": (jcnn.count_params(jcnn.init_teacher(key, tc)),
                           macs_c, "1:1"),
        "teacher_greyscale": (jcnn.count_params(jcnn.init_teacher(key, tg)),
                              macs_g, f"{macs_c / macs_g:.2f}:1"),
        "student_base": (s_params, s_macs, f"{macs_c / s_macs:.0f}:1"),
        "student_optimised": (s_params, int(s_macs * 0.2),
                              f"{macs_c / int(s_macs * 0.2):.0f}:1")}
    assert set(rows) == set(want)
    for model, (params, macs, ratio) in want.items():
        assert (rows[model]["params"], rows[model]["macs"],
                rows[model]["compression"]) == (params, macs, ratio), model
        for col in ("accuracy", "f1", "precision", "recall"):
            assert 0.0 <= rows[model][col] <= 1.0


def _finite(x) -> bool:
    if isinstance(x, dict):
        return all(_finite(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return all(_finite(v) for v in x)
    return not isinstance(x, float) or math.isfinite(x)


def test_run_writes_every_jax_row(tiny, tmp_path):
    rows = run.main(["--out", str(tmp_path), "--device", "cpu"])
    names = [name for name, _, _ in rows]
    kernels = [f"{k}_b{b}" for b in SHAPES for k in KERNEL_ROWS[:4]]
    kernels += [f"{k}_b{b}" for b in SHAPES for k in KERNEL_ROWS[4:]]
    kernels += [f"acam_similarity_classify_chunked_b{b}" for b in SHAPES]
    assert names == [*PAPER_ROWS, *kernels, "kd_loss_ref_64x32k",
                     "chunked_attention_1k"]
    assert all(math.isfinite(us) and us > 0 for _, us, _ in rows)
    details = json.loads((tmp_path / "bench_details.json").read_text())
    assert set(details) == set(PAPER_ROWS)
    assert details["train_models"]["n_per_class"] == 10
    for name in PAPER_ROWS[1:]:
        assert _finite(details[name]), name
    t2 = details["table2_templates"]
    assert [r.get("templates_per_class") for r in t2[:3]] == [1, 2, 3]
    assert t2[3]["silhouette_best_k"] in (1, 2, 3)
    assert details["energy_model"] == energy_model.run()
    bench = json.loads((tmp_path / "BENCH_torch_kernels.json").read_text())
    assert bench["kernels"] == "plain"


def test_kernel_bench_json_schema_on_the_cpu(tiny, tmp_path):
    entries = kernel_bench.compare_kernels(SHAPES, iters=1, device="cpu")
    path = tmp_path / "bench.json"
    kernel_bench.write_bench_json(entries, str(path), device="cpu")
    payload = json.loads(path.read_text())
    assert payload == {"backend": "cpu", "kernels": "plain", "card": None,
                       "entries": entries}
    assert [e["kernel"] for e in entries] == \
        [k for _ in SHAPES for k in KERNEL_ROWS[:4]]
    keys = {"kernel", "b", "m", "n", "ref_us", "kernel_us", "speedup",
            "ref_cell_matches_per_us", "kernel_cell_matches_per_us"}
    for e in entries:
        assert keys <= set(e) and (e["m"], e["n"]) == (10, 784)
        assert e["speedup"] > 0 and math.isfinite(e["kernel_us"])
        if e["kernel"] in ("acam_match", "acam_similarity"):
            assert e["block"] in ("local", "narrow")  # today's designs
    assert kernel_bench.sharded_classify_entries(SHAPES, device="cpu") == []
