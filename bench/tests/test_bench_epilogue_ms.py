"""``epilogue_ms.classify`` on hand-made Chrome traces: the device time a
batch of the kernels named for the student's fused epilogue, inside
``frontend_ms`` too; None where no such kernel ran (a program without it)."""
from __future__ import annotations

import json

import pytest

from bench.harness import cells, runner, trace

HYBRID = cells.load_json("configs", "fig5-hybrid")


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": 1, "args": {}}


def _read(tmp_path, kernels, metric="epilogue_ms.classify", steps=2):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [
        _x(trace.WINDOW, "user_annotation", 1000, 1000), *kernels]}))
    ctx = runner.MetricContext(trace.parse(path), steps, 8, {}, HYBRID,
                               {"batch": 4}, None)
    return cells.reader(metric).read(ctx)


def test_sums_the_epilogue_kernels_per_batch(tmp_path):
    kernels = [
        _x("void (anonymous namespace)::student_epilogue_pool_kernel<4>"
           "(float const*, ...)", "kernel", 1100, 30),
        _x("void (anonymous namespace)::student_epilogue_relu_kernel<4>"
           "(float const*, ...)", "kernel", 1200, 10),
        _x("sm80_xmma_fprop_implicit_gemm_f32f32", "kernel", 1300, 100),
        _x("void tiled_kernel<false>", "kernel", 1500, 50),
        _x("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 1600, 90),
    ]
    assert _read(tmp_path, kernels) == pytest.approx(0.02)
    # the front end's time holds them, B1 and the copy aside
    assert _read(tmp_path, kernels, "frontend_ms.classify") == \
        pytest.approx(0.07)


def test_nothing_without_the_kernel(tmp_path):
    kernels = [_x("void at::native::elementwise_kernel<128, 2>", "kernel",
                  1100, 30),
               _x("void at::native::max_pool_forward_nhwc<float>", "kernel",
                  1200, 10)]
    assert _read(tmp_path, kernels) is None
    assert _read(tmp_path, []) is None
