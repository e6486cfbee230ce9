"""``mla_attn_ms.lm`` on hand-made Chrome traces: the device time a batch
of the kernels named for the MLA prefill attention, inside
``frontend_ms.classify`` too; None where no such kernel ran (a program
that attends through `chunked_attention`)."""
from __future__ import annotations

import json

import pytest

from bench.harness import cells, runner, trace

LM = cells.load_json("configs", "deepseek-v3-ep32")


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": 1, "args": {}}


def _read(tmp_path, kernels, metric="mla_attn_ms.lm", steps=2):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [
        _x(trace.WINDOW, "user_annotation", 1000, 1000), *kernels]}))
    ctx = runner.MetricContext(trace.parse(path), steps, 8, {}, LM,
                               {"batch": 4}, None)
    return cells.reader(metric).read(ctx)


def test_sums_the_mla_kernels_per_batch(tmp_path):
    kernels = [
        _x("(anonymous namespace)::mla_prefill_kernel(CUtensorMap_st, "
           "CUtensorMap_st, ...)", "kernel", 1100, 30),
        _x("(anonymous namespace)::mla_prefill_kernel(CUtensorMap_st, "
           "CUtensorMap_st, ...)", "kernel", 1200, 10),
        _x("nvjet_tst_192x192_64x3_2x1_v_bz_coopB_NNN", "kernel", 1300, 100),
        _x("void tiled_kernel<false>", "kernel", 1500, 50),
        _x("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 1600, 90),
    ]
    assert _read(tmp_path, kernels) == pytest.approx(0.02)
    # the front end's time holds them and the GEMM, B1 and the copy aside
    assert _read(tmp_path, kernels, "frontend_ms.classify") == \
        pytest.approx(0.07)


def test_nothing_without_the_kernel(tmp_path):
    kernels = [_x("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x128x8",
                  "kernel", 1100, 30),
               _x("void at::native::(anonymous namespace)::"
                  "cunn_SoftMaxForwardReg<float>", "kernel", 1200, 10)]
    assert _read(tmp_path, kernels) is None
    assert _read(tmp_path, []) is None
