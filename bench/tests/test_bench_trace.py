"""The trace reduction and the per-layer readers on a hand-made Chrome
trace: busy time as the union of device operations, idle gaps named by
what the host was doing, kernels tied to the operators that launched them,
and readers that report nothing where the trace has nothing to read."""
from __future__ import annotations

import json

import pytest

from bench.harness import cells, roofline, runner, trace
from bench.traffic.frames import percentile

HYBRID = cells.load_json("configs", "fig5-hybrid")
DISTILL = cells.load_json("configs", "fig5-distill")


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": args}


@pytest.fixture()
def chrome(tmp_path):
    events = [
        _x(trace.WINDOW, "user_annotation", 1000, 1000),
        _x("bench.step", "user_annotation", 1000, 900),
        _x("aten::cudnn_convolution", "cpu_op", 1010, 100),
        _x("cudaLaunchKernel", "cuda_runtime", 1020, 5, correlation=7),
        _x("aten::add", "cpu_op", 1200, 50),
        _x("cudaLaunchKernel", "cuda_runtime", 1210, 5, correlation=8),
        _x("aten::copy_", "cpu_op", 1300, 400),
        _x("cudaMemcpyAsync", "cuda_runtime", 1310, 380, correlation=9),
        # device: conv kernel 1030-1230, add 1220-1260 (overlaps),
        # copy 1600-1690, tiled_kernel 1900-1950; one before the window
        _x("implicit_gemm_fprop", "kernel", 1030, 200, correlation=7),
        _x("elementwise_add", "kernel", 1220, 40, correlation=8),
        _x("Memcpy HtoD", "gpu_memcpy", 1600, 90, correlation=9),
        _x("void tiled_kernel<false>", "kernel", 1900, 50),
        _x("early", "kernel", 500, 100),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return trace.parse(path)


def test_busy_gaps_and_window(chrome):
    assert chrome.window_s == pytest.approx(1e-3)
    assert chrome.busy() == [(1030, 1260), (1600, 1690), (1900, 1950)]
    assert chrome.busy_s() == pytest.approx((230 + 90 + 50) / 1e6)
    assert chrome.gaps() == [(1000, 1030), (1260, 1600), (1690, 1900),
                             (1950, 2000)]


def test_breakdown_names_ops_and_gaps(chrome):
    b = chrome.breakdown()
    assert b["device_ops"][0] == ["implicit_gemm_fprop", 200e-6]
    longest = b["idle_gaps"][0]
    assert longest[1] == pytest.approx(340e-6)
    assert longest[0] == "bench.step > aten::copy_ > cudaMemcpyAsync"
    assert [name for name, _ in b["idle_gaps"][1:]] == [
        "bench.step", "host outside any span",
        "bench.step > aten::cudnn_convolution"]


def test_kernels_know_their_launching_operator(chrome):
    launch = {e.name: e.launch for e in chrome.device}
    assert launch["implicit_gemm_fprop"] == "aten::cudnn_convolution"
    assert launch["elementwise_add"] == "aten::add"
    assert launch["void tiled_kernel<false>"] == ""


def _ctx(tr, config, traffic, kind="frames", steps=2, items=8):
    flops = cells.load_module("traffic", kind).flops_per_item(config)
    return runner.MetricContext(tr, steps, items, {"call_s": 0.5,
                                                   "calls": 100},
                                config, traffic, flops)


def test_readers_on_the_trace(chrome):
    frames = {"batch": 4, "pool_batches": 1}
    read = {m: cells.reader(m).read
            for m in ("frontend_ms.classify", "acam_roofline.classify",
                      "mfu.classify", "idle_share.classify", "conv_ms.train",
                      "predict_host_ms.classify", "step_host_ms.train",
                      "mfu.train", "idle_share.train")}
    ctx = _ctx(chrome, HYBRID, frames)
    assert read["frontend_ms.classify"](ctx) == pytest.approx(0.12)
    bound, _, _ = roofline.acam_match_classify_bound(4, 10, 2, 784)
    assert read["acam_roofline.classify"](ctx) == pytest.approx(
        bound / 0.05 * 100)
    assert read["idle_share.classify"](ctx) == pytest.approx(63.0)
    assert read["mfu.classify"](ctx) == pytest.approx(
        8 * 2 * 24_810_624 / 1e-3 / 67e12 * 100)
    assert read["predict_host_ms.classify"](ctx) == pytest.approx(5.0)
    tctx = _ctx(chrome, DISTILL, {"batch": 4}, kind="kd_steps")
    assert read["conv_ms.train"](tctx) == pytest.approx(0.1)
    assert read["mfu.train"](tctx) == pytest.approx(
        8 * 148_392_384 / 1e-3 / 67e12 * 100)


def test_readers_report_nothing_without_a_device(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [
        _x(trace.WINDOW, "user_annotation", 0, 100)]}))
    empty = trace.parse(path)
    for m in ("frontend_ms.classify", "acam_roofline.classify",
              "mfu.classify", "idle_share.classify", "conv_ms.train",
              "mfu.train", "idle_share.train"):
        assert cells.reader(m).read(
            _ctx(empty, HYBRID | DISTILL, {"batch": 4})) is None


def test_one_reader_serves_every_cell_kind():
    """``mfu.classify`` and ``mfu.train`` are read by ``metrics/mfu.py``;
    a reader named in full would come first."""
    assert cells.reader_path("mfu.classify").name == "mfu.py"
    assert cells.reader_path("mfu.train") == cells.reader_path("mfu")
    assert cells.reader_path("idle_share.train").name == "idle_share.py"


def test_trace_without_window_raises(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": []}))
    with pytest.raises(RuntimeError):
        trace.parse(path)


@pytest.mark.parametrize("values,q,want", [
    ([1.0], 95, 1.0), ([1.0, 2.0], 50, 1.5),
    (list(map(float, range(101))), 95, 95.0),
    (list(map(float, range(21))), 95, 19.0)])
def test_percentile(values, q, want):
    assert percentile(values, q) == pytest.approx(want)
