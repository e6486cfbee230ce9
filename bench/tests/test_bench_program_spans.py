"""The readers of the program's spans (``program_span`` metrics) on a
hand-made Chrome trace: exact values, nothing from a program that records
no span, 0.0 for a span the program no longer records, one reader of the
hand-off spans for both cell kinds; and a traced CPU run of each cell that
reports each of its span metrics."""
from __future__ import annotations

import json

import pytest

from bench.harness import cells, runner, trace
from bench.tests.test_bench_checks import run

#: every ``program_span`` metric of the manifest
SPAN_METRICS = [m["name"] for m in cells.manifest()["per_layer"]
                if m["source"] == "program_span"]


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": 1, "args": {}}


def _u(name, ts, dur):
    return _x(name, "user_annotation", ts, dur)


def _parse(tmp_path, events) -> trace.Trace:
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [
        _u(trace.WINDOW, 0, 1000)] + events}))
    return trace.parse(path)


def _read(metric: str, tr: trace.Trace, steps: int = 2):
    ctx = runner.MetricContext(tr, steps, 8, {"call_s": 0.1, "calls": 4},
                               {}, {}, None)
    return cells.reader(metric).read(ctx)


#: two batches of predict (100 us of hand-off, 200 of front end, 150 of
#: engine of which 40 re-layout), then two training steps (300 us of
#: hand-off, 150 of gradient, 50 of update); device work 0-120, 380-420,
#: 520-700 and 900-950
PROGRAM = [
    _u("bench.predict", 0, 460),
    _u("repro_torch.predict", 0, 450),
    _u("repro_torch.predict.to_device", 0, 100),
    _u("repro_torch.predict.frontend", 100, 200),
    _u("repro_torch.match.classify", 300, 150),
    _u("repro_torch.acam.layout", 310, 40),
    _u("repro_torch.train.to_device", 500, 300),
    _u("repro_torch.train.step", 800, 300),  # clipped at the window's end
    _u("repro_torch.train.grad", 800, 150),
    _u("repro_torch.train.update", 950, 50),
    _x("implicit_gemm_fprop", "kernel", 0, 120),
    _x("Memcpy HtoD", "gpu_memcpy", 380, 40),
    _x("elementwise_add", "kernel", 520, 180),
    _x("void tiled_kernel<false>", "kernel", 900, 50),
]


def test_host_ms_readers_sum_their_spans_per_step(tmp_path):
    tr = _parse(tmp_path, PROGRAM)
    want = {"copy_host_ms.classify": 0.2, "copy_host_ms.train": 0.2,
            "frontend_host_ms.classify": 0.1, "match_host_ms.classify": 0.075,
            "layout_host_ms.classify": 0.02, "grad_host_ms.train": 0.075,
            "update_host_ms.train": 0.025}
    for metric, value in want.items():
        assert _read(metric, tr) == pytest.approx(value), metric
    assert _read("layout_host_ms.classify", tr, steps=4) == pytest.approx(
        0.01)


def test_copy_host_ms_serves_both_cells(tmp_path):
    """One reader for every ``repro_torch.*.to_device`` span: predict's
    frames in one cell, the trainer's batch in the other."""
    assert cells.reader_path("copy_host_ms.classify") == \
        cells.reader_path("copy_host_ms.train")
    frames = _parse(tmp_path, [e for e in PROGRAM
                               if "train" not in e["name"]])
    steps = _parse(tmp_path, [e for e in PROGRAM
                              if "predict" not in e["name"]])
    assert _read("copy_host_ms.classify", frames) == pytest.approx(0.05)
    assert _read("copy_host_ms.train", steps) == pytest.approx(0.15)


def test_idle_in_program_counts_idle_time_inside_program_spans(tmp_path):
    tr = _parse(tmp_path, PROGRAM)
    # idle 120-380, 420-520, 700-900, 950-1000; spans open 0-450 and
    # 500-1000: all but 450-500
    want = (380 - 120) + (450 - 420) + (520 - 500) + (900 - 700) + (
        1000 - 950)
    assert _read("idle_in_program.classify", tr) == pytest.approx(
        want / 1000 * 100)
    assert _read("idle_in_program.train", tr) == \
        _read("idle_in_program.classify", tr)
    idle_share = cells.reader("idle_share.train").read(
        runner.MetricContext(tr, 2, 8, {}, {}, {}, None))
    assert idle_share - _read("idle_in_program.train", tr) == \
        pytest.approx(5.0)


def test_no_program_span_reads_nothing(tmp_path):
    """The program before its spans: every reader returns None."""
    tr = _parse(tmp_path, [e for e in PROGRAM
                           if not e["name"].startswith("repro_torch.")])
    assert tr.device
    for metric in SPAN_METRICS:
        assert _read(metric, tr) is None, metric


def test_idle_in_program_without_a_device_reads_nothing(tmp_path):
    tr = _parse(tmp_path, [e for e in PROGRAM
                           if e["cat"] == "user_annotation"])
    assert _read("idle_in_program.classify", tr) is None
    assert _read("copy_host_ms.classify", tr) == pytest.approx(0.2)


@pytest.mark.parametrize("gone,metric", [
    ("repro_torch.acam.layout", "layout_host_ms.classify"),
    ("repro_torch.predict.frontend", "frontend_host_ms.classify"),
    ("repro_torch.train.update", "update_host_ms.train")])
def test_a_span_taken_off_the_path_reads_zero(tmp_path, gone, metric):
    tr = _parse(tmp_path, [e for e in PROGRAM if e["name"] != gone])
    assert _read(metric, tr) == 0.0


def test_manifest_lists_each_span_metric_once():
    """Each span metric once, with a reader, in cells of the manifest."""
    man = cells.manifest()
    names = {w["name"] for w in man["workloads"]}
    assert len(SPAN_METRICS) == len(set(SPAN_METRICS))
    for m in man["per_layer"]:
        if m["source"] == "program_span":
            assert cells.reader_path(m["name"]).is_file(), m["name"]
            assert set(m.get("workloads", names)) <= names, m["name"]


@pytest.mark.parametrize("name", [w["name"] for w in
                                  cells.manifest()["workloads"]])
def test_traced_cpu_run_reports_the_span_metrics(name):
    """Each ``*_host_ms`` span metric a cell lists reads above 0 on a
    traced CPU run; with no device, nothing idles in the program."""
    out = run(name, 2**31 + 77, traced=True)
    assert out["correct"], out["checks"]
    for m in cells.load(name).per_layer:
        if m["source"] != "program_span":
            continue
        stem = m["name"].split(".")[0]
        if stem.endswith("_host_ms"):
            assert out["metrics"][m["name"]]["value"] > 0, m["name"]
        elif stem == "idle_in_program":
            assert m["name"] not in out["metrics"], m["name"]
