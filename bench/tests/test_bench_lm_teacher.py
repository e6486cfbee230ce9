"""The two traffic kinds added with the DeepSeek-V3 front end and the
teacher's step: their operation counts against
`torch.utils.flop_counter.FlopCounterMode` on the program's own forward and
step, the published sizes, and the ``mfu.lm`` reader by hand."""
from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench.harness import cells, data, port, runner, trace
from bench.tests.test_bench_checks import small

LM_CELL = "deepseek-v3-ep32.doc-chunks-b4x4096"
TEACHER_CELL = "fig5-distill.teacher-b2048"
LM = cells.load_json("configs", "deepseek-v3-ep32")
DISTILL = cells.load_json("configs", "fig5-distill")


def _kind(cell):
    return cells.kind_of(cells.load(cell))


@pytest.mark.parametrize("seed", [1, 2**31 + 3])
def test_lm_flops_equal_the_counter(seed):
    """The counter sees every query against every key (the chunks compute
    the masked rectangle); the formula counts the causal half, so the
    difference is that rectangle's upper part exactly."""
    from repro_torch.models import layers as L
    from repro_torch.models import lm

    cell = small(cells.load(LM_CELL))
    cfg, p = cell.config, cell.workload["traffic"]
    kind = cells.kind_of(cell)
    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(seed)
    weights = kind.draw_weights(gen, cfg, cpu)
    arch = kind.arch_config(cfg)
    model = lm.init_params(0, arch, device="meta")
    model.load_state_dict(weights, assign=True)
    b, s = p["batch"], p["seq_len"]
    labels = torch.arange(b) % cfg["num_classes"]
    x = kind.sequences(gen, labels, cfg, p)
    counts = L.MoECounts()
    with FlopCounterMode(display=False) as fc:
        lm.features(model, arch, x, counts=counts)
    h = cfg["num_attention_heads"]
    width = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"] \
        + cfg["v_head_dim"]
    upper = 2 * b * cfg["num_hidden_layers"] * h * width * s * (
        s - (s + 1) / 2)
    want = (b * kind.flops_per_sequence(cfg, s) + upper
            + counts.held_rows * kind.routed_flops_per_row(cfg))
    assert counts.held_rows > 0
    assert fc.get_total_flops() == pytest.approx(want, rel=1e-12)


def test_lm_published_sizes():
    """Per token at S 4,096: MLA projections 374.2 MFLOP a layer, causal
    attention 167.8, the dense MLP 792.7, router and shared expert 91.8;
    a routed row 88.1; about 108.6 TFLOP a batch of 4 x 4,096 with 512
    rows a held expert a layer."""
    kind = _kind(LM_CELL)
    per_row = kind.routed_flops_per_row(LM)
    assert per_row == pytest.approx(88.08e6, rel=1e-3)
    s = 4096
    per_seq = kind.flops_per_sequence(LM, s)
    per_token = (7 * (374.17e6 + 167.8e6) + 3 * 792.7e6 + 4 * 91.75e6)
    assert per_seq / s == pytest.approx(per_token, rel=1e-3)
    rows = 4 * 8 * 512
    batch = 4 * per_seq + rows * per_row
    assert batch == pytest.approx(108.6e12, rel=2e-3)


def test_teacher_step_flops_equal_the_counter():
    from repro_torch.models import cnn
    from repro_torch.train import cnn_trainer as T

    kind = _kind(TEACHER_CELL)
    gen = torch.Generator().manual_seed(3)
    cpu = torch.device("cpu")
    tw = data.teacher_weights(gen, DISTILL, cpu)
    model = port.module(lambda: cnn.Teacher(port.teacher_config(DISTILL)),
                        tw, cpu)
    y = data.labels(gen, 2, DISTILL["num_classes"], cpu)
    x = data.frames(gen, y, 0.3)
    with FlopCounterMode(display=False) as fc:
        T.value_and_grad(T.teacher_loss, model, (x, y))
    assert fc.get_total_flops() == 2 * kind.flops_per_item(DISTILL)
    # 497 GFLOP a step of 2,048
    assert 2048 * kind.flops_per_item(DISTILL) == 497_284_546_560


def test_mfu_lm_by_hand(tmp_path):
    """Two sequences and 10 routed rows in a 1 ms stretch."""
    import json

    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "name": trace.WINDOW, "cat": "user_annotation",
         "ts": 0, "dur": 1000, "pid": 1, "tid": 1, "args": {}},
        {"ph": "X", "name": "gemm", "cat": "kernel", "ts": 10, "dur": 500,
         "pid": 1, "tid": 2, "args": {}}]}))
    tr = trace.parse(path)
    kind = _kind(LM_CELL)
    traffic = {"kind": "lm_classify", "seq_len": 4096}
    host = {"call_s": 1.0, "calls": 1, "traced_held_rows": 10}
    ctx = runner.MetricContext(tr, 1, 2, host, LM, traffic, None)
    want = (2 * kind.flops_per_sequence(LM, 4096)
            + 10 * kind.routed_flops_per_row(LM)) / 1e-3 / 989.4e12 * 100
    assert cells.reader("mfu.lm").read(ctx) == pytest.approx(want)
    # no held-row counter (a program without it): nothing read
    ctx = ctx._replace(host={"call_s": 1.0, "calls": 1})
    assert cells.reader("mfu.lm").read(ctx) is None


@pytest.mark.parametrize("lowered", ["route", "attention"])
def test_equal_input_checks_each_read_their_own_part(lowered, monkeypatch):
    """On the inputs the program's timed path recorded, the reference
    with only its router logits (or only its attention scores) rounded to
    bf16 moves that part's reading, and the other part's stays as the
    sound one: each equal-input check sees a precision lowered in its part
    alone. (In float32 at this size the lowered scores read 1.9e-3, under
    the card's limit, which sits above the bf16 program's 2.5e-3: the card
    readings in PERF.md set it.)"""
    cell = small(cells.load(LM_CELL))
    cfg, p, limits = (cell.config, cell.workload["traffic"],
                      cell.workload["limits"])
    kind = cells.kind_of(cell)
    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(5)
    weights = kind.draw_weights(gen, cfg, cpu)
    cal_y = torch.arange(cfg["num_classes"]).repeat_interleave(
        cfg["calibration_sequences_per_class"])
    cal_x = kind.sequences(gen, cal_y, cfg, p)
    system = kind.PortClassifier(cfg, weights, cal_x, cal_y, cpu,
                                 p["batch"])
    labels = torch.arange(p["batch"]) % cfg["num_classes"]
    _, taps = system.predict_recorded(kind.sequences(gen, labels, cfg, p), 0)
    prec = kind.precision_of(cfg)
    flips, _, gap = kind.equal_input_gaps(weights, cfg, [taps], prec, cpu)
    assert flips == 0 and gap < 1e-5
    part = getattr(kind.ref, lowered)
    below = kind.precision_of(cfg, below=True)
    monkeypatch.setattr(kind.ref, lowered,
                        lambda *a: part(*a[:-1], below))
    flips_below, _, gap_below = kind.equal_input_gaps(weights, cfg, [taps],
                                                      prec, cpu)
    if lowered == "route":
        assert flips_below > limits["route_flips_equal_input"]
        assert gap_below == gap
    else:
        assert gap_below > 5e-4 and flips_below == 0
