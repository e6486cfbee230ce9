"""The yardstick's frozen arithmetic against counts made another way: the
FLOP formulas against `torch.utils.flop_counter.FlopCounterMode` on the
program's real forward and training step, the teacher's MACs against the
configuration, and B1's least time against a hand count."""
from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench.harness import cells, data, port, roofline

HYBRID = cells.load_json("configs", "fig5-hybrid")
DISTILL = cells.load_json("configs", "fig5-distill")


def _student(cfg, deployed):
    from repro_torch.models import cnn

    gen = torch.Generator().manual_seed(3)
    w = data.student_weights(gen, cfg, torch.device("cpu"),
                             deployed=deployed)
    return port.module(lambda: cnn.Student(port.student_config(cfg)), w,
                       torch.device("cpu"))


def _frames(n, cfg):
    gen = torch.Generator().manual_seed(4)
    y = data.labels(gen, n, cfg["num_classes"], torch.device("cpu"))
    return data.frames(gen, y, 0.3), y


def test_paper_sizes():
    assert sum(roofline.student_conv_macs(HYBRID)) == 24_810_624
    assert roofline.student_feature_flops(HYBRID) == 2 * 24_810_624
    # forward + weight gradients + input gradients but conv1's, head
    # included: 304 GFLOP a step of 2,048
    assert roofline.student_step_flops(DISTILL) == 148_392_384


@pytest.mark.parametrize("batch", [1, 3])
def test_feature_flops_equal_the_counter(batch):
    from repro_torch.models import cnn

    model = _student(HYBRID, deployed=True)
    x, _ = _frames(batch, HYBRID)
    with FlopCounterMode(display=False) as fc:
        cnn.student_features(model, x)
    assert fc.get_total_flops() == batch * roofline.student_feature_flops(
        HYBRID)


@pytest.mark.parametrize("batch", [2, 4])
def test_step_flops_equal_the_counter(batch):
    from repro_torch.train import cnn_trainer as T

    model = _student(DISTILL, deployed=False)
    x, y = _frames(batch, DISTILL)
    zt = torch.randn((batch, DISTILL["num_classes"]),
                     generator=torch.Generator().manual_seed(5))
    loss_fn = T.student_loss(T.TrainConfig(), kd=True)
    with FlopCounterMode(display=False) as fc:
        T.value_and_grad(loss_fn, model, (x, y, zt))
    assert fc.get_total_flops() == batch * roofline.student_step_flops(
        DISTILL)


def test_teacher_is_resnet20():
    from repro_torch.models import cnn

    assert cnn.teacher_macs(port.teacher_config(DISTILL)) == \
        DISTILL["teacher_macs"]


def test_acam_bound_by_hand():
    # 4,096 x 784 f32 features, 10 x 2 x 784 f32 templates, 20 valid
    # flags (4 B), 784 thresholds, 4,096 predictions, 4,096 x 10 scores
    nbytes = (12_845_056 + 62_720 + 80 + 16_384 + 163_840 + 3_136)
    ms, by, got = roofline.acam_match_classify_bound(4096, 10, 2, 784)
    assert got == nbytes and by == "bytes"
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3, rel=1e-12)
    ops_ms = 2 * 4096 * 2 * 10 * 784 / 1.979e15 * 1e3
    assert ops_ms < ms
