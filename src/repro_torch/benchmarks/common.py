"""Shared state of the paper-table benchmarks: one synthetic dataset and one
set of trained models (the colour and greyscale teachers, the baseline
student and the optimised KD + prune + QAT student), reused by every table
and figure. Twin of the JAX package's `benchmarks/common.py`, with the same
data, configurations and schedules; the models train on ``device`` (the
card unless the caller asks for the CPU).

Scale, read at each call: ``REPRO_BENCH_FAST=1`` (120 images a class, 2
epochs) or ``REPRO_BENCH_SCALE=<n_per_class>``; else 400 a class and 4
epochs.
"""
from __future__ import annotations

import functools
import os
import time

import numpy as np
import torch

from repro_torch.data import synthetic
from repro_torch.device import resolve
from repro_torch.models import cnn
from repro_torch.train import cnn_trainer as T


def fast() -> bool:
    return os.environ.get("REPRO_BENCH_FAST", "0") == "1"


def n_per_class() -> int:
    return int(os.environ.get("REPRO_BENCH_SCALE",
                              "120" if fast() else "400"))


def epochs() -> int:
    return 2 if fast() else 4


@functools.lru_cache(maxsize=2)
def _data(n: int) -> dict:
    tr = synthetic.load("train", n_per_class=n, seed=0)
    te = synthetic.load("test", n_per_class=max(n // 4, 50), seed=0)
    gray_tr = synthetic.normalize(synthetic.to_grayscale(tr.images))
    gray_te = synthetic.normalize(synthetic.to_grayscale(te.images))
    return {
        "color_tr": (synthetic.normalize(tr.images), tr.labels),
        "color_te": (synthetic.normalize(te.images), te.labels),
        "gray_tr": (gray_tr, tr.labels),
        "gray_te": (gray_te, te.labels),
    }


def data() -> dict:
    """The synthetic CIFAR-10 substitute at the current scale, as numpy:
    {colour, grey} x {train, test} -> (images NHWC, labels)."""
    return _data(n_per_class())


TEACHER_CFG = cnn.TeacherConfig(width=16, blocks_per_stage=2)
TEACHER_CFG_COLOR = TEACHER_CFG
TEACHER_CFG_GRAY = cnn.TeacherConfig(in_channels=1, width=16,
                                     blocks_per_stage=2)


def _logits(model, x: np.ndarray, batch: int = 512) -> np.ndarray:
    return np.concatenate([cnn.teacher_logits(model, x[i:i + batch])
                           .cpu().numpy() for i in range(0, len(x), batch)])


@functools.lru_cache(maxsize=2)
def _models(n: int, n_epochs: int, device: torch.device) -> dict:
    d = _data(n)
    t0 = time.time()
    out = {}
    xc, yc = d["color_tr"]
    # the ResNet teacher is data-hungrier than the tiny student: 2x epochs
    out["teacher_color"] = T.train_teacher(
        xc, yc, TEACHER_CFG_COLOR, epochs=2 * n_epochs, batch_size=128,
        device=device)
    xg, yg = d["gray_tr"]
    out["teacher_gray"] = T.train_teacher(
        xg, yg, TEACHER_CFG_GRAY, epochs=2 * n_epochs, batch_size=128,
        device=device)
    # teacher logits over the grey train set (for KD)
    zt = _logits(out["teacher_gray"], xg)
    out["teacher_gray_logits"] = zt

    base_cfg = T.TrainConfig(epochs=n_epochs, batch_size=128, seed=0)
    out["student_base"], _ = T.train_student(xg, yg, cfg=base_cfg,
                                             device=device)
    opt_cfg = T.TrainConfig(epochs=n_epochs, batch_size=128, seed=0,
                            prune_epochs=2, finetune_epochs=1, qat=True)
    out["student_opt"], out["student_opt_masks"] = T.train_student(
        xg, yg, teacher_logits_all=zt, cfg=opt_cfg, do_prune=True,
        device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    out["train_time_s"] = time.time() - t0
    return out


def models(device=None) -> dict:
    """Train the benchmark model set once per scale and device (the card
    unless the caller asks for the CPU). Returns a dict of models."""
    return _models(n_per_class(), epochs(), resolve(device))


def student_feature_fn(params, x):
    return cnn.student_features(params, x)


def collect_features(params, x: np.ndarray, batch: int = 512) -> np.ndarray:
    """The student's (n, 784) features of images ``x``, as numpy."""
    return np.concatenate([student_feature_fn(params, x[i:i + batch])
                           .cpu().numpy() for i in range(0, len(x), batch)])
