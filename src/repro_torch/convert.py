"""Carry weights and template banks from the JAX package into the port.

Inputs are plain numpy (``np.asarray`` of each JAX leaf), so this module
imports neither JAX nor `repro`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.templates import TemplateBank
from repro_torch.device import resolve
from repro_torch.models.cnn import Student, StudentConfig


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def student_from_numpy(params: dict, *, device=None) -> Student:
    """The JAX student pytree (numpy leaves) -> the port's `Student`:
    conv ``w`` HWIO -> OIHW, ``bn*`` scale/bias/mean/var -> BatchNorm
    weight/bias/running_mean/running_var, ``head`` (F, C) -> Linear (C, F)."""
    filters = tuple(int(np.shape(params[f"conv{i}"]["w"])[3])
                    for i in range(1, 5))
    head_w = np.asarray(params["head"]["w"])
    cfg = StudentConfig(in_channels=int(np.shape(params["conv1"]["w"])[2]),
                        filters=filters, num_classes=int(head_w.shape[1]))
    if head_w.shape[0] != cfg.num_features:
        raise ValueError(f"head expects {head_w.shape[0]} features, the "
                         f"convs give {cfg.num_features}")
    model = Student(cfg)
    with torch.no_grad():
        for i in range(1, 5):
            conv = getattr(model, f"conv{i}")
            conv.weight.copy_(_t(np.transpose(params[f"conv{i}"]["w"],
                                              (3, 2, 0, 1))))
            conv.bias.copy_(_t(params[f"conv{i}"]["b"]))
        for i in (1, 2):
            bn, p = getattr(model, f"bn{i}"), params[f"bn{i}"]
            bn.weight.copy_(_t(p["scale"]))
            bn.bias.copy_(_t(p["bias"]))
            bn.running_mean.copy_(_t(p["mean"]))
            bn.running_var.copy_(_t(p["var"]))
        model.head.weight.copy_(_t(head_w.T))
        model.head.bias.copy_(_t(params["head"]["b"]))
    return model.to(resolve(device)).eval()


def bank_from_numpy(templates, lower, upper, valid, thresholds, *,
                    device=None) -> TemplateBank:
    """The five `TemplateBank` arrays (numpy) -> a port bank on a device."""
    dev = resolve(device)
    return TemplateBank(
        templates=_t(templates).to(dev), lower=_t(lower).to(dev),
        upper=_t(upper).to(dev),
        valid=torch.from_numpy(np.array(valid, dtype=bool)).to(dev),
        thresholds=_t(thresholds).to(dev))
