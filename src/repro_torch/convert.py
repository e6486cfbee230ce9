"""Carry weights, prune masks and template banks between the JAX package
and the port.

Inputs and outputs are plain numpy (``np.asarray`` of each JAX leaf), so
this module imports neither JAX nor `repro`. The JAX pytrees nest dicts
named like the port's modules: a conv or dense ``{"w", "b"}`` (HWIO / (in,
out)) is a ``Conv2d`` / ``Linear`` (OIHW / (out, in)); a BatchNorm
``{"scale", "bias", "mean", "var"}`` is a ``BatchNorm2d``'s weight, bias
and running statistics.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.templates import TemplateBank
from repro_torch.device import resolve
from repro_torch.models.cnn import (Student, StudentConfig, Teacher,
                                    TeacherConfig)

# JAX leaf name -> the port's, for dense/conv and BatchNorm dicts
_DENSE = {"w": "weight", "b": "bias"}
_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean",
       "var": "running_var"}


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


def _to_port_layout(w: np.ndarray) -> np.ndarray:
    w = np.asarray(w)
    return np.transpose(w, (3, 2, 0, 1)) if w.ndim == 4 else w.T


def _flatten(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    """A JAX params (or masks) pytree -> the port's ``state_dict`` names,
    leaves in the port's layouts."""
    flat = {}
    for key, sub in tree.items():
        if "w" in sub:
            flat[f"{prefix}{key}.weight"] = _to_port_layout(sub["w"])
            flat[f"{prefix}{key}.bias"] = np.asarray(sub["b"])
        elif "scale" in sub:
            for leaf, name in _BN.items():
                flat[f"{prefix}{key}.{name}"] = np.asarray(sub[leaf])
        else:
            flat.update(_flatten(sub, f"{prefix}{key}."))
    return flat


def teacher_from_numpy(params: dict, *, device=None) -> Teacher:
    """The JAX teacher pytree (numpy leaves) -> the port's `Teacher`, its
    config read off the shapes."""
    stem = np.shape(params["stem"]["w"])
    cfg = TeacherConfig(
        in_channels=int(stem[2]), width=int(stem[3]),
        blocks_per_stage=sum(k.startswith("s0b") for k in params),
        num_classes=int(np.shape(params["head"]["w"])[1]))
    model = Teacher(cfg)
    state = {k: _t(v) for k, v in _flatten(params).items()}
    missing, unexpected = model.load_state_dict(state, strict=False)
    if unexpected or any(not k.endswith("num_batches_tracked")
                         for k in missing):
        raise ValueError(f"teacher params do not match {cfg}: missing "
                         f"{missing}, unexpected {unexpected}")
    return model.to(resolve(device)).eval()


def to_numpy(model: Student | Teacher) -> dict:
    """The port's student or teacher -> the JAX package's params pytree
    (numpy leaves, JAX layouts), e.g. to compare parameters after a step."""
    tree: dict = {}
    for name, x in model.state_dict().items():
        path, leaf = name.rsplit(".", 1)
        if leaf == "num_batches_tracked":
            continue
        node = tree
        for key in path.split("."):
            node = node.setdefault(key, {})
        x = x.detach().cpu().numpy()
        if isinstance(model.get_submodule(path), torch.nn.BatchNorm2d):
            node[{v: k for k, v in _BN.items()}[leaf]] = x
        else:
            if leaf == "weight":
                x = np.transpose(x, (2, 3, 1, 0)) if x.ndim == 4 else x.T
            node[{v: k for k, v in _DENSE.items()}[leaf]] = x
    return tree


def masks_from_numpy(masks: dict, model: Student | Teacher
                     ) -> dict[str, torch.Tensor]:
    """A JAX prune-mask pytree -> the port's masks: bool tensors keyed by
    parameter name, on the model's device (the masks of BatchNorm running
    statistics, which are buffers here, are dropped)."""
    flat = _flatten(masks)
    return {name: torch.from_numpy(np.array(flat[name], dtype=bool)).to(
        p.device) for name, p in model.named_parameters()}


def bank_from_numpy(templates, lower, upper, valid, thresholds, *,
                    device=None) -> TemplateBank:
    """The five `TemplateBank` arrays (numpy) -> a port bank on a device."""
    dev = resolve(device)
    return TemplateBank(
        templates=_t(templates).to(dev), lower=_t(lower).to(dev),
        upper=_t(upper).to(dev),
        valid=torch.from_numpy(np.array(valid, dtype=bool)).to(dev),
        thresholds=_t(thresholds).to(dev))
