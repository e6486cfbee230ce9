"""Trainer for the paper's CNN pipeline: baseline CE, KD (+curriculum),
iterative pruning, and QAT — composable stages matching paper §II.

The paper-scale trainer (one device, small models), a port of the JAX
package's `repro/train/cnn_trainer.py`. A step does what the JAX step does,
in the same order: gradients -> prune masks -> clip at global norm 1.0 ->
AdamW -> re-apply masks. The BatchNorm running statistics of the batch are
folded in by the train-mode forward itself (`repro_torch.models.cnn`), which
the JAX step does last; nothing in between reads them. On the card the
forward and the backward run inside one `cnn.fp32` (`value_and_grad`):
TF32 off for the backward convolutions too, which cuDNN's default would
round to TF32 once a forward-only context had exited. Every gradient is taken
under PyTorch's deterministic algorithms (`deterministic`), so training is a
function of its seed on the card as on the CPU; on the card that needs
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` (or ``:16:8``) in the environment before
the process's first cuBLAS call.

The loss is the plain `core.distill` (differentiable), as in the JAX
trainer; the fused B8 kernel (`kernels.kd_loss`) has no backward.
"""
from __future__ import annotations

import contextlib
import os
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch import nn

from repro_torch.core import distill, prune
from repro_torch.data import pipeline
from repro_torch.device import resolve
from repro_torch.models import cnn
from repro_torch.optim import optimizers as optim

LossFn = Callable[..., torch.Tensor]


class TrainConfig(NamedTuple):
    epochs: int = 5
    batch_size: int = 128
    lr: float = 1e-3
    weight_decay: float = 1e-4
    # distillation
    distill_alpha: float = 0.5
    distill_temperature: float = 4.0
    curriculum: bool = True
    curriculum_start_frac: float = 0.4
    # pruning
    prune_start_sparsity: float = 0.50
    prune_final_sparsity: float = 0.80
    prune_epochs: int = 3  # pruning ramp epochs (then final fine-tune)
    finetune_epochs: int = 2
    # quantisation
    qat: bool = False
    seed: int = 0


def params_of(model: nn.Module) -> dict[str, torch.Tensor]:
    """The model's parameters by name, detached."""
    return {k: p.detach() for k, p in model.named_parameters()}


def assign(model: nn.Module, params: dict[str, torch.Tensor]) -> None:
    """Copy ``params`` into the model's parameters in place."""
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(params[k])


#: the cuBLAS workspace settings under which its products are deterministic
DETERMINISTIC_CUBLAS = (":4096:8", ":16:8")


def deterministic_cublas() -> None:
    """Set ``CUBLAS_WORKSPACE_CONFIG`` for `deterministic` unless the
    environment already sets it: entry points that train on the card call
    this first, before any cuBLAS handle exists."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", DETERMINISTIC_CUBLAS[0])


@contextlib.contextmanager
def deterministic(device: torch.device):
    """PyTorch's deterministic algorithms for everything run inside (an op
    with none raises, naming itself). cuBLAS reads its workspace setting
    when its first handle is made, so a missing one raises here rather than
    train differently from run to run."""
    if (device.type == "cuda" and os.environ.get("CUBLAS_WORKSPACE_CONFIG")
            not in DETERMINISTIC_CUBLAS):
        raise RuntimeError(
            "training on the card is deterministic only with "
            "CUBLAS_WORKSPACE_CONFIG=:4096:8 (or :16:8) set in the "
            "environment before the process's first cuBLAS call")
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])


def value_and_grad(loss_fn: LossFn, model: nn.Module, batch
                   ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """``loss_fn(model, *batch)`` and its gradient for every parameter,
    forward and backward in full float32 and deterministic on the card."""
    names, params = zip(*model.named_parameters())
    device = params[0].device
    with torch.enable_grad(), cnn.fp32(device), deterministic(device):
        loss = loss_fn(model, *batch)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
    return loss.detach(), {
        k: torch.zeros_like(p) if g is None else g
        for k, p, g in zip(names, params, grads)}


def _make_step(loss_fn: LossFn, optimizer: optim.Optimizer, masks=None):
    def step(model, opt_state, batch):
        loss, grads = value_and_grad(loss_fn, model, batch)
        if masks is not None:
            grads = prune.mask_gradients(grads, masks)
        grads, _ = optim.clip_by_global_norm(grads, 1.0)
        params, opt_state = optimizer.update(grads, opt_state,
                                             params_of(model))
        if masks is not None:
            params = prune.apply_masks(params, masks)
        assign(model, params)
        return model, opt_state, loss

    return step


def to_device(batch, device: torch.device) -> tuple[torch.Tensor, ...]:
    """A numpy batch (images, labels[, teacher logits]) -> tensors on
    ``device``: images and logits f32, labels int64."""
    x, y, *rest = batch
    out = [torch.as_tensor(x, dtype=torch.float32, device=device),
           torch.as_tensor(np.asarray(y), device=device).long()]
    out += [torch.as_tensor(z, dtype=torch.float32, device=device)
            for z in rest]
    return tuple(out)


def teacher_loss(model: cnn.Teacher, x, y) -> torch.Tensor:
    return distill.cross_entropy(model(x, train=True), y)


def student_loss(cfg: TrainConfig, *, kd: bool) -> LossFn:
    """The student's loss: Eq. 1 against teacher logits (``kd``) or CE,
    in train mode, through int8 fake-quant when ``cfg.qat``."""
    if kd:
        def loss_fn(model, x, y, zt):
            logits = model(x, train=True, quantize=cfg.qat)
            return distill.distillation_loss(
                logits, zt, y, alpha=cfg.distill_alpha,
                temperature=cfg.distill_temperature)
    else:
        def loss_fn(model, x, y):
            return distill.cross_entropy(
                model(x, train=True, quantize=cfg.qat), y)
    return loss_fn


def train_teacher(images: np.ndarray, labels: np.ndarray,
                  cfg: cnn.TeacherConfig, *, epochs: int = 5,
                  batch_size: int = 128, lr: float = 1e-3, seed: int = 0,
                  device=None, losses: list | None = None) -> cnn.Teacher:
    """Train the teacher with CE on ``device`` (the card unless the caller
    asks for the CPU). ``losses``, if given, receives each step's loss (a
    device scalar)."""
    dev = resolve(device)
    model = cnn.init_teacher(torch.Generator().manual_seed(seed), cfg,
                             device=dev)
    opt = optim.adamw(lr, weight_decay=1e-4)
    opt_state = opt.init(params_of(model))
    step = _make_step(teacher_loss, opt)
    for epoch in range(epochs):
        for batch in pipeline.batches(images, labels, batch_size, seed=seed,
                                      epoch=epoch):
            model, opt_state, loss = step(model, opt_state,
                                          to_device(batch, dev))
            if losses is not None:
                losses.append(loss)
    return model


def _predictions(logits_fn, params, images, batch_size: int) -> np.ndarray:
    preds = []
    for i in range(0, len(images), batch_size):
        logits = logits_fn(params, images[i:i + batch_size])
        preds.append(logits.argmax(dim=-1).cpu().numpy())
    return np.concatenate(preds) if preds else np.zeros(0, np.int64)


def evaluate(logits_fn, params, images, labels, *, batch_size: int = 512
             ) -> float:
    """Accuracy; ``logits_fn(params, images)`` returns the logits tensor
    (e.g. `cnn.student_logits`)."""
    pred = _predictions(logits_fn, params, images, batch_size)
    return float((pred == np.asarray(labels)).sum()) / len(labels)


def metrics(logits_fn, params, images, labels, num_classes: int = 10, *,
            batch_size: int = 512) -> dict[str, float]:
    """Accuracy / macro F1 / precision / recall (Table I columns)."""
    pred = _predictions(logits_fn, params, images, batch_size)
    y = np.asarray(labels)
    acc = float((pred == y).mean())
    precs, recs, f1s = [], [], []
    for c in range(num_classes):
        tp = float(((pred == c) & (y == c)).sum())
        fp = float(((pred == c) & (y != c)).sum())
        fn_ = float(((pred != c) & (y == c)).sum())
        p_ = tp / (tp + fp) if tp + fp else 0.0
        r_ = tp / (tp + fn_) if tp + fn_ else 0.0
        precs.append(p_)
        recs.append(r_)
        f1s.append(2 * p_ * r_ / (p_ + r_) if p_ + r_ else 0.0)
    return {"accuracy": acc, "f1": float(np.mean(f1s)),
            "precision": float(np.mean(precs)),
            "recall": float(np.mean(recs))}


def train_student(
    images: np.ndarray, labels: np.ndarray, *,
    student_cfg: cnn.StudentConfig = cnn.StudentConfig(),
    teacher_logits_all: np.ndarray | None = None,
    cfg: TrainConfig = TrainConfig(), do_prune: bool = False,
    device=None, losses: list | None = None,
) -> tuple[cnn.Student, dict[str, torch.Tensor] | None]:
    """Train the student on ``device`` (the card unless the caller asks
    for the CPU); returns (model, masks|None).

    teacher_logits_all: precomputed teacher logits for the full train set
    (enables KD + curriculum without holding the teacher in memory).
    ``losses``, if given, receives each step's loss (a device scalar).
    """
    dev = resolve(device)
    model = cnn.init_student(torch.Generator().manual_seed(cfg.seed),
                             student_cfg, device=dev)
    opt = optim.adamw(cfg.lr, weight_decay=cfg.weight_decay)
    opt_state = opt.init(params_of(model))
    use_kd = teacher_logits_all is not None
    loss_fn = student_loss(cfg, kd=use_kd)

    # curriculum ordering (Eq. 4) from teacher logits
    order = None
    if use_kd and cfg.curriculum:
        order = distill.curriculum_order(
            torch.as_tensor(np.asarray(teacher_logits_all)),
            torch.as_tensor(np.asarray(labels))).numpy()
    pacing = distill.CurriculumSchedule(cfg.curriculum_start_frac,
                                        max(cfg.epochs - 1, 1))
    n = len(labels)
    zt_all = np.asarray(teacher_logits_all) if use_kd else None
    idx_order = order if order is not None else np.arange(n)

    def epoch_batches(epoch):
        if not use_kd:
            yield from pipeline.batches(images, labels, cfg.batch_size,
                                        seed=cfg.seed, epoch=epoch)
            return
        # teacher logits must stay index-aligned per batch, so the KD loop
        # iterates indices directly (also what curriculum pacing needs)
        limit = pacing.available(epoch, n) if cfg.curriculum else n
        rng = np.random.RandomState((cfg.seed * 9973 + epoch) & 0x7FFFFFFF)
        perm = rng.permutation(idx_order[:limit])
        stop = (len(perm) // cfg.batch_size) * cfg.batch_size
        for i in range(0, stop, cfg.batch_size):
            sel = perm[i:i + cfg.batch_size]
            yield images[sel], labels[sel], zt_all[sel]

    def run_epochs(n_epochs, model, opt_state, masks, epoch0=0):
        stp = _make_step(loss_fn, opt, masks)
        for e in range(n_epochs):
            for batch in epoch_batches(epoch0 + e):
                model, opt_state, loss = stp(model, opt_state,
                                             to_device(batch, dev))
                if losses is not None:
                    losses.append(loss)
        return model, opt_state

    masks = None
    model, opt_state = run_epochs(cfg.epochs, model, opt_state, None)
    if do_prune:
        for t in range(cfg.prune_epochs):
            s_t = float(prune.polynomial_sparsity(
                t + 1, cfg.prune_epochs, cfg.prune_start_sparsity,
                cfg.prune_final_sparsity))
            pruned, masks = prune.prune_tree(params_of(model), s_t)
            assign(model, pruned)
            model, opt_state = run_epochs(1, model, opt_state, masks,
                                          epoch0=cfg.epochs + t)
        model, opt_state = run_epochs(cfg.finetune_epochs, model, opt_state,
                                      masks,
                                      epoch0=cfg.epochs + cfg.prune_epochs)
    return model, masks
