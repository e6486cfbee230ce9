"""Traffic kind ``teacher_steps``: the ResNet teacher's training step
(the trainer's ``train_teacher``: `cnn_trainer._make_step` of
`teacher_loss` with AdamW), driven step after step.

Set-up draws the teacher at its training start and a pool of
``pool_batches`` distinct batches of ``batch`` labelled frames, held as
numpy batches on the host, which the step takes through
`cnn_trainer.to_device`; the program builds AdamW and the step and runs
its first three steps on pool batches 0, 1 and 2; the window goes on with
the same model and optimizer state.

Parameters: ``batch``, ``pool_batches``, ``noise``, ``trace_steps``.

Checks: those of ``kd_steps`` (the first step's loss, the first gradient
as AdamW received it, the change over three steps, and the step after the
window from the state the window left), against float64 steps of
`bench.reference.teacher.TeacherTrainer`: ``kd_steps``' driver is loaded
here as a private copy whose reference trainer is the teacher's.

Besides the ``Driver``: ``flops_per_item``, the operations of one image's
step (`mfu`); ``CONTROL`` and ``FAULTS``; ``CPU_TEST``.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from bench.harness import cells, data, port
from bench.reference.precision import TF32
from bench.reference.teacher import TeacherTrainer

_KD = cells.load_module("traffic", "kd_steps",
                        Path(__file__).resolve().parents[2])


def reference_trainer(student_w, teacher_w, opt, prec, device):
    """`TeacherTrainer` in the argument order of ``kd_steps``' reference."""
    return TeacherTrainer(teacher_w, opt, prec, device)


_KD.KDTrainer = reference_trainer  # this copy's checks step the teacher


class PortTeacher(_KD.PortTrainer):
    """The system under test: the port's teacher, AdamW and the step
    `train_teacher` builds."""

    def __init__(self, cfg: dict, tw: dict, device: torch.device):
        from repro_torch.models import cnn
        from repro_torch.optim import optimizers as optim
        from repro_torch.train import cnn_trainer as T

        self.T, self.dev, self.b1 = T, device, cfg["b1"]
        self.model = port.module(
            lambda: cnn.Teacher(port.teacher_config(cfg)), tw, device)
        self.params0 = {k: p.clone()
                        for k, p in T.params_of(self.model).items()}
        opt = optim.adamw(cfg["lr"], b1=cfg["b1"], b2=cfg["b2"],
                          eps=cfg["eps"], weight_decay=cfg["weight_decay"])
        self.state = opt.init(T.params_of(self.model))
        self._step = T._make_step(T.teacher_loss, opt)


class ControlTeacher:
    """The reference in the program's place, in float32 with TF32
    products: the control that the checks must fail."""

    def __init__(self, cfg: dict, tw: dict, device: torch.device):
        self.ref = TeacherTrainer(tw, _KD.trainer_settings(cfg), TF32,
                                  device)
        self.params0, self.dev = self.ref.params0, device

    def step(self, batch) -> torch.Tensor:
        x, y = batch
        return self.ref.step(torch.as_tensor(x, device=self.dev),
                             torch.as_tensor(y, device=self.dev).long())

    def optimizer_gradient(self) -> dict:
        return self.ref.first_grad

    def parameters(self) -> dict:
        return dict(self.ref.params)

    def snapshot(self) -> dict:
        r = self.ref
        return {"params": dict(r.params), "mu": dict(r.mu),
                "nu": dict(r.nu), "t": r.t}


class UnchangedState(_KD.UnchangedState, PortTeacher):
    """A fault: the step returns the model and state it was given."""


class HalfBatch(_KD.HalfBatch, PortTeacher):
    """A fault: the second half of each batch left out."""


class LateHalfBatch(_KD.LateHalfBatch, PortTeacher):
    """A fault only the step after the window shows."""


CONTROL = ControlTeacher
FAULTS = {"unchanged_state": UnchangedState, "half_batch": HalfBatch,
          "late_half_batch": LateHalfBatch}
CPU_TEST = {"config": {},
            "traffic": {"batch": 24, "pool_batches": 4, "trace_steps": 2}}


def flops_per_item(cfg: dict) -> int:
    """Operations of one image's step: the forward's multiply-accumulates
    (``teacher_macs``, the head included), the weight gradient of each,
    and the input gradient of each but the stem's, 2 a MAC."""
    stem = (cfg["image_size"] ** 2 * cfg["kernel_size"] ** 2
            * cfg["in_channels"] * cfg["teacher_width"])
    return 2 * (3 * cfg["teacher_macs"] - stem)


class Driver(_KD.Driver):
    def __init__(self, cell, seed: int, device: torch.device,
                 system=PortTeacher):
        super().__init__(cell, seed, device, system)

    def setup(self) -> None:
        cfg, p, dev = self.cfg, self.p, self.dev
        if self.cuda:
            from repro_torch.train import cnn_trainer

            cnn_trainer.deterministic_cublas()  # before the first cuBLAS call
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        self.sw, self.tw = None, data.teacher_weights(gen, cfg, dev)
        self._mark("weights")
        nb, b = p["pool_batches"], p["batch"]
        y = data.labels(gen, nb * b, cfg["num_classes"], dev)
        x = data.frames(gen, y, p["noise"])
        x, y = x.cpu().numpy(), y.cpu().numpy()
        self.pool = [(x[i:i + b], y[i:i + b].astype(np.int32))
                     for i in range(0, nb * b, b)]
        self._mark("frames")
        self.system = self.make_system(cfg, self.tw, dev)
        self._mark("system")
        self.losses = []
        for i in range(_KD.CHECKED_STEPS):
            self.losses.append(self.system.step(self.pool[i]))
            if i == 0:
                self.first_grad = self.system.optimizer_gradient()
        self.params3 = self.system.parameters()
        self.done = _KD.CHECKED_STEPS
        self._mark("first_steps")

    def _tensors(self, batch):
        x, y = batch
        return (torch.as_tensor(x, device=self.dev),
                torch.as_tensor(y, device=self.dev).long())
