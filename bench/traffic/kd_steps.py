"""Traffic kind ``kd_steps``: the pruned student's distillation step,
driven step after step as the trainer's fine-tuning phase drives it.

Set-up draws the student and the ResNet teacher at their training start,
and a pool of ``pool_batches`` distinct batches of ``batch`` labelled
frames; the program's teacher (`cnn.teacher_logits`) gives each its logits.
The pool is held as numpy batches on the host, which the step takes through
`cnn_trainer.to_device`, as `train_student`'s epochs do. The program prunes
the student to the configuration's final sparsity (`prune.prune_tree`),
builds AdamW and the step (`cnn_trainer._make_step` of the KD loss, with
the masks), and runs its first three steps on pool batches 0, 1 and 2; the
window goes on with the same model and optimizer state.

Parameters: ``batch``, ``pool_batches``, ``noise``, ``trace_steps``.

Checks, against the reference's three steps from the same drawn weights
and batches, in float64: the first step's loss (``loss_gap``); the first
gradient as AdamW received it, read back from its first moment after one
step (``grad_gap`` over the median leaf, ``grad_gap_worst_leaf`` over the
worst); and the parameters' change over the three steps, taken before the
fourth step moves them (``update_gap``, the median leaf). Once the window
has closed, the same step runs once more on the next pool batch, from the
model and AdamW state the window left, and the reference takes one float64
step from that state: that step's loss (``loss_gap_after_window``), its
gradient as AdamW received it, read back from the two first moments
(``grad_gap_after_window``, the median leaf, and ``..._worst_leaf``) and
its change (``update_gap_after_window``, the median leaf, and
``..._worst_leaf``). The gradients and the changes are held leaf by leaf
(`compare.leaf_gaps`); a change leaves out the leaves whose reference
gradient is under a thousandth of the median leaf's. The later set-up
steps' losses and the three steps' worst-leaf change swing from seed to
seed with the few elements of the first layer's small leaves whose
gradient sits near AdamW's epsilon: they are kept as notes beside the
checks.

Besides the ``Driver``: ``flops_per_item``, the operations of one image's
step (`mfu`); ``CONTROL`` and ``FAULTS``, what the checks' tests and
`bench/calibrate.py` put in the program's place; ``CPU_TEST``, the sizes
at which the tests run a cell of this kind on the CPU.
"""
from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from bench.harness import compare, data, port, roofline
from bench.reference.precision import F64, TF32
from bench.reference.train import KDTrainer

#: the number of steps the checks follow
CHECKED_STEPS = 3


def trainer_settings(cfg: dict) -> dict:
    return {k: cfg[k] for k in ("lr", "weight_decay", "b1", "b2", "eps",
                                "clip", "alpha", "temperature", "sparsity")}


class PortTrainer:
    """The system under test: the port's student, pruned, its AdamW state
    and its KD step."""

    def __init__(self, cfg: dict, sw: dict, tw: dict, device: torch.device):
        from repro_torch.core import prune
        from repro_torch.models import cnn
        from repro_torch.optim import optimizers as optim
        from repro_torch.train import cnn_trainer as T

        self.T, self.dev = T, device
        self.model = port.module(
            lambda: cnn.Student(port.student_config(cfg)), sw, device)
        self.teacher = port.module(
            lambda: cnn.Teacher(port.teacher_config(cfg)), tw, device)
        self.cnn = cnn
        tc = T.TrainConfig(lr=cfg["lr"], weight_decay=cfg["weight_decay"],
                           distill_alpha=cfg["alpha"],
                           distill_temperature=cfg["temperature"],
                           prune_final_sparsity=cfg["sparsity"])
        final = prune.polynomial_sparsity(
            tc.prune_epochs, tc.prune_epochs, tc.prune_start_sparsity,
            tc.prune_final_sparsity)
        self.params0, masks = prune.prune_tree(T.params_of(self.model),
                                               final)
        T.assign(self.model, self.params0)
        opt = optim.adamw(tc.lr, b1=cfg["b1"], b2=cfg["b2"], eps=cfg["eps"],
                          weight_decay=tc.weight_decay)
        self.state = opt.init(T.params_of(self.model))
        self.b1 = cfg["b1"]
        self._step = T._make_step(T.student_loss(tc, kd=True), opt, masks)

    def teacher_logits(self, x: torch.Tensor) -> torch.Tensor:
        return self.cnn.teacher_logits(self.teacher, x)

    def step(self, batch) -> torch.Tensor:
        self.model, self.state, loss = self._step(
            self.model, self.state, self.T.to_device(batch, self.dev))
        return loss

    def optimizer_gradient(self) -> dict:
        return {k: m / (1 - self.b1) for k, m in self.state.mu.items()}

    def parameters(self) -> dict:
        return {k: p.detach().clone()
                for k, p in self.model.named_parameters()}

    def snapshot(self) -> dict:
        """The model and AdamW state as they stand, copied."""
        return {"params": self.parameters(),
                "mu": {k: m.clone() for k, m in self.state.mu.items()},
                "nu": {k: v.clone() for k, v in self.state.nu.items()},
                "t": int(self.state.step)}


class ControlTrainer:
    """The reference in the program's place, in float32 with TF32
    products: the control that the checks must fail."""

    def __init__(self, cfg: dict, sw: dict, tw: dict, device: torch.device):
        self.ref = KDTrainer(sw, tw, trainer_settings(cfg), TF32, device)
        self.params0, self.dev = self.ref.params0, device

    def teacher_logits(self, x: torch.Tensor) -> torch.Tensor:
        return self.ref.teacher_logits(x)

    def step(self, batch) -> torch.Tensor:
        x, y, _ = batch
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


class UnchangedState(PortTrainer):
    """A fault: the step computes its loss and returns the model and
    optimizer state it was given."""

    def step(self, batch):
        keep = {k: p.detach().clone()
                for k, p in self.model.named_parameters()}
        state = self.state
        loss = super().step(batch)
        self.T.assign(self.model, keep)
        self.state = state
        return loss


class HalfBatch(PortTrainer):
    """A fault: the second half of each batch left out, the loss the mean
    over the first."""

    def step(self, batch):
        return super().step(tuple(a[:len(a) // 2] for a in batch))


class LateHalfBatch(PortTrainer):
    """A fault that only the step after the window can show: the steps
    that set-up checks are sound, every later one leaves out the second
    half of its batch."""

    calls = 0

    def step(self, batch):
        self.calls += 1
        if self.calls > CHECKED_STEPS:
            batch = tuple(a[:len(a) // 2] for a in batch)
        return super().step(batch)


#: the reference in the program's place, one precision below the
#: configuration's: the checks must read it not correct
CONTROL = ControlTrainer
#: the program with its timed path broken: the checks must read each not
#: correct
FAULTS = {"unchanged_state": UnchangedState, "half_batch": HalfBatch,
          "late_half_batch": LateHalfBatch}
#: a cell of this kind at a size the CPU runs in a second
CPU_TEST = {"config": {},
            "traffic": {"batch": 24, "pool_batches": 4, "trace_steps": 2}}


def flops_per_item(cfg: dict) -> int:
    return roofline.student_step_flops(cfg)


class Driver:
    def __init__(self, cell, seed: int, device: torch.device,
                 system=PortTrainer):
        self.cfg, self.p = cell.config, cell.workload["traffic"]
        self.limits = cell.workload["limits"]
        self.seed, self.dev, self.make_system = seed, device, system
        self.cuda = device.type == "cuda"
        self.marks: list = []  # (set-up phase, host time at its end)

    def setup(self) -> None:
        cfg, p, dev = self.cfg, self.p, self.dev
        if self.cuda:
            from repro_torch.train import cnn_trainer

            cnn_trainer.deterministic_cublas()  # before the first cuBLAS call
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        self.sw = data.student_weights(gen, cfg, dev, deployed=False)
        self.tw = data.teacher_weights(gen, cfg, dev)
        self._mark("weights")
        nb, b = p["pool_batches"], p["batch"]
        y = data.labels(gen, nb * b, cfg["num_classes"], dev)
        x = data.frames(gen, y, p["noise"])
        self._mark("frames")
        self.system = self.make_system(cfg, self.sw, self.tw, dev)
        self._mark("system")
        zt = torch.cat([self.system.teacher_logits(x[i:i + b])
                        for i in range(0, nb * b, b)])
        x, y, zt = (t.cpu().numpy() for t in (x, y, zt))
        self.pool = [(x[i:i + b], y[i:i + b].astype(np.int32), zt[i:i + b])
                     for i in range(0, nb * b, b)]
        self._mark("teacher_logits")
        self.losses = []
        for i in range(CHECKED_STEPS):
            self.losses.append(self.system.step(self.pool[i]))
            if i == 0:
                self.first_grad = self.system.optimizer_gradient()
        self.params3 = self.system.parameters()
        self.done = CHECKED_STEPS
        self._mark("first_steps")

    def _mark(self, name: str) -> None:
        self._sync()
        self.marks.append((name, time.perf_counter()))

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.dev)

    def window(self, seconds: float) -> dict:
        nb, b = self.p["pool_batches"], self.p["batch"]
        losses, call_s, n = [], 0.0, 0
        t0 = time.perf_counter()
        while True:
            h0 = time.perf_counter()
            losses.append(self.system.step(self.pool[self.done % nb]))
            call_s += time.perf_counter() - h0
            self.done += 1
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self._sync()
        t1 = time.perf_counter()
        failed = int((~torch.isfinite(torch.stack(losses))).sum())
        return {"attempted": n, "failed": failed,
                "end_to_end": {"train_images_per_s": n * b / (t1 - t0)},
                "host": {"call_s": call_s, "calls": n}}

    def traced_run(self):
        from torch.profiler import record_function

        n, nb = self.p["trace_steps"], self.p["pool_batches"]

        def run():
            for _ in range(n):
                with record_function("bench.step"):
                    self.system.step(self.pool[self.done % nb])
                self.done += 1

        return run, {"steps": n, "items": n * self.p["batch"]}

    def check(self) -> dict:
        got_loss = [float(v) for v in self.losses]
        got_grad, got_p3 = self.first_grad, self.params3
        got_p0 = self.system.params0
        # the window's own step once more, from the state the window left
        batch = self.pool[self.done % self.p["pool_batches"]]
        before = self.system.snapshot()
        got_last = float(self.system.step(batch))
        after = self.system.snapshot()
        self.system = None  # the program's state goes before the reference
        if self.cuda:
            torch.cuda.empty_cache()
        settings = trainer_settings(self.cfg)
        ref = KDTrainer(self.sw, self.tw, settings, F64, self.dev)
        want_loss = [float(ref.step(*self._tensors(b)))
                     for b in self.pool[:CHECKED_STEPS]]
        g_gaps, _ = self._leaf_gaps(got_grad, ref.first_grad)
        change = {k: got_p3[k].double() - got_p0[k].double()
                  for k in got_p3}
        want_change = {k: ref.params[k] - ref.params0[k] for k in ref.params}
        _, u_gaps = self._leaf_gaps(change, want_change, ref.first_grad)
        del ref
        last = KDTrainer(self.sw, self.tw, settings, F64, self.dev)
        last.load(before["params"], before["mu"], before["nu"], before["t"])
        want_last = float(last.step(*self._tensors(batch)))
        b1 = self.cfg["b1"]
        last_grad = {k: (after["mu"][k].double()
                         - b1 * before["mu"][k].double()) / (1 - b1)
                     for k in after["mu"]}
        last_change = {k: after["params"][k].double()
                       - before["params"][k].double() for k in last.params}
        want_last_change = {k: last.params[k]
                            - before["params"][k].to(last.params[k])
                            for k in last.params}
        lg_gaps, _ = self._leaf_gaps(last_grad, last.grad)
        _, lu_gaps = self._leaf_gaps(last_change, want_last_change,
                                     last.grad)
        self.notes = {
            "grad_worst_leaf": max(g_gaps, key=g_gaps.get),
            "update_gap_worst_leaf": max(u_gaps.values()),
            "update_worst_leaf": max(u_gaps, key=u_gaps.get),
            **{f"loss_gap_step{i + 1}": compare.relative_gap(g, w)
               for i, (g, w) in enumerate(zip(got_loss, want_loss))},
            "steps_before_check": before["t"]}
        numbers = {
            "loss_gap": self.notes["loss_gap_step1"],
            "grad_gap": statistics.median(g_gaps.values()),
            "grad_gap_worst_leaf": max(g_gaps.values()),
            "update_gap": statistics.median(u_gaps.values()),
            "loss_gap_after_window": compare.relative_gap(got_last,
                                                          want_last),
            "grad_gap_after_window": statistics.median(lg_gaps.values()),
            "grad_gap_after_window_worst_leaf": max(lg_gaps.values()),
            "update_gap_after_window": statistics.median(lu_gaps.values()),
            "update_gap_after_window_worst_leaf": max(lu_gaps.values())}
        return {k: (v, self.limits[k]) for k, v in numbers.items()}

    def _tensors(self, batch):
        x, y, _ = batch
        return (torch.as_tensor(x, device=self.dev),
                torch.as_tensor(y, device=self.dev).long())

    @staticmethod
    def _leaf_gaps(got: dict, want: dict, want_grad: dict | None = None):
        """Each leaf's gap (`compare.leaf_gaps`) by name, and the same over
        the leaves whose ``want_grad`` is at least a thousandth of the
        median leaf's (all leaves without ``want_grad``)."""
        gaps = dict(zip(want, compare.leaf_gaps(got, want)))
        if want_grad is None:
            return gaps, gaps
        norms = {k: float(torch.linalg.vector_norm(g))
                 for k, g in want_grad.items()}
        floor = 1e-3 * statistics.median(norms.values())
        moved = [k for k, v in norms.items() if v >= floor]
        return gaps, dict(zip(moved, compare.leaf_gaps(got, want, moved)))
