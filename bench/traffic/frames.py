"""Traffic kind ``frames``: one client classifies batches of frames in a
closed loop through `HybridClassifier.predict`.

Set-up draws the configuration's deployed student, a calibration set
(``calibration_frames_per_class`` frames a class) from which the program
builds its ACAM head (`fit_acam_head`: thresholds, k-means templates), and
a pool of ``pool_batches`` distinct batches of ``batch`` frames, held in
pinned host memory. Every batch is handed to ``predict`` as it lies on the
host, so its copy to the card is part of the call, and the predictions
come back to the host before the next batch is sent.

Parameters: ``batch``, ``pool_batches``, ``noise`` (pixel noise of the
frames), ``trace_batches`` (the traced stretch of a ``--trace 1`` run).

Checks, once the window has closed: the features of each pool batch's last
pass through the program (kept as ``predict`` made them) against the
reference's, in float64 (``feat_err``, `compare.worst_row_gap`); and every
prediction of the window against the reference's (``pred_mismatch``, the
share that differs). The reference builds its own bank from the same
calibration frames.

Besides the ``Driver``: ``flops_per_item``, the operations of one frame
(`mfu`); ``CONTROL`` and ``FAULTS``, what the checks' tests and
`bench/calibrate.py` put in the program's place; ``CPU_TEST``, the sizes
at which the tests run a cell of this kind on the CPU.
"""
from __future__ import annotations

import time

import torch

from bench.harness import compare, data, port, roofline
from bench.reference import acam, student
from bench.reference.precision import F64, TF32


class Tap:
    """The program's ``feature_fn``, keeping the last features it made for
    each pool batch (a reference, no copy)."""

    def __init__(self, fn):
        self.fn, self.slot, self.kept = fn, 0, {}

    def __call__(self, params, x):
        f = self.fn(params, x)
        self.kept[self.slot] = f
        return f


class PortClassifier:
    """The system under test: the port's `HybridClassifier`."""

    def __init__(self, cfg: dict, weights: dict, cal_x, cal_y,
                 device: torch.device):
        from repro_torch.core import hybrid
        from repro_torch.models import cnn

        model = port.module(lambda: cnn.Student(port.student_config(cfg)),
                            weights, device)
        head = hybrid.fit_acam_head(
            cnn.student_features, model, cal_x, cal_y, cfg["num_classes"],
            k=cfg["templates_per_class"],
            threshold_method=cfg["threshold_method"], method=cfg["method"],
            device=device)
        self.tap = Tap(cnn.student_features)
        self.clf = hybrid.HybridClassifier(model, self.tap, head,
                                           device=str(device))

    def predict(self, x: torch.Tensor, slot: int) -> torch.Tensor:
        self.tap.slot = slot
        return self.clf.predict(x)

    def kept(self) -> dict:
        return self.tap.kept


class ControlClassifier:
    """The reference in the program's place, in float32 with TF32
    products: the control that the checks must fail."""

    def __init__(self, cfg: dict, weights: dict, cal_x, cal_y,
                 device: torch.device):
        self.w = weights
        feats = student.features_in_blocks(weights, cal_x, TF32)
        self.bank = acam.build_bank(feats, cal_y, cfg["num_classes"],
                                    cfg["templates_per_class"],
                                    cfg["kmeans_iters"])
        self._kept = {}

    def predict(self, x: torch.Tensor, slot: int) -> torch.Tensor:
        f = student.features_in_blocks(self.w, x, TF32)
        self._kept[slot] = f
        return acam.classify(f, self.bank)

    def kept(self) -> dict:
        return self._kept


class AlteredAnswers(PortClassifier):
    """A fault: one answer in 97 altered where it is produced."""

    def predict(self, x, slot):
        pred = super().predict(x, slot).clone()
        c = self.clf.head.bank.num_classes
        pred[::97] = (pred[::97] + 1) % c
        return pred


#: the reference in the program's place, one precision below the
#: configuration's: the checks must read it not correct
CONTROL = ControlClassifier
#: the program with its timed path broken: the checks must read each not
#: correct
FAULTS = {"altered_answers": AlteredAnswers}
#: a cell of this kind at a size the CPU runs in a second
CPU_TEST = {"config": {"calibration_frames_per_class": 12},
            "traffic": {"batch": 96, "pool_batches": 2, "trace_batches": 2}}


def flops_per_item(cfg: dict) -> int:
    return roofline.student_feature_flops(cfg)


class Driver:
    def __init__(self, cell, seed: int, device: torch.device,
                 system=PortClassifier):
        self.cfg, self.p = cell.config, cell.workload["traffic"]
        self.limits = cell.workload["limits"]
        self.seed, self.dev, self.make_system = seed, device, system
        self.cuda = device.type == "cuda"
        self.marks: list = []  # (set-up phase, host time at its end)

    def setup(self) -> None:
        cfg, p, dev = self.cfg, self.p, self.dev
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        self.weights = data.student_weights(gen, cfg, dev, deployed=True)
        self._mark("weights")
        per, c = cfg["calibration_frames_per_class"], cfg["num_classes"]
        self.cal_y = torch.arange(c, device=dev).repeat_interleave(per)
        self.cal_x = data.frames(gen, self.cal_y, p["noise"])
        nb, b = p["pool_batches"], p["batch"]
        frames = data.frames(gen, data.labels(gen, nb * b, c, dev),
                             p["noise"]).view(nb, b, 32, 32, 1)
        self.pool = torch.empty(frames.shape, dtype=frames.dtype,
                                pin_memory=self.cuda)
        self.pool.copy_(frames)
        del frames
        self._mark("frames")
        self.system = self.make_system(cfg, self.weights, self.cal_x,
                                       self.cal_y, dev)
        self._mark("system")
        self.answers = []  # (pool batch, predictions on the host)
        for slot in range(nb):  # every shape and pool batch once
            self.system.predict(self.pool[slot], slot).cpu()
        self._mark("warm_up")

    def _mark(self, name: str) -> None:
        self._sync()
        self.marks.append((name, time.perf_counter()))

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.dev)

    def _batch(self, slot: int) -> float:
        h0 = time.perf_counter()
        pred = self.system.predict(self.pool[slot], slot)
        h1 = time.perf_counter()
        self.answers.append((slot, pred.cpu()))
        return h1 - h0

    def window(self, seconds: float) -> dict:
        nb, b = self.p["pool_batches"], self.p["batch"]
        marks, host_ms, call_s, i = [], [], 0.0, 0
        t0 = time.perf_counter()
        while True:
            if self.cuda:
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
            s0 = time.perf_counter()
            call_s += self._batch(i % nb)
            if self.cuda:
                e1.record()
                marks.append((e0, e1))
            else:
                host_ms.append((time.perf_counter() - s0) * 1e3)
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        t1 = time.perf_counter()
        self._sync()
        lat = [a.elapsed_time(z) for a, z in marks] if self.cuda else host_ms
        lat.sort()
        return {"attempted": i, "failed": 0,
                "end_to_end": {"classify_per_s": i * b / (t1 - t0),
                               "classify_p95_ms": percentile(lat, 95)},
                "host": {"call_s": call_s, "calls": i}}

    def traced_run(self):
        """The traced stretch: ``trace_batches`` batches, each in spans."""
        from torch.profiler import record_function

        n, nb = self.p["trace_batches"], self.p["pool_batches"]

        def run():
            for i in range(n):
                slot = i % nb
                with record_function("bench.predict"):
                    pred = self.system.predict(self.pool[slot], slot)
                with record_function("bench.to_host"):
                    self.answers.append((slot, pred.cpu()))

        return run, {"steps": n, "items": n * self.p["batch"]}

    def check(self) -> dict:
        cfg, dev = self.cfg, self.dev
        kept = self.system.kept()
        self.system = None  # the program's state goes before the reference
        if self.cuda:
            torch.cuda.empty_cache()
        bank = acam.build_bank(
            student.features_in_blocks(self.weights, self.cal_x, F64),
            self.cal_y, cfg["num_classes"], cfg["templates_per_class"],
            cfg["kmeans_iters"])
        by_slot: dict[int, list] = {}
        for slot, pred in self.answers:
            by_slot.setdefault(slot, []).append(pred)
        feat_err, wrong, total = 0.0, 0, 0
        for slot, preds in sorted(by_slot.items()):
            want = student.features_in_blocks(self.weights, self.pool[slot],
                                              F64)
            ref = acam.classify(want, bank).cpu()
            for pred in preds:
                wrong += int((pred.long() != ref).sum())
                total += ref.numel()
            if slot in kept:
                feat_err = max(feat_err, compare.worst_row_gap(
                    kept[slot].to(dev), want))
        return {"feat_err": (feat_err, self.limits["feat_err"]),
                "pred_mismatch": (wrong / total,
                                  self.limits["pred_mismatch"])}


def percentile(sorted_values: list, q: float) -> float:
    """The ``q``-th percentile of ascending values, interpolated linearly
    between the two nearest ranks."""
    at = (len(sorted_values) - 1) * q / 100
    lo = int(at)
    hi = min(lo + 1, len(sorted_values) - 1)
    return sorted_values[lo] + (sorted_values[hi] - sorted_values[lo]) * (
        at - lo)
