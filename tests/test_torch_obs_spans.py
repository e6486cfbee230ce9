"""`repro_torch.obs.span` and where the port places it: a shared null
context with no profiler recording (no `record_function` entered), one
`record_function` range a span under `torch.profiler`, the spans of
`HybridClassifier.predict`, the engine, the kernels' bank re-layout and
the trainer's step nested as the call structure nests them, the step's
gradients freed inside its span, and results bit-identical with the
profiler on and off. On the CPU, no JAX."""
from __future__ import annotations

import contextlib
import json
import weakref

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import match, obs
from repro_torch.core import hybrid, prune
from repro_torch.kernels.acam_match import ops as match_ops
from repro_torch.kernels.acam_similarity import ops as sim_ops
from repro_torch.models import cnn
from repro_torch.optim import optimizers as optim
from repro_torch.serve.spec import ObsSpec
from repro_torch.train import cnn_trainer as T

PREDICT_SPANS = ("repro_torch.predict", "repro_torch.predict.to_device",
                 "repro_torch.predict.frontend", "repro_torch.match.classify",
                 "repro_torch.acam.layout")
TRAIN_SPANS = ("repro_torch.train.to_device", "repro_torch.train.step",
               "repro_torch.train.grad", "repro_torch.train.update")
#: child -> the span it runs inside
PARENT = {"repro_torch.predict.to_device": "repro_torch.predict",
          "repro_torch.predict.frontend": "repro_torch.predict",
          "repro_torch.match.classify": "repro_torch.predict",
          "repro_torch.acam.layout": "repro_torch.match.classify",
          "repro_torch.train.grad": "repro_torch.train.step",
          "repro_torch.train.update": "repro_torch.train.step"}
NARROW = cnn.StudentConfig(filters=(4, 8, 8, 16), num_classes=4)


class Counting:
    """`torch.profiler.record_function` in place, counting its calls."""

    def __init__(self, real):
        self.real, self.calls = real, 0

    def __call__(self, name):
        self.calls += 1
        return self.real(name)


@pytest.fixture()
def counted(monkeypatch):
    c = Counting(torch.profiler.record_function)
    monkeypatch.setattr(torch.profiler, "record_function", c)
    return c


def _images(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (n, 32, 32, 1)).astype(np.float32)


def _classifier(method: str) -> hybrid.HybridClassifier:
    model = cnn.init_student(torch.Generator().manual_seed(0), NARROW,
                             device="cpu")
    y = np.repeat(np.arange(4), 6).astype(np.int32)
    head = hybrid.fit_acam_head(cnn.student_features, model, _images(24, 1),
                                y, 4, k=2, method=method, device="cpu")
    return hybrid.HybridClassifier(model, cnn.student_features, head,
                                   device="cpu")


def _trainer():
    model = cnn.init_student(torch.Generator().manual_seed(2), NARROW,
                             device="cpu")
    params, masks = prune.prune_tree(T.params_of(model), 0.5)
    T.assign(model, params)
    opt = optim.adamw(1e-3, weight_decay=1e-4)
    state = opt.init(T.params_of(model))
    step = T._make_step(T.student_loss(T.TrainConfig(), kd=True), opt, masks)
    rng = np.random.default_rng(3)
    batch = (_images(8, 4), rng.integers(0, 4, 8).astype(np.int32),
             rng.standard_normal((8, 4)).astype(np.float32))
    return model, state, step, batch


def _spans(prof, tmp_path) -> dict:
    """name -> [(start, end)] of the trace's ``repro_torch.`` ranges."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    out: dict = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" \
                and e["name"].startswith("repro_torch."):
            out.setdefault(e["name"], []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    return out


def _inside(child: tuple, parents: list) -> bool:
    return any(a <= child[0] and child[1] <= b for a, b in parents)


def test_span_without_a_profiler_is_one_shared_null_context(counted):
    first = obs.span("repro_torch.predict")
    assert first is obs.span("repro_torch.train.step")
    with first:
        pass
    with obs.FlightRecorder(ObsSpec(profile_annotations=True)).profile_span(
            "acam_fused_dispatch"):
        pass
    assert counted.calls == 0


def test_no_record_function_on_the_paths_without_a_profiler(counted):
    clf = _classifier("feature_count")
    with match.use_backend("kernel"):
        clf.predict(_images(8, 5))
    model, state, step, batch = _trainer()
    step(model, state, T.to_device(batch, "cpu"))
    assert counted.calls == 0


def test_span_under_a_profiler_is_a_record_function_range(counted,
                                                          tmp_path):
    rec = obs.FlightRecorder(ObsSpec(profile_annotations=True))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("repro_torch.predict"):
            pass
        with rec.profile_span("repro_torch.tick"):
            pass
        with obs.FlightRecorder().profile_span("repro_torch.off"):
            pass
    assert counted.calls == 2
    spans = _spans(prof, tmp_path)
    assert set(spans) == {"repro_torch.predict", "repro_torch.tick"}


@pytest.mark.parametrize("method", ["feature_count", "similarity"])
def test_predict_and_step_spans_nest_as_the_calls(method, tmp_path):
    clf = _classifier(method)
    model, state, step, batch = _trainer()
    with match.use_backend("kernel"), \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        clf.predict(_images(8, 5))
        step(model, state, T.to_device(batch, "cpu"))
    spans = _spans(prof, tmp_path)
    assert set(spans) == set(PREDICT_SPANS + TRAIN_SPANS)
    assert all(len(v) == 1 for v in spans.values()), spans
    for child, parent in PARENT.items():
        assert _inside(spans[child][0], spans[parent]), (child, parent)
    # siblings do not overlap; the batch's copy runs before the step
    for a, b in (("repro_torch.predict.to_device",
                  "repro_torch.predict.frontend"),
                 ("repro_torch.predict.frontend",
                  "repro_torch.match.classify"),
                 ("repro_torch.train.to_device", "repro_torch.train.step"),
                 ("repro_torch.train.grad", "repro_torch.train.update")):
        assert spans[a][0][1] <= spans[b][0][0], (a, b)


def test_step_frees_its_gradients_inside_its_span(monkeypatch):
    """The step's clipped gradients are gone before its span closes, so
    the span holds the step's host time whole, their release included."""
    model, state, step, batch = _trainer()
    clip, kept, alive = optim.clip_by_global_norm, [], []

    def clip_and_keep(grads, max_norm):
        out, norm = clip(grads, max_norm)
        kept.extend(weakref.ref(g) for g in out.values())
        return out, norm

    @contextlib.contextmanager
    def span(name):
        yield
        if name == "repro_torch.train.step":
            alive.append(sum(r() is not None for r in kept))

    monkeypatch.setattr(optim, "clip_by_global_norm", clip_and_keep)
    monkeypatch.setattr(obs, "span", span)
    step(model, state, T.to_device(batch, "cpu"))
    assert kept and alive == [0]


def test_reference_backend_runs_no_layout(tmp_path):
    """Below the CPU's cutoff the auto backend takes the reference path:
    the engine's span, and no re-layout."""
    clf = _classifier("feature_count")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        clf.predict(_images(1, 5))
    spans = _spans(prof, tmp_path)
    assert "repro_torch.match.classify" in spans
    assert "repro_torch.acam.layout" not in spans


def _bank(c=3, k=2, n=40, seed=7):
    g = torch.Generator().manual_seed(seed)
    templates = (torch.rand((c, k, n), generator=g) > 0.5).float()
    lower = torch.rand((c, k, n), generator=g) - 0.8
    upper = lower + torch.rand((c, k, n), generator=g)
    valid = torch.ones((c, k), dtype=torch.bool)
    feats = torch.randn((5, n), generator=g)
    return feats, torch.zeros(n), templates, lower, upper, valid


LAYOUT_CALLS = {
    "match.classify_fused": lambda f, t, tm, lo, up, v:
        match_ops.classify_fused(f, t, tm, v),
    "match.classify_fused_margins": lambda f, t, tm, lo, up, v:
        match_ops.classify_fused_margins(f, t, tm, v),
    "match.classify_fused_margins_chunked": lambda f, t, tm, lo, up, v:
        match_ops.classify_fused_margins_chunked(f, t, tm, v, max_rows=4),
    "match.serve_classify": lambda f, t, tm, lo, up, v:
        match_ops.serve_classify(f, t[None], torch.zeros(5, dtype=torch.int32),
                                 tm, v, max_rows=4),
    "similarity.classify_fused": lambda f, t, tm, lo, up, v:
        sim_ops.classify_fused(f, t, lo, up, v),
    "similarity.serve_classify": lambda f, t, tm, lo, up, v:
        sim_ops.serve_classify(f, t[None], torch.zeros(5, dtype=torch.int32),
                               lo, up, v, max_rows=4),
    "similarity.classify_fused_margins": lambda f, t, tm, lo, up, v:
        sim_ops.classify_fused_margins(f, t, lo, up, v, max_rows=4),
}


@pytest.mark.parametrize("name", sorted(LAYOUT_CALLS))
def test_each_per_call_relayout_is_one_layout_span(name, tmp_path):
    args = _bank()
    want = LAYOUT_CALLS[name](*args)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = LAYOUT_CALLS[name](*args)
    spans = _spans(prof, tmp_path)
    assert spans.keys() == {"repro_torch.acam.layout"}
    assert len(spans["repro_torch.acam.layout"]) == 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("method", ["feature_count", "similarity"])
def test_predictions_equal_with_the_profiler_on_and_off(method):
    clf = _classifier(method)
    x = _images(8, 6)
    with match.use_backend("kernel"):
        off = clf.predict(x)
        with profile(activities=[ProfilerActivity.CPU]):
            on = clf.predict(x)
    assert torch.equal(on, off)


def _stepped(profiled: bool):
    model, state, step, batch = _trainer()
    if profiled:
        with profile(activities=[ProfilerActivity.CPU]):
            model, state, loss = step(model, state,
                                      T.to_device(batch, "cpu"))
    else:
        model, state, loss = step(model, state, T.to_device(batch, "cpu"))
    return loss, T.params_of(model), state


def test_step_equal_with_the_profiler_on_and_off():
    loss0, p0, s0 = _stepped(False)
    loss1, p1, s1 = _stepped(True)
    assert torch.equal(loss0, loss1)
    assert torch.equal(s0.step, s1.step)
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k
        assert torch.equal(s0.mu[k], s1.mu[k]), k
        assert torch.equal(s0.nu[k], s1.nu[k]), k
