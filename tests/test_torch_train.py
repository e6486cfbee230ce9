"""The port's training path (§II: KD + curriculum, pruning, QAT) against the
JAX package's, on the CPU at narrow widths.

Inputs come from numpy seeds and weights from the JAX package's own init,
carried across with `repro_torch.convert`. Tolerances: the losses, logits
and BatchNorm statistics within rtol 1e-5 (f32 convolutions sum in another
order); one optimiser or trainer step's parameters within atol 1e-6 (the
step moves a weight by at most lr = 1e-3); prune masks, the curriculum
order, Eq. 5 and the data pipeline exactly.

Where BatchNorm runs on batch statistics (the student's train mode, a
trainer step), the reference is the JAX function run in float64
(`jax.enable_x64`; its optimiser keeps f32 moments either way): on the CPU,
JAX's f32 `jnp.var` over the thousands of values of a channel sums less
accurately than torch's, small batch variances amplify that through the
normalisation, and Adam's first step, u = g / (|g| + eps), can turn it
into more than the 1e-6 tolerance on a weight. The port in f32 meets the
tolerances against the float64 reference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import t, to_np
from repro.core import distill as jdistill
from repro.core import prune as jprune
from repro.core import quant as jquant
from repro.data import pipeline as jpipeline
from repro.data import synthetic as jsynthetic
from repro.models import cnn as jcnn
from repro.optim import optimizers as joptim
from repro.train import cnn_trainer as jtrainer
from repro_torch import convert
from repro_torch.core import distill as tdistill
from repro_torch.core import prune as tprune
from repro_torch.core import quant as tquant
from repro_torch.data import pipeline as tpipeline
from repro_torch.data import synthetic as tsynthetic
from repro_torch.models import cnn as tcnn
from repro_torch.optim import optimizers as toptim
from repro_torch.train import cnn_trainer as ttrainer

NARROW = dict(filters=(4, 8, 8, 16))  # 784 features, as at paper width
TEACHER = dict(in_channels=1, width=4, blocks_per_stage=1)


def _logits(seed, b=12, c=10, scale=3.0):
    rng = np.random.default_rng(seed)
    zs = (rng.standard_normal((b, c)) * scale).astype(np.float32)
    zt = (rng.standard_normal((b, c)) * scale).astype(np.float32)
    y = rng.integers(0, c, b).astype(np.int32)
    return zs, zt, y


def _images(seed, b=8):
    return np.random.default_rng(seed).standard_normal(
        (b, 32, 32, 1)).astype(np.float32)


def _jax_tree(params):
    return jax.tree_util.tree_map(jnp.asarray, params)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _student(seed):
    """JAX student params (numpy) with non-trivial biases."""
    params = _np_tree(jcnn.init_student(jax.random.PRNGKey(seed),
                                        jcnn.StudentConfig(**NARROW)))
    rng = np.random.default_rng(seed)
    for name in ("conv1", "conv2", "conv3", "conv4", "head"):
        params[name]["b"] = (0.05 * rng.standard_normal(
            params[name]["b"].shape)).astype(np.float32)
    return params


def _in_f64(fn, *trees):
    """``fn`` of numpy pytrees in JAX float64 (float32 leaves cast up),
    back as numpy."""
    def up(a):
        a = np.asarray(a)
        return jnp.asarray(a, jnp.float64 if a.dtype == np.float32 else None)

    with jax.enable_x64(True):
        out = fn(*[jax.tree_util.tree_map(up, tree) for tree in trees])
        return jax.tree_util.tree_map(np.asarray, out)


def _assert_tree_close(got: dict, want: dict, **tol):
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_got:
        np.testing.assert_allclose(leaf, np.asarray(flat_want[path]),
                                   err_msg=jax.tree_util.keystr(path), **tol)


# ---------------------------------------------------------------------------
# core.distill (Eq. 1-4)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("temperature,alpha", [(4.0, 0.5), (1.0, 0.9),
                                               (2.5, 0.0)])
def test_distill_losses(temperature, alpha):
    zs, zt, y = _logits(0)
    j = [jnp.asarray(a) for a in (zs, zt, y)]
    pairs = [
        (tdistill.softmax_t(t(zs), temperature),
         jdistill.softmax_t(j[0], temperature)),
        (tdistill.kd_loss(t(zs), t(zt), temperature),
         jdistill.kd_loss(j[0], j[1], temperature)),
        (tdistill.cross_entropy(t(zs), t(y)),
         jdistill.cross_entropy(j[0], j[2])),
        (tdistill.distillation_loss(t(zs), t(zt), t(y), alpha=alpha,
                                    temperature=temperature),
         jdistill.distillation_loss(j[0], j[1], j[2], alpha=alpha,
                                    temperature=temperature)),
        (tdistill.per_sample_difficulty(t(zt), t(y)),
         jdistill.per_sample_difficulty(j[1], j[2])),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


def test_curriculum_order_and_pacing():
    """Well-separated difficulties order identically: label margins 0.1
    apart in [0, 3.9] give CEs at least 0.015 apart. Pacing is the same
    integer schedule."""
    rng = np.random.default_rng(1)
    n, c = 40, 10
    y = rng.integers(0, c, n).astype(np.int32)
    margin = rng.permutation(n).astype(np.float32) * 0.1
    zt = np.zeros((n, c), np.float32)
    zt[np.arange(n), y] = margin  # difficulty falls with the margin
    want = np.asarray(jdistill.curriculum_order(jnp.asarray(zt),
                                                jnp.asarray(y)))
    got = tdistill.curriculum_order(t(zt), t(y)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.argsort(-margin))
    ties = np.zeros((6, c), np.float32)  # all equal: a stable sort
    np.testing.assert_array_equal(
        tdistill.curriculum_order(t(ties), t(np.zeros(6, np.int32))).numpy(),
        np.arange(6))
    for sched in [(0.3, 5), (0.4, 1), (1.0, 3)]:
        js, ts = jdistill.CurriculumSchedule(*sched), \
            tdistill.CurriculumSchedule(*sched)
        assert [ts.available(e, 97) for e in range(7)] == \
            [js.available(e, 97) for e in range(7)]


# ---------------------------------------------------------------------------
# core.prune (Eq. 5-7) and core.quant's straight-through estimator
# ---------------------------------------------------------------------------

def test_polynomial_sparsity_is_float32():
    for n_t in (3, 7, 100):
        for step in range(-1, n_t + 2):
            got = tprune.polynomial_sparsity(step, n_t)
            assert got.dtype == torch.float32
            assert float(got) == float(jprune.polynomial_sparsity(step, n_t))
    assert float(tprune.polynomial_sparsity(100, 100)) == \
        float(np.float32(0.8)) == 0.800000011920929
    assert float(tprune.polynomial_sparsity(1, 3, 0.2, 0.9)) == \
        float(jprune.polynomial_sparsity(1, 3, 0.2, 0.9))


@pytest.mark.parametrize("global_ranking", [False, True])
def test_prune_tree_masks_equal(global_ranking):
    rng = np.random.default_rng(2)
    params = {"conv.w": rng.standard_normal((3, 3, 4, 8)).astype(np.float32),
              "conv.b": rng.standard_normal(8).astype(np.float32),
              "head.w": rng.standard_normal((50, 10)).astype(np.float32)}
    for sparsity in (0.5, float(jprune.polynomial_sparsity(3, 3)), 0.37):
        jp, jm = jprune.prune_tree(
            {k: jnp.asarray(v) for k, v in params.items()}, sparsity,
            global_ranking=global_ranking)
        tp, tm = tprune.prune_tree({k: t(v) for k, v in params.items()},
                                   sparsity, global_ranking=global_ranking)
        for k in params:
            np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]),
                                          err_msg=k)
            np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]),
                                          err_msg=k)
        assert tprune.sparsity_of(tp) == jprune.sparsity_of(jp)
    w = params["head.w"]
    assert float(tprune.magnitude_threshold(t(w), 0.8)) == pytest.approx(
        float(jprune.magnitude_threshold(jnp.asarray(w), 0.8)), rel=1e-7)


def test_masks_gradients_and_sparse_format():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((6, 7)).astype(np.float32)
    pruned, masks = tprune.prune_tree({"w": t(w)}, 0.6)
    jpruned, jmasks = jprune.prune_tree({"w": jnp.asarray(w)}, 0.6)
    g = rng.standard_normal((6, 7)).astype(np.float32)
    np.testing.assert_array_equal(
        tprune.mask_gradients({"w": t(g)}, masks)["w"].numpy(),
        np.asarray(jprune.mask_gradients({"w": jnp.asarray(g)},
                                         jmasks)["w"]))
    np.testing.assert_array_equal(
        tprune.apply_masks({"w": t(g)}, masks)["w"].numpy(),
        np.asarray(jprune.apply_masks({"w": jnp.asarray(g)}, jmasks)["w"]))
    s, js = tprune.to_sparse(pruned["w"]), jprune.to_sparse(jpruned["w"])
    for key in ("shape", "indices", "values"):
        np.testing.assert_array_equal(s[key].numpy(), np.asarray(js[key]))
    np.testing.assert_array_equal(tprune.from_sparse(s).numpy(),
                                  pruned["w"].numpy())
    assert tprune.sparse_nbytes(s) == jprune.sparse_nbytes(js)


def test_fake_quant_straight_through_gradient():
    """The STE passes the cotangent on unchanged, as `jax.grad` through the
    JAX package's `custom_vjp` does (a plain round would give zeros)."""
    rng = np.random.default_rng(4)
    w = rng.standard_normal((3, 3, 2, 5)).astype(np.float32)
    c = rng.standard_normal(w.shape).astype(np.float32)
    want = jax.grad(lambda a: jnp.sum(jquant.fake_quant_int8(a)
                                      * jnp.asarray(c)))(jnp.asarray(w))
    tw = t(w).requires_grad_()
    (tquant.fake_quant_int8(tw) * t(c)).sum().backward()
    np.testing.assert_array_equal(tw.grad.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tw.grad.numpy(), c)


def test_int8_scale_is_the_ieee_quotient():
    """amax / 127 rounded once, as the JAX package's eager call computes it,
    including the amax values where the reciprocal product amax * (1/127),
    which CUDA uses for a Python-scalar divisor, rounds differently."""
    rng = np.random.default_rng(11)
    amax = (rng.random(4000) * 3 + 0.01).astype(np.float32)
    quotient = amax / np.float32(127)
    product = amax * np.float32(1 / 127)
    differ = np.flatnonzero(quotient != product)
    assert len(differ) > 50
    for a in amax[differ[:50]]:
        w = np.array([a, -a / 3, a / 7], np.float32)
        _, scale = tquant.quantize_int8(t(w))
        _, jscale = jquant.quantize_int8(jnp.asarray(w))
        assert float(scale) == float(np.float32(a) / np.float32(127)) \
            == float(jscale)


# ---------------------------------------------------------------------------
# optim
# ---------------------------------------------------------------------------

def test_adamw_step_and_clip():
    rng = np.random.default_rng(5)
    params = {"w": rng.standard_normal((4, 6)).astype(np.float32),
              "b": rng.standard_normal(6).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * 3).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    jopt = joptim.adamw(joptim.cosine_schedule(1e-2, 10, warmup=1),
                        weight_decay=0.1)
    topt = toptim.adamw(toptim.cosine_schedule(1e-2, 10, warmup=1),
                        weight_decay=0.1)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: t(v) for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        jg, jnorm = joptim.clip_by_global_norm(
            {k: jnp.asarray(v) for k, v in g.items()}, 1.0)
        tg, tnorm = toptim.clip_by_global_norm({k: t(v) for k, v in g.items()},
                                               1.0)
        assert float(tnorm) == pytest.approx(float(jnorm), rel=1e-6)
        for k in g:
            np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                       atol=1e-6)
        jp, js = jopt.update(jg, js, jp)
        tp, ts = topt.update(tg, ts, tp)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       atol=1e-6, err_msg=k)
    assert int(ts.step) == int(js.step) == 3
    # weight decay reaches the (4, 6) weight only
    zero = {k: np.zeros_like(v) for k, v in params.items()}
    p1, _ = toptim.adamw(0.5, weight_decay=0.1).update(
        {k: t(v) for k, v in zero.items()},
        toptim.adamw(0.5).init({k: t(v) for k, v in params.items()}),
        {k: t(v) for k, v in params.items()})
    np.testing.assert_array_equal(p1["b"].numpy(), params["b"])
    np.testing.assert_allclose(p1["w"].numpy(), params["w"] * 0.95,
                               rtol=1e-6)


@pytest.mark.parametrize("nesterov", [False, True])
def test_sgd_steps(nesterov):
    rng = np.random.default_rng(6)
    p = {"w": rng.standard_normal((3, 4)).astype(np.float32)}
    jopt = joptim.sgd(0.1, nesterov=nesterov, weight_decay=0.01)
    topt = toptim.sgd(0.1, nesterov=nesterov, weight_decay=0.01)
    jp, tp = {"w": jnp.asarray(p["w"])}, {"w": t(p["w"])}
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(3):
        g = rng.standard_normal((3, 4)).astype(np.float32)
        jp, js = jopt.update({"w": jnp.asarray(g)}, js, jp)
        tp, ts = topt.update({"w": t(g)}, ts, tp)
        np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# models: the student's train mode, the teacher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantize", [False, True])
def test_student_train_mode_and_bn_stats(quantize):
    params = _student(0)
    model = convert.student_from_numpy(params, device="cpu")
    x = _images(1)
    want, new = _in_f64(lambda p, a: jcnn.student_logits(
        p, a, train=True, quantize=quantize), params, x)
    got = tcnn.student_logits(model, x, train=True, quantize=quantize)
    assert got.requires_grad
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-6)
    # why float64: the JAX function's own f32 result is farther from it
    want32 = np.asarray(jcnn.student_logits(
        _jax_tree(params), jnp.asarray(x), train=True, quantize=quantize)[0])
    assert np.abs(want32 - want).max() > \
        np.abs(got.detach().numpy() - want).max()
    # the biased batch variance: the unbiased one (nn.BatchNorm2d's update)
    # is n / (n - 1) larger, 5.6e-4 at bn2's n = 8 * 15 * 15
    back = convert.to_numpy(model)
    for bn in ("bn1", "bn2"):
        for stat in ("mean", "var"):
            np.testing.assert_allclose(back[bn][stat], new[bn][stat],
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=f"{bn}.{stat}")


@pytest.mark.parametrize("train", [False, True])
def test_teacher_forward(train):
    """The teacher from converted weights, eval and train mode: the
    stride-2 3x3 convs pad as XLA's SAME does (0 before, 1 after)."""
    cfg = jcnn.TeacherConfig(**TEACHER)
    params = _np_tree(jcnn.init_teacher(jax.random.PRNGKey(1), cfg))
    rng = np.random.default_rng(7)
    for name in ("s1b0", "s2b0"):
        for bn in ("bn1", "bn2"):
            c = params[name][bn]["mean"].shape[0]
            params[name][bn]["mean"] = (0.2 * rng.standard_normal(c)
                                        ).astype(np.float32)
            params[name][bn]["var"] = (0.5 + rng.random(c)).astype(np.float32)
    model = convert.teacher_from_numpy(params, device="cpu")
    assert model.cfg == tcnn.TeacherConfig(**TEACHER)
    x = _images(8, b=5)
    want, new = jcnn.teacher_logits(_jax_tree(params), jnp.asarray(x), cfg,
                                    train=train)
    got = tcnn.teacher_logits(model, x, train=train)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    _assert_tree_close(convert.to_numpy(model), _np_tree(new), rtol=1e-5,
                       atol=1e-7)
    assert tcnn.count_params(model) == jcnn.count_params(params)
    assert tcnn.teacher_macs(tcnn.TeacherConfig()) == \
        jcnn.teacher_macs(jcnn.TeacherConfig())


def test_convert_round_trip_and_masks():
    params = _student(2)
    model = convert.student_from_numpy(params, device="cpu")
    _assert_tree_close(convert.to_numpy(model), params, rtol=0, atol=0)
    _, jmasks = jprune.prune_tree(_jax_tree(params), 0.7)
    masks = convert.masks_from_numpy(_np_tree(jmasks), model)
    assert set(masks) == {k for k, _ in model.named_parameters()}
    np.testing.assert_array_equal(
        masks["conv2.weight"].numpy(),
        np.transpose(np.asarray(jmasks["conv2"]["w"]), (3, 2, 0, 1)))
    np.testing.assert_array_equal(masks["head.weight"].numpy(),
                                  np.asarray(jmasks["head"]["w"]).T)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_synthetic_and_pipeline_bit_identical():
    for split in ("train", "test"):
        got = tsynthetic.load(split, n_per_class=3, seed=4)
        want = jsynthetic.load(split, n_per_class=3, seed=4)
        np.testing.assert_array_equal(got.images, want.images)
        np.testing.assert_array_equal(got.labels, want.labels)
    gray = tsynthetic.to_grayscale(got.images)
    np.testing.assert_array_equal(gray, jsynthetic.to_grayscale(want.images))
    np.testing.assert_array_equal(tsynthetic.normalize(gray),
                                  jsynthetic.normalize(gray))
    x, y = got.images, got.labels
    order = np.random.default_rng(0).permutation(len(y))
    for kw in (dict(seed=1, epoch=2), dict(order=order, limit=17),
               dict(shuffle=False, drop_remainder=False)):
        for (gx, gy), (wx, wy) in zip(
                tpipeline.batches(x, y, 4, **kw),
                jpipeline.batches(x, y, 4, **kw), strict=True):
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)
    assert tpipeline.host_shard(10, 2, 3) == jpipeline.host_shard(10, 2, 3)
    assert tpipeline.num_batches(10, 4, False) == 3
    assert list(tpipeline.prefetch(iter(range(5)))) == list(range(5))


# ---------------------------------------------------------------------------
# one trainer step of each kind, from converted weights
# ---------------------------------------------------------------------------

def _jax_loss(cfg, kd):
    """The JAX trainer's loss functions, as `train_student` builds them."""
    if kd:
        def loss_fn(p, x, y, zt):
            logits, newp = jcnn.student_logits(p, x, train=True,
                                               quantize=cfg.qat)
            return jdistill.distillation_loss(
                logits, zt, y, alpha=cfg.distill_alpha,
                temperature=cfg.distill_temperature), newp
    else:
        def loss_fn(p, x, y):
            logits, newp = jcnn.student_logits(p, x, train=True,
                                               quantize=cfg.qat)
            return jdistill.cross_entropy(logits, y), newp
    return loss_fn


@pytest.mark.parametrize("kind", ["ce", "kd", "kd_masks", "qat"])
def test_one_trainer_step(kind):
    """One step of each kind from converted weights: the JAX step's loss
    (f32) and the JAX step in float64 (loss, parameters, BN statistics)."""
    params = _student(3)
    kd = kind != "ce"
    cfg = jtrainer.TrainConfig(qat=kind == "qat")
    tcfg = ttrainer.TrainConfig(qat=kind == "qat")
    rng = np.random.default_rng(9)
    x = _images(10, b=16)
    y = rng.integers(0, 10, 16).astype(np.int32)
    zt = (rng.standard_normal((16, 10)) * 2).astype(np.float32)
    batch = (x, y, zt) if kd else (x, y)
    jmasks = tmasks = None
    model = convert.student_from_numpy(params, device="cpu")
    if kind == "kd_masks":  # masks from the f32 weights, as JAX prunes them
        jp, jmasks = jprune.prune_tree(_jax_tree(params), 0.6)
        params, jmasks = _np_tree(jp), _np_tree(jmasks)
        tmasks = convert.masks_from_numpy(jmasks, model)
        model = convert.student_from_numpy(params, device="cpu")
    jopt = joptim.adamw(cfg.lr, weight_decay=cfg.weight_decay)

    def jax_step(p, masks, b):
        step = jtrainer._make_step(_jax_loss(cfg, kd), jopt, masks)
        new, _, loss = step(p, jopt.init(p), b)
        return new, loss

    _, jloss32 = jax_step(_jax_tree(params), jmasks,
                          tuple(jnp.asarray(a) for a in batch))
    want, jloss = _in_f64(jax_step, params, jmasks, batch)
    topt = toptim.adamw(tcfg.lr, weight_decay=tcfg.weight_decay)
    tstep = ttrainer._make_step(ttrainer.student_loss(tcfg, kd=kd), topt,
                                tmasks)
    model, state, tloss = tstep(model, topt.init(ttrainer.params_of(model)),
                                ttrainer.to_device(batch, "cpu"))
    assert float(tloss) == pytest.approx(float(jloss32), rel=1e-5)
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-5)
    assert int(state.step) == 1
    got = convert.to_numpy(model)
    for layer, leaves in got.items():
        for name, leaf in leaves.items():
            tol = (dict(rtol=1e-5, atol=1e-7) if name in ("mean", "var")
                   else dict(rtol=0, atol=1e-6))
            np.testing.assert_allclose(leaf, want[layer][name],
                                       err_msg=f"{layer}.{name}", **tol)
    if kind == "kd_masks":
        assert tprune.sparsity_of(ttrainer.params_of(model)) == \
            jprune.sparsity_of(params)
        for k, m in tmasks.items():
            assert not bool(ttrainer.params_of(model)[k][~m].any()), k


def test_train_student_end_to_end_cpu():
    """The whole port trainer at a tiny size on the CPU: teacher, then KD +
    curriculum + prune ramp + fine-tune + QAT; every step's loss finite,
    the final sparsity Eq. 5's, the masks persistent, and as many steps as
    the JAX trainer's schedule gives."""
    torch.manual_seed(0)
    ds = tsynthetic.load("train", n_per_class=8, seed=0)
    x = tsynthetic.normalize(tsynthetic.to_grayscale(ds.images))
    y = ds.labels
    losses = []
    teacher = ttrainer.train_teacher(x, y, tcnn.TeacherConfig(**TEACHER),
                                     epochs=1, batch_size=16, device="cpu",
                                     losses=losses)
    assert len(losses) == 5
    zt = tcnn.teacher_logits(teacher, x).numpy()
    cfg = ttrainer.TrainConfig(epochs=2, batch_size=16, prune_epochs=2,
                               finetune_epochs=1, qat=True)
    model, masks = ttrainer.train_student(
        x, y, student_cfg=tcnn.StudentConfig(**NARROW),
        teacher_logits_all=zt, cfg=cfg, do_prune=True, device="cpu",
        losses=losses)
    pacing = jdistill.CurriculumSchedule(0.4, 1)
    steps = sum(pacing.available(e, 80) // 16 for e in range(5))
    assert len(losses) == 5 + steps
    assert all(np.isfinite(float(v)) for v in losses)
    params = ttrainer.params_of(model)
    prunable = {k: v for k, v in params.items() if v.ndim >= 2}
    sizes = [v.numel() for v in prunable.values()]
    assert abs(tprune.sparsity_of(params) - 0.8) <= len(sizes) / sum(sizes)
    for k, v in prunable.items():
        assert not bool(v[~masks[k]].any()), k
    acc = ttrainer.evaluate(tcnn.student_logits, model, x, y, batch_size=32)
    m = ttrainer.metrics(tcnn.student_logits, model, x, y, batch_size=32)
    assert m["accuracy"] == acc and 0.0 <= m["f1"] <= 1.0
