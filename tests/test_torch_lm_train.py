"""The port's LM training path (`repro_torch.models.lm.loss_fn`, the
backward through every family, `launch.steps`' AdamW with the JAX decay
set, `optim.compression`) against the JAX package's, on the CPU.

All ten SMOKE configs in f32, the same JAX-initialised weights carried by
`convert.lm_params_from_numpy` and the same numpy batch (a masked label
among them) through both packages. Tolerances:
  * the loss within 1e-5 relative of JAX's;
  * every gradient leaf (the port's per-layer tensors stacked as the JAX
    tree stacks them) within relative L2 1e-4;
  * remat on and off: the same loss and gradients, bit for bit;
  * one `make_optimizer` step from the same gradients: every parameter
    leaf within 1e-6 (the two global norms sum in another order);
  * `compress_decompress` and `compression_ratio`: bit-identical.
The bf16 forward and gradients are in `tests/test_torch_lm_train_bf16.py`.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import to_np  # noqa: F401  (one torch thread per worker)

from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.optim import compression as jcompression
from repro.optim import optimizers as joptim
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm
from repro_torch.optim import compression as tcompression
from repro_torch.optim import optimizers as toptim

ARCHS = tuple(tconfigs.ALIASES)
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4  # relative L2 per leaf
STEP_ATOL = 1e-6


def _cfgs(arch, **kw):
    jcfg = dataclasses.replace(jconfigs.get(arch, smoke=True),
                               dtype=jnp.float32, **kw)
    tcfg = dataclasses.replace(tconfigs.get(arch, smoke=True),
                               dtype=torch.float32, **kw)
    return jcfg, tcfg


def _batch(cfg, b=2, s=16, seed=1) -> dict:
    """A numpy batch; label (0, 3) is masked (-1)."""
    rng = np.random.RandomState(seed)
    if cfg.input_mode == "tokens":
        x = rng.randint(0, cfg.vocab, (b, s)).astype(np.int32)
    else:
        x = rng.randn(b, s, cfg.d_model).astype(np.float32)
    y = rng.randint(0, cfg.vocab, (b, s)).astype(np.int32)
    y[0, 3] = -1
    batch = {"inputs": x, "labels": y}
    if cfg.rope == "mrope":
        batch["positions"] = np.broadcast_to(
            np.arange(s, dtype=np.int32)[None, None], (3, b, s)).copy()
    return batch


def _model(arch):
    jcfg, tcfg = _cfgs(arch)
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, jp), tcfg, device="cpu")


@functools.lru_cache(maxsize=None)
def _grads(arch):
    """(JAX loss, JAX grads as flat numpy, port loss, port grads stacked,
    the JAX params) for the arch, computed once per module."""
    jcfg, tcfg, jp, model = _model(arch)
    batch = _batch(jcfg)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jlm.loss_fn(
        p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})))(jp)
    tl, tg = tsteps.value_and_grad(
        model, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    return (float(jl), convert.flatten_tree(jax.tree.map(np.asarray, jg)),
            float(tl), convert.lm_stack(tg), jp)


def _rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax(arch):
    jl, jg, tl, tg, _ = _grads(arch)
    assert abs(tl - jl) <= LOSS_RTOL * abs(jl), (tl, jl)
    assert set(tg) == set(jg)
    for k, want in jg.items():
        got = tg[k]
        assert tuple(got.shape) == want.shape, k
        assert got.dtype == torch.float32, k
        assert np.linalg.norm(want) > 0, k  # every leaf is trained
        assert _rel_l2(got.numpy(), want) <= GRAD_RTOL, k


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_changes_no_number(arch):
    """``cfg.remat`` recomputes each layer in the backward
    (`torch.utils.checkpoint`): the loss and every gradient are the ones
    without it, bit for bit."""
    _, tcfg, _, model = _model(arch)
    batch = {k: torch.from_numpy(v) for k, v in _batch(tcfg).items()}
    assert tcfg.remat
    on = tsteps.value_and_grad(model, tcfg, batch)
    off = tsteps.value_and_grad(model, dataclasses.replace(
        tcfg, remat=False), batch)
    assert torch.equal(on[0], off[0])
    for k in on[1]:
        assert torch.equal(on[1][k], off[1][k]), k


def test_sharded_ce_masked_and_out_of_range_labels():
    """Per position: the log-sum-exp minus the true logit; a label < 0 or
    >= V picks 0 (a zero one-hot row), so its CE is the log-sum-exp; the
    gradient equals JAX's (the max held out of it)."""
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((2, 5, 11)) * 4).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    labels[0, 1], labels[1, 4], labels[1, 0] = -1, 11, -7
    want = jlm.sharded_ce(jnp.asarray(logits), jnp.asarray(labels))
    x = torch.from_numpy(logits).requires_grad_()
    got = tlm.sharded_ce(x, torch.from_numpy(labels))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    lse = np.log(np.exp(logits - logits.max(-1, keepdims=True)).sum(-1))
    for i, j in ((0, 1), (1, 4), (1, 0)):
        np.testing.assert_allclose(float(got.detach()[i, j]), lse[i, j],
                                   rtol=1e-6)
    w = rng.standard_normal((2, 5)).astype(np.float32)
    jgrad = jax.grad(lambda z: jnp.sum(jlm.sharded_ce(
        z, jnp.asarray(labels)) * w))(jnp.asarray(logits))
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad),
                               rtol=1e-5, atol=1e-6)


def test_loss_fn_masks_negative_labels():
    """`loss_fn` averages over the labels >= 0 only (a masked row leaves
    the mean of the others), as JAX's does; all masked gives the aux term
    alone (0 here)."""
    jcfg, tcfg, jp, model = _model("tinyllama-1.1b")
    batch = _batch(jcfg)
    batch["labels"][1] = -1
    want = jlm.loss_fn(jp, jcfg, {k: jnp.asarray(v)
                                  for k, v in batch.items()})
    with torch.no_grad():
        got = tlm.loss_fn(model, tcfg, batch)
        np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
        batch["labels"][:] = -1
        assert float(tlm.loss_fn(model, tcfg, batch)) == 0.0


def _adam_step(arch, jgrads_flat, jp):
    """One `make_optimizer` step of both packages from the same
    gradients: (JAX new params flat numpy, the port's stacked)."""
    jcfg, tcfg = _cfgs(arch)
    jopt, topt = jsteps.make_optimizer(jcfg), tsteps.make_optimizer(tcfg)
    jg = jax.tree.map(jnp.asarray, convert.nest(jgrads_flat))
    jg, _ = joptim.clip_by_global_norm(jg, 1.0)
    jnew, jstate = jopt.update(jg, jopt.init(jp), jp)
    model = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                         device="cpu")
    params = {k: p.detach() for k, p in model.named_parameters()}
    tg = convert.lm_unstack({k: torch.from_numpy(np.array(v))
                             for k, v in jgrads_flat.items()})
    tg, _ = toptim.clip_by_global_norm(tg, 1.0)
    tnew, tstate = topt.update(tg, topt.init(params), params)
    assert int(tstate.step) == int(jstate.step) == 1
    return (convert.flatten_tree(jax.tree.map(np.asarray, jnew)),
            convert.lm_stack(tnew))


@pytest.mark.parametrize("arch", ARCHS)
def test_optimizer_step_matches_jax(arch):
    _, jg, _, _, jp = _grads(arch)
    want, got = _adam_step(arch, jg, jp)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=STEP_ATOL, err_msg=k)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "hymba-1.5b",
                                  "deepseek-v3-671b"])
def test_weight_decay_set_is_jaxs(arch):
    """With zero gradients a step is the weight decay alone: every leaf of
    JAX's stacked tree with ``ndim >= 2`` shrinks by ``1 - lr * 0.1``,
    which takes in every per-layer norm scale, bias, ``A_log``, ``D`` and
    ``dt_bias`` (their stacked leaves are 2-D), but not ``final_norm``.
    The port's default per-tensor ``ndim`` rule would leave the per-layer
    ones alone."""
    jcfg = _cfgs(arch)[0]
    # every leaf away from 0 (the biases, A_log and dt_bias start at 0)
    jp = jax.tree.map(lambda x: x + 0.5,
                      jlm.init_params(jax.random.PRNGKey(0), jcfg))
    zeros = {k: np.zeros_like(v) for k, v in convert.flatten_tree(
        jax.tree.map(np.asarray, jp)).items()}
    want, got = _adam_step(arch, zeros, jp)
    before = convert.flatten_tree(jax.tree.map(np.asarray, jp))
    decayed = [k for k in want if not np.array_equal(want[k], before[k])]
    assert "final_norm.scale" not in decayed
    per_layer_vectors = [k for k in before
                         if k.startswith("layers.") and before[k].ndim == 2]
    assert per_layer_vectors and set(per_layer_vectors) <= set(decayed)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    # the per-module rule (adamw's default) decays none of those
    params = {k: torch.from_numpy(np.array(v)) for k, v in
              convert.lm_unstack(before).items()}
    plain = toptim.adamw(3e-4, weight_decay=0.1)
    new, _ = plain.update({k: torch.zeros_like(p) for k, p in params.items()},
                          plain.init(params), params)
    stacked = convert.lm_stack(new)
    assert all(np.array_equal(stacked[k].numpy(), before[k])
               for k in per_layer_vectors)


@pytest.mark.parametrize("arch", ARCHS)
def test_compression_is_bit_identical(arch):
    """int8 compression with error feedback over the JAX leaves (the
    port's layer tensors stacked): two steps, the second carrying the
    first's error; dequantised gradients, error and ratio bit for bit."""
    _, jg, _, _, _ = _grads(arch)
    rng = np.random.default_rng(5)
    second = {k: (v * rng.standard_normal(v.shape)).astype(np.float32)
              for k, v in jg.items()}
    jerr = jcompression.init_error_state(convert.nest(jg))
    terr = tcompression.init_error_state(
        {k: torch.from_numpy(np.array(v)) for k, v in jg.items()})
    for grads in (jg, second):
        jdeq, jerr = jcompression.compress_decompress(
            jax.tree.map(jnp.asarray, convert.nest(grads)), jerr)
        tdeq, terr = tcompression.compress_decompress(
            {k: torch.from_numpy(np.array(v)) for k, v in grads.items()},
            terr)
        jdeq_flat = convert.flatten_tree(jax.tree.map(np.asarray, jdeq))
        jerr_flat = convert.flatten_tree(jax.tree.map(np.asarray, jerr))
        for k in grads:
            np.testing.assert_array_equal(tdeq[k].numpy(), jdeq_flat[k], k)
            np.testing.assert_array_equal(terr[k].numpy(), jerr_flat[k], k)
    assert tcompression.compression_ratio(
        {k: torch.from_numpy(np.array(v)) for k, v in jg.items()}) \
        == jcompression.compression_ratio(convert.nest(jg))


def test_train_step_compresses_over_the_jax_leaves():
    """`make_train_step(compress=True)` quantises each JAX leaf with one
    scale: its error carry has the stacked shapes and equals the JAX
    compression of the same gradients."""
    jcfg, tcfg, jp, model = _model("phi3.5-moe-42b-a6.6b")
    batch = {k: torch.from_numpy(v) for k, v in _batch(tcfg).items()}
    _, grads = tsteps.value_and_grad(model, tcfg, batch)
    opt = tsteps.make_optimizer(tcfg)
    step = tsteps.make_train_step(tcfg, opt, compress=True)
    err0 = tsteps.init_error_state(model)
    assert {k: tuple(v.shape) for k, v in err0.items()} == {
        k: v.shape for k, v in convert.flatten_tree(
            jax.tree.map(np.asarray, jp)).items()}
    opt_state = opt.init({k: p.detach() for k, p in model.named_parameters()})
    _, _, err, _ = step(model, opt_state, err0, batch)
    stacked = {k: v.numpy() for k, v in convert.lm_stack(grads).items()}
    _, jerr = jcompression.compress_decompress(
        jax.tree.map(jnp.asarray, convert.nest(stacked)),
        jcompression.init_error_state(convert.nest(stacked)))
    for k, v in convert.flatten_tree(jax.tree.map(np.asarray, jerr)).items():
        np.testing.assert_array_equal(err[k].numpy(), v, k)
