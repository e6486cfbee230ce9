"""The port's LM loss and gradients in bf16 against the JAX package's, on
the CPU, for one dense config (SMOKE tinyllama-1.1b) and one MoE config
(SMOKE phi3.5-moe).

The reference is the JAX program run op by op (`jax.disable_jit`, with
``remat=False`` since `jax.checkpoint` traces even then): every op
rounds to bf16 as the program says, as the port's eager ops do. (XLA's
compiled bf16 keeps fused chains in f32; the compiled JAX gradients sit
about as far from the op-by-op ones as the port's do.) Tolerances:
  * the loss within 2^-8 relative (one bf16 rounding of the logits moves
    the mean CE by less);
  * every gradient leaf within relative L2 2^-5, the repo's bf16 model
    tolerance (measured: 0.011-0.014), in the leaf's own dtype (bf16, f32
    for the norm scales and the router);
  * the MoE's routing ids equal.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import to_np  # noqa: F401  (one torch thread per worker)
from jax import lax

from repro import configs as jconfigs
from repro.models import layers as jL
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.launch import steps as tsteps
from repro_torch.models import layers as tL

ARCHS = ("tinyllama-1.1b", "phi3.5-moe-42b-a6.6b")
LOSS_RTOL = 2.0 ** -8
GRAD_RTOL = 2.0 ** -5


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(x, jnp.float32), np.float64)


@functools.lru_cache(maxsize=None)
def _both(arch):
    """(JAX loss, grads flat, routing ids; the port's loss, grads stacked,
    routing ids) on one batch, the JAX side op by op."""
    jcfg = dataclasses.replace(jconfigs.get(arch, smoke=True), remat=False)
    tcfg = tconfigs.get(arch, smoke=True)
    assert tcfg.dtype == torch.bfloat16 and tcfg.remat
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    model = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                         device="cpu")
    rng = np.random.RandomState(1)
    batch = {"inputs": rng.randint(0, jcfg.vocab, (2, 16)).astype(np.int32),
             "labels": rng.randint(0, jcfg.vocab, (2, 16)).astype(np.int32)}

    jroutes, troutes = [], []
    orig_moe, orig_route = jL.moe, tL.route

    def jmoe(p, x, *, top_k, router_type="softmax", **kw):
        logits = x.reshape(-1, x.shape[-1]).astype(jnp.float32) \
            @ p["router"]["w"]
        jroutes.append(np.asarray(lax.top_k(jax.nn.softmax(logits), top_k)[1]))
        return orig_moe(p, x, top_k=top_k, router_type=router_type, **kw)

    def troute(p, xf, top_k, router_type):
        out = orig_route(p, xf, top_k, router_type)
        troutes.append(out[3].numpy())
        return out

    jL.moe, tL.route = jmoe, troute
    try:
        with jax.disable_jit():
            jl, jg = jax.value_and_grad(lambda p: jlm.loss_fn(
                p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}))(jp)
        tl, tg = tsteps.value_and_grad(
            model, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    finally:
        jL.moe, tL.route = orig_moe, orig_route
    return (float(jl), convert.flatten_tree(jg), jroutes, float(tl),
            convert.lm_stack(tg), troutes)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_loss_matches_jax_op_by_op(arch):
    jl, _, jroutes, tl, _, troutes = _both(arch)
    assert abs(tl - jl) <= LOSS_RTOL * abs(jl), (tl, jl)
    # the port's forward, then its recompute of each layer in the backward
    # (the last layer first), route as JAX's one forward does
    assert len(troutes) == 2 * len(jroutes)
    for got, want in zip(troutes, jroutes + jroutes[::-1]):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_gradients_match_jax_op_by_op(arch):
    _, jg, _, _, tg, _ = _both(arch)
    assert set(tg) == set(jg)
    for k, want in jg.items():
        got = tg[k]
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype), k
        err = np.linalg.norm(_f64(got) - _f64(want)) / np.linalg.norm(
            _f64(want))
        assert err <= GRAD_RTOL, (k, err)
