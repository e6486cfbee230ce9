"""The port's MoE, MLA, Mamba2 SSD and hymba hybrid heads
(`repro_torch.models.{layers,lm}`) against the JAX package's, on the CPU.

The same JAX-initialised weights (carried by `convert.lm_params_from_numpy`)
and the same numpy inputs go through both packages on the SMOKE configs of
phi3.5-moe (softmax top-2 MoE), deepseek-v3 (MLA, sigmoid top-2 MoE with a
shared expert), mamba2 (the SSD, no attention) and hymba (attention and SSM
heads averaged, a sliding window).

Tolerances (those of `tests/test_torch_lm.py`):
  * f32: ``rtol=1e-5, atol=1e-5`` on logits and on every cache field, and
    identical greedy tokens and routing ids.
  * bf16, one op: every element bitwise equal to the JAX value or one bf16
    ulp from it.
  * bf16, the model: ``|diff| <= 2**-5 * max|ref|``, with the routing ids
    equal. The bf16 reference of an MoE model's forward is the JAX program
    run op by op (`jax.disable_jit`), where every op rounds to bf16 as the
    program says: compiled, XLA keeps fused bf16 chains in f32, which moves
    the router's inputs by an ulp and, at the SMOKE deepseek-v3's near tie,
    routes one token to another expert in the compiled forward alone. The
    port equals the op-by-op forward bit for bit there. Prefill and decode
    are held against the compiled JAX functions.

Routing ids come from the router's f32 scores on both sides; each test
that compares them reports the smallest gap between the k-th and the
(k+1)-th score.
"""
import contextlib
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
from repro_torch.models import layers as tL
from repro_torch.models import lm as tlm

ARCHS = ("phi3.5-moe-42b-a6.6b", "deepseek-v3-671b", "mamba2-2.7b",
         "hymba-1.5b")
MOE_ARCHS = ARCHS[:2]
BF16_REL = 2.0 ** -5
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(arch, dtype="f32"):
    jcfg, tcfg = jconfigs.get(arch, smoke=True), tconfigs.get(arch,
                                                             smoke=True)
    if dtype == "f32":
        jcfg = dataclasses.replace(jcfg, dtype=jnp.float32)
        tcfg = dataclasses.replace(tcfg, dtype=torch.float32)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _models(arch, dtype="f32", seed=0):
    """(JAX config, port config, JAX params, port params), built once per
    module: no test mutates a parameter."""
    jcfg, tcfg = _cfgs(arch, dtype)
    jp = jlm.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                      device="cpu")
    return jcfg, tcfg, jp, tp


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, dtype, what=""):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, what
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=what)
    else:
        err = np.abs(got - want).max()
        assert err <= BF16_REL * np.abs(want).max(), (what, err)


def _bf16_steps(x) -> np.ndarray:
    bits = (x.view(torch.int16).numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x).view(np.int16)).astype(np.int32)
    return np.where(bits < 0, -(bits & 0x7FFF), bits)


def _op_close(got, want, dtype, what=""):
    """One op: f32 as `_close`; bf16 elementwise within one bf16 ulp."""
    if dtype == "f32":
        return _close(got, want, dtype, what)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert tuple(got.shape) == want.shape
    ulps = np.abs(_bf16_steps(got) - _bf16_steps(want))
    assert ulps.max() <= 1, (what, ulps.max(), (ulps > 1).sum())


def _caches_close(tc, jc, dtype):
    """Every cache field: None on both sides, or equal within the
    tolerance; the shared length equal."""
    for f in tlm.CACHE_FIELDS:
        got, want = getattr(tc, f), getattr(jc, f)
        assert (got is None) == (want is None), f
        if got is not None:
            assert got.dtype == (torch.float32 if f == "ssm"
                                 else DTYPES[dtype][1]), f
            _close(got, want, dtype, f)
    assert tc.length == int(jc.length)


def _min_gap(scores, k) -> float:
    """The smallest gap between the k-th and (k+1)-th score of a row."""
    s = -np.sort(-np.asarray(scores, np.float32), axis=-1)
    return float((s[:, k - 1] - s[:, k]).min())


@contextlib.contextmanager
def _patched(module, name, fn):
    orig = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield orig
    finally:
        setattr(module, name, orig)


def _port_routes(fn):
    """Run ``fn()`` recording the port's routing: [(ids, scores)] per MoE
    call."""
    routes = []
    orig = tL.route

    def rec(p, xf, top_k, router_type):
        out = orig(p, xf, top_k, router_type)
        routes.append((out[3].numpy(), out[1].numpy()))
        return out

    with _patched(tL, "route", rec):
        result = fn()
    return result, routes


def _jax_routes(fn, eager: bool):
    """Run ``fn()`` recording the JAX MoE's routing: its router's scores
    and ``lax.top_k`` ids, recomputed from the same inputs and weights as
    the layer's own. ``eager`` runs it op by op (`jax.disable_jit`; call it
    with a config of ``remat=False``, since `jax.checkpoint` traces even
    then); else the compiled program reports through `jax.debug.callback`,
    one call per layer in order."""
    routes = []
    orig = jL.moe

    def keep(ids, scores):
        routes.append((np.asarray(ids), np.asarray(scores)))

    def rec(p, x, *, top_k, router_type="softmax", **kw):
        logits = x.reshape(-1, x.shape[-1]).astype(jnp.float32) \
            @ p["router"]["w"]
        scores = (jax.nn.softmax(logits, axis=-1) if router_type == "softmax"
                  else jax.nn.sigmoid(logits))
        ids = lax.top_k(scores, top_k)[1]
        if eager:
            keep(ids, scores)
        else:
            jax.debug.callback(keep, ids, scores, ordered=True)
        return orig(p, x, top_k=top_k, router_type=router_type, **kw)

    with _patched(jL, "moe", rec), (jax.disable_jit() if eager
                                    else contextlib.nullcontext()):
        result = fn()
        jax.effects_barrier()
    return result, routes


def _same_routes(got, want, k) -> float:
    assert len(got) == len(want) > 0
    gaps = []
    for layer, ((ti, ts), (ji, js)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(ti, ji, err_msg=f"routing, call "
                                      f"{layer}")
        gaps.append(_min_gap(js, k))
    print(f"smallest k / k+1 score gap: {min(gaps):.3g}")
    return min(gaps)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _moe_params(rng, d, f, e, shared):
    w = dict(router=rng.standard_normal((d, e)).astype(np.float32) * d ** -.5,
             gate=rng.standard_normal((e, d, f)).astype(np.float32) * d ** -.5,
             up=rng.standard_normal((e, d, f)).astype(np.float32) * d ** -.5,
             down=rng.standard_normal((e, f, d)).astype(np.float32)
             * f ** -.5)
    if shared:
        w["shared"] = [rng.standard_normal(s).astype(np.float32) * s[0] ** -.5
                       for s in ((d, f), (d, f), (f, d))]
    return w


def _moe_both(w, dtype):
    jdt, tdt = DTYPES[dtype]
    jp = {"router": {"w": jnp.asarray(w["router"])},
          **{k: jnp.asarray(w[k]).astype(jdt) for k in ("gate", "up",
                                                        "down")}}
    shared = None
    if "shared" in w:
        jp["shared"] = {k: {"w": jnp.asarray(a).astype(jdt)}
                        for k, a in zip(("gate", "up", "down"), w["shared"])}
        shared = tL.MLP(*(tL.Linear(torch.from_numpy(a).to(tdt))
                          for a in w["shared"]))
    tp = tL.MoE(tL.Linear(torch.from_numpy(w["router"])),
                *(torch.from_numpy(w[k]).to(tdt) for k in ("gate", "up",
                                                           "down")), shared)
    return jp, tp


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("router,top_k,shared", [
    ("softmax", 2, False), ("softmax", 2, True), ("sigmoid", 3, False),
    ("sigmoid", 3, True)])
def test_moe_matches_jax(dtype, router, top_k, shared):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(11)
    w = _moe_params(rng, 48, 64, 6, shared)
    x = rng.standard_normal((3, 7, 48)).astype(np.float32)
    jp, tp = _moe_both(w, dtype)
    kw = dict(top_k=top_k, router_type=router)
    jy, jaux = jL.moe(jp, jnp.asarray(x).astype(jdt), **kw)
    (ty, taux), routes = _port_routes(
        lambda: tL.moe(tp, torch.from_numpy(x).to(tdt), **kw))
    assert ty.dtype == tdt
    _op_close(ty, jy, dtype, "y")
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    xf = jnp.asarray(x).astype(jdt).reshape(-1, 48).astype(jnp.float32)
    logits = xf @ jp["router"]["w"]
    scores = (jax.nn.softmax(logits, -1) if router == "softmax"
              else jax.nn.sigmoid(logits))
    _same_routes(routes, [(np.asarray(lax.top_k(scores, top_k)[1]),
                           np.asarray(scores))], top_k)


def test_topk_ties_go_to_the_lower_expert():
    """Equal scores: ``lax.top_k`` keeps the lower index first."""
    p = tL.MoE(tL.Linear(torch.zeros((4, 6))), *(torch.zeros(s) for s in (
        (6, 4, 2), (6, 4, 2), (6, 2, 4))))
    for router in ("softmax", "sigmoid"):
        _, _, w, ids = tL.route(p, torch.ones((3, 4)), 4, router)
        assert ids.tolist() == [[0, 1, 2, 3]] * 3
        assert torch.equal(w, torch.full((3, 4), 0.25))


def test_moe_capacity_drops_match_jax():
    """t = 2 x 2100 > 4096 tokens: the capacity-factor rule drops slots;
    the kept-slot mask, the output and the aux loss equal JAX's (f32)."""
    rng = np.random.default_rng(12)
    d, f, e, k = 32, 48, 4, 2
    w = _moe_params(rng, d, f, e, False)
    x = rng.standard_normal((2, 2100, d)).astype(np.float32)
    # expert 0 oversubscribed (a positive feature it weighs up): its last
    # slots drop
    x[..., 0] = np.abs(x[..., 0]) + 1
    w["router"][0, 0] = 3.0
    jp, tp = _moe_both(w, "f32")
    jy, jaux = jL.moe(jp, jnp.asarray(x), top_k=k)
    ty, taux = tL.moe(tp, torch.from_numpy(x), top_k=k)
    _close(ty, jy, "f32", "y")
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    # JAX's dispatch lines (`layers.moe`) on JAX's routing
    t = 2 * 2100
    cap = max(int(-(-t * k // e) * 1.25), k)
    scores = jax.nn.softmax(jnp.asarray(x).reshape(t, d) @ jp["router"]["w"],
                            axis=-1)
    ids = lax.top_k(scores, k)[1]
    flat = ids.reshape(-1)
    sort_idx = jnp.argsort(flat)
    sorted_ids = flat[sort_idx]
    seg_start = jnp.searchsorted(sorted_ids, jnp.arange(e))
    want_keep = np.asarray(jnp.arange(t * k) - seg_start[sorted_ids] < cap)
    assert tL.capacity(t, k, e, 1.25) == cap
    _, _, _, keep, _ = tL.dispatch(torch.from_numpy(np.array(ids)), e, cap)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    assert 0 < (~want_keep).sum() < t * k  # slots did drop
    print(f"capacity {cap}: {(~want_keep).sum()} of {t * k} slots dropped; "
          f"smallest k / k+1 gap {_min_gap(np.asarray(scores), k):.3g}")


# ---------------------------------------------------------------------------
# Mamba2 SSD
# ---------------------------------------------------------------------------

def test_segsum_matches_jax():
    a = -np.random.default_rng(13).random((2, 3, 17)).astype(np.float32)
    got, want = tL._segsum(torch.from_numpy(a)), np.asarray(jL._segsum(
        jnp.asarray(a)))
    assert np.array_equal(np.isneginf(got.numpy()), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got.numpy()[fin], want[fin], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s", [1, 2, 9])
def test_causal_conv_matches_jax(dtype, with_state, s):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(14 + s)
    x = rng.standard_normal((2, s, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32) * 0.3
    st = rng.standard_normal((2, 3, 24)).astype(np.float32) \
        if with_state else None
    jy, jst = jL._causal_conv(jnp.asarray(x).astype(jdt),
                              jnp.asarray(w).astype(jdt),
                              None if st is None else jnp.asarray(st).astype(
                                  jdt))
    ty, tst = tL._causal_conv(torch.from_numpy(x).to(tdt),
                              torch.from_numpy(w).to(tdt),
                              None if st is None else torch.from_numpy(st).to(
                                  tdt))
    _op_close(ty, jy, dtype, "y")
    _op_close(tst, jst, dtype, "state")


def _ssd_inputs(rng, b, s, h, p, n):
    xh = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(h) * 0.5).astype(np.float32)
    Bm = rng.standard_normal((b, s, n)).astype(np.float32)
    Cm = rng.standard_normal((b, s, n)).astype(np.float32)
    return xh, dt, A, Bm, Cm


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("s,h,p,n,chunk,init", [
    (45, 3, 8, 4, 16, False),   # S not a multiple of the chunk, N < P
    (45, 3, 8, 4, 16, True),    # ... continuing from a state
    (20, 2, 4, 8, 8, True),     # N > P: the state-times-C pair first
    (7, 2, 8, 8, 32, False)])   # one partial chunk, N == P
def test_ssd_scan_matches_jax(dtype, s, h, p, n, chunk, init):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(s + h + p + n)
    xh, dt, A, Bm, Cm = _ssd_inputs(rng, 2, s, h, p, n)
    st = rng.standard_normal((2, h, p, n)).astype(np.float32) \
        if init else None
    spec = jL.SSMSpec(d_inner=h * p, n_heads=h, head_dim=p, d_state=n,
                      chunk=chunk)
    jy, jfin = jL.ssd_scan(jnp.asarray(xh).astype(jdt), jnp.asarray(dt),
                           jnp.asarray(A), jnp.asarray(Bm).astype(jdt),
                           jnp.asarray(Cm).astype(jdt), spec,
                           None if st is None else jnp.asarray(st))
    ty, tfin = tL.ssd_scan(torch.from_numpy(xh).to(tdt),
                           torch.from_numpy(dt), torch.from_numpy(A),
                           torch.from_numpy(Bm).to(tdt),
                           torch.from_numpy(Cm).to(tdt),
                           tL.SSMSpec(*spec),
                           None if st is None else torch.from_numpy(st))
    assert ty.dtype == tdt and tfin.dtype == torch.float32
    _op_close(ty, jy, dtype, "y")
    np.testing.assert_allclose(tfin.numpy(), np.asarray(jfin), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("b,h,p,n,chunk", [
    (2, 8, 32, 16, 32),     # the SMOKE configs
    (4, 25, 64, 16, 256),   # hymba-1.5b
    (4, 80, 64, 128, 256),  # mamba2-2.7b
    (4, 8, 32, 32, 32)])    # N == P
def test_y_off_order_is_xlas(b, h, p, n, chunk):
    """The inter-chunk output's pair order (`layers.y_off_order`) is the
    one `jax.make_jaxpr` of ``ssd_scan`` shows: its last dot_general
    contracts the state (b, c, h, p, n) with C over N first exactly when
    the port says so."""
    spec = jL.SSMSpec(d_inner=h * p, n_heads=h, head_dim=p, d_state=n,
                      chunk=chunk)
    S = jax.ShapeDtypeStruct
    jaxpr = jax.make_jaxpr(lambda *a: jL.ssd_scan(*a, spec))(
        S((b, 32, h, p), jnp.bfloat16), S((b, 32, h), jnp.float32),
        S((h,), jnp.float32), S((b, 32, n), jnp.bfloat16),
        S((b, 32, n), jnp.bfloat16))
    dots = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "dot_general"]
    y_off_first = dots[-2]  # the pairs: scores, y_diag x2, states x2, y_off x2
    operands = [tuple(v.aval.shape) for v in y_off_first.invars]
    states_first = (b, 1, h, p, n) in operands
    assert states_first == (tL.y_off_order(n, p) == "states_c"), operands


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ssd_step_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(15)
    xh, dt, A, Bm, Cm = _ssd_inputs(rng, 3, 1, 4, 8, 16)
    st = rng.standard_normal((3, 4, 8, 16)).astype(np.float32)
    jy, jst = jL.ssd_step(jnp.asarray(xh).astype(jdt), jnp.asarray(dt),
                          jnp.asarray(A), jnp.asarray(Bm).astype(jdt),
                          jnp.asarray(Cm).astype(jdt), jnp.asarray(st))
    ty, tst = tL.ssd_step(torch.from_numpy(xh).to(tdt), torch.from_numpy(dt),
                          torch.from_numpy(A), torch.from_numpy(Bm).to(tdt),
                          torch.from_numpy(Cm).to(tdt), torch.from_numpy(st))
    _op_close(ty, jy, dtype, "y")
    np.testing.assert_allclose(tst.numpy(), np.asarray(jst), rtol=1e-5,
                               atol=1e-5)


def _ssd_block_params(rng, d, spec, dtype):
    jdt, tdt = DTYPES[dtype]
    din, h, n = spec.d_inner, spec.n_heads, spec.d_state
    a = dict(in_proj=rng.standard_normal((d, 2 * din + 2 * n + h)) * d ** -.5,
             conv_w=rng.standard_normal((4, din + 2 * n)) * 0.3,
             A_log=rng.standard_normal(h) * 0.3, D=rng.random(h) + 0.5,
             dt_bias=rng.standard_normal(h) * 0.3,
             out_norm=rng.random(din) + 0.5,
             out_proj=rng.standard_normal((din, d)) * din ** -.5)
    a = {k: v.astype(np.float32) for k, v in a.items()}
    jp = {"in_proj": {"w": jnp.asarray(a["in_proj"]).astype(jdt)},
          "conv_w": jnp.asarray(a["conv_w"]).astype(jdt),
          **{k: jnp.asarray(a[k]) for k in ("A_log", "D", "dt_bias")},
          "out_norm": {"scale": jnp.asarray(a["out_norm"])},
          "out_proj": {"w": jnp.asarray(a["out_proj"]).astype(jdt)}}
    norm = tL.rmsnorm_init(din, device="cpu")
    norm.scale.data = torch.from_numpy(a["out_norm"])
    tp = tL.SSD(tL.Linear(torch.from_numpy(a["in_proj"]).to(tdt)),
                torch.from_numpy(a["conv_w"]).to(tdt),
                *(torch.from_numpy(a[k]) for k in ("A_log", "D", "dt_bias")),
                norm, tL.Linear(torch.from_numpy(a["out_proj"]).to(tdt)))
    return jp, tp


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("s,with_state", [(19, False), (1, True),
                                          (5, True)])
def test_ssd_block_matches_jax(dtype, s, with_state):
    """From zero (the chunked scan), one token with a state (`ssd_step`)
    and several tokens with a state (the scan from ``init_state``)."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(16 + s)
    spec = jL.SSMSpec(d_inner=32, n_heads=4, head_dim=8, d_state=8, chunk=8)
    jp, tp = _ssd_block_params(rng, 24, spec, dtype)
    x = rng.standard_normal((2, s, 24)).astype(np.float32)
    state = None
    if with_state:
        conv = rng.standard_normal((2, 3, 48)).astype(np.float32)
        ssm = rng.standard_normal((2, 4, 8, 8)).astype(np.float32) * 0.5
        state = ({"conv": jnp.asarray(conv).astype(jdt),
                  "ssm": jnp.asarray(ssm)},
                 {"conv": torch.from_numpy(conv).to(tdt),
                  "ssm": torch.from_numpy(ssm)})
    jy, jst = jL.ssd_block(jp, jnp.asarray(x).astype(jdt), spec,
                           state=state and state[0])
    ty, tst = tL.ssd_block(tp, torch.from_numpy(x).to(tdt),
                           tL.SSMSpec(*spec), state=state and state[1])
    _close(ty, jy, dtype, "y")
    _op_close(tst["conv"], jst["conv"], dtype, "conv")
    np.testing.assert_allclose(tst["ssm"].numpy(), np.asarray(jst["ssm"]),
                               rtol=1e-5, atol=1e-5 if dtype == "f32"
                               else 2 ** -5 * np.abs(jst["ssm"]).max())


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mla_q_and_kv_compressed_match_jax(dtype):
    jcfg, tcfg, jp, tp = _models("deepseek-v3-671b", dtype)
    jdt, tdt = DTYPES[dtype]
    x = np.random.default_rng(17).standard_normal(
        (2, 9, jcfg.d_model)).astype(np.float32)
    pos = np.random.default_rng(18).integers(0, 300, (2, 9)).astype(np.int32)
    ja = jax.tree.map(lambda a: a[1], jp["layers"]["attn"])
    ta = tp.layers[1].attn
    jx, tx = jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)
    for got, want, what in zip(
            tlm._mla_q(ta, tcfg, tx, torch.from_numpy(pos))
            + tlm._mla_kv_compressed(ta, tcfg, tx, torch.from_numpy(pos)),
            jlm._mla_q(ja, jcfg, jx, jnp.asarray(pos))
            + jlm._mla_kv_compressed(ja, jcfg, jx, jnp.asarray(pos)),
            ("q_nope", "q_rope", "c_kv", "k_rope")):
        _op_close(got, want, dtype, what)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_init_params_builds_every_jax_leaf():
    """Every JAX leaf of the four families has a port parameter of the
    same name (dots for dict keys, the layer index for the stack), shape
    and dtype, and nothing else; the seed makes the draw."""
    for arch in ARCHS:
        jcfg, tcfg = _cfgs(arch, "bf16")
        jp = jax.eval_shape(lambda: jlm.init_params(jax.random.PRNGKey(0),
                                                    jcfg))
        want = {}
        for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
            keys = [k.key for k in path]
            for i in range(jcfg.n_layers if keys[0] == "layers" else 1):
                name = ".".join(keys[:1] + [str(i)] + keys[1:]) \
                    if keys[0] == "layers" else ".".join(keys)
                shape = leaf.shape[1:] if keys[0] == "layers" else leaf.shape
                want[name] = (tuple(shape), str(leaf.dtype))
        tp = tlm.init_params(0, tcfg, device="cpu")
        got = {n: (tuple(p.shape), str(p.dtype).replace("torch.", ""))
               for n, p in tp.named_parameters()}
        assert got == want, arch
        again = tlm.init_params(0, tcfg, device="cpu")
        assert all(torch.equal(a, b) for a, b in zip(tp.parameters(),
                                                     again.parameters()))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_jax_f32(arch):
    jcfg, tcfg, jp, tp = _models(arch)
    s = 12
    x = _tokens(jcfg, 2, s + 1)
    jl, jaux = jlm.forward(jp, jcfg, jnp.asarray(x))
    tl, taux = tlm.forward(tp, tcfg, x)
    _close(tl, jl, "f32", "forward")
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    assert (float(taux) > 0) == (tcfg.n_experts > 0)
    jpl, jc = jlm.prefill(jp, jcfg, jnp.asarray(x[:, :s]), max_len=s + 4)
    tpl, tc = tlm.prefill(tp, tcfg, x[:, :s], max_len=s + 4)
    _close(tpl, jpl, "f32", "prefill")
    _caches_close(tc, jc, "f32")
    jd, jc2 = jlm.decode_step(jp, jcfg, jnp.asarray(x[:, s:s + 1]), jc)
    td, tc2 = tlm.decode_step(tp, tcfg, x[:, s:s + 1], tc)
    _close(td, jd, "f32", "decode")
    _caches_close(tc2, jc2, "f32")
    assert tc2.length == s + 1


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_match_jax_bf16(arch):
    jcfg, tcfg, jp, tp = _models(arch, "bf16")
    s = 12
    x = _tokens(jcfg, 2, s + 1, seed=1)
    jpl, jc = jlm.prefill(jp, jcfg, jnp.asarray(x[:, :s]), max_len=s + 4)
    tpl, tc = tlm.prefill(tp, tcfg, x[:, :s], max_len=s + 4)
    _close(tpl, jpl, "bf16", "prefill")
    _caches_close(tc, jc, "bf16")
    jd, jc2 = jlm.decode_step(jp, jcfg, jnp.asarray(x[:, s:s + 1]), jc)
    td, tc2 = tlm.decode_step(tp, tcfg, x[:, s:s + 1], tc)
    _close(td, jd, "bf16", "decode")
    _caches_close(tc2, jc2, "bf16")
    if arch not in MOE_ARCHS:  # no routing: the compiled forward
        jl, _ = jlm.forward(jp, jcfg, jnp.asarray(x))
        _close(tlm.forward(tp, tcfg, x)[0], jl, "bf16", "forward")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_routes_like_jax(arch, dtype):
    """The routing ids of every MoE layer at every token equal the JAX
    program's (compiled in f32, op by op in bf16), and so do the logits
    and the aux loss."""
    jcfg, tcfg, jp, tp = _models(arch, dtype)
    x = _tokens(jcfg, 2, 13)
    if dtype == "bf16":  # op by op (the module docstring)
        jcfg = dataclasses.replace(jcfg, remat=False)  # the same values
    (jl, jaux), jr = _jax_routes(
        lambda: jlm.forward(jp, jcfg, jnp.asarray(x)), eager=dtype == "bf16")
    (tl, taux), tr = _port_routes(lambda: tlm.forward(tp, tcfg, x))
    assert len(tr) == tcfg.n_layers
    _same_routes(tr, jr, tcfg.top_k)
    _close(tl, jl, dtype, "forward")
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_jax(arch):
    """f32: eight greedy steps from a prefill give the same tokens."""
    jcfg, tcfg, jp, tp = _models(arch)
    x = _tokens(jcfg, 2, 10, seed=5)
    jlog, jc = jlm.prefill(jp, jcfg, jnp.asarray(x), max_len=24)
    tlog, tc = tlm.prefill(tp, tcfg, x, max_len=24)
    step = jax.jit(lambda t, c: jlm.decode_step(jp, jcfg, t, c))
    jt, tt = [], []
    for _ in range(8):
        jt.append(np.asarray(jnp.argmax(jlog, -1)))
        tt.append(torch.argmax(tlog, -1).numpy())
        jlog, jc = step(jnp.asarray(jt[-1][:, None]), jc)
        tlog, tc = tlm.decode_step(tp, tcfg, tt[-1][:, None], tc)
        jlog, tlog = jlog[:, 0], tlog[:, 0]
    np.testing.assert_array_equal(np.stack(tt), np.stack(jt))
    _caches_close(tc, jc, "f32")


def test_hymba_past_its_window_matches_jax():
    """hymba's window (64 on SMOKE): a 70-token prompt keeps its last 64
    keys on their ring slots beside the SSM states, and decoding on
    matches JAX (f32)."""
    jcfg, tcfg, jp, tp = _models("hymba-1.5b")
    x = _tokens(jcfg, 1, 74, seed=7)
    jlog, jc = jlm.prefill(jp, jcfg, jnp.asarray(x[:, :70]), max_len=96)
    tlog, tc = tlm.prefill(tp, tcfg, x[:, :70], max_len=96)
    assert tc.k.shape[2] == jc.k.shape[2] == 64
    _caches_close(tc, jc, "f32")
    step = jax.jit(lambda t, c: jlm.decode_step(jp, jcfg, t, c))
    for i in range(70, 74):
        jlog, jc = step(jnp.asarray(x[:, i:i + 1]), jc)
        tlog, tc = tlm.decode_step(tp, tcfg, x[:, i:i + 1], tc)
        _close(tlog, jlog, "f32", f"decode {i}")
    _caches_close(tc, jc, "f32")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """prefill + one decode step == the full forward at that position in
    bf16, within the JAX contract (`tests/test_models_zoo.py`): 0.08 x
    scale where MLA decodes through the absorbed weights or an SSM steps
    in f32, else 1e-3 x scale + 1e-4."""
    _, cfg = _cfgs(arch, "bf16")
    params = tlm.init_params(0, cfg, device="cpu")
    s = 24
    seq = _tokens(cfg, 2, s + 1, seed=3)
    full, _ = tlm.forward(params, cfg, seq)
    _, cache = tlm.prefill(params, cfg, seq[:, :s], max_len=s + 4)
    dl, _ = tlm.decode_step(params, cfg, seq[:, s:s + 1], cache)
    scale = float(full[:, s].float().abs().max()) + 1e-6
    err = float((dl[:, 0].float() - full[:, s].float()).abs().max())
    tol = 0.08 * scale if (cfg.mla or cfg.ssm or cfg.hybrid) \
        else 1e-3 * scale + 1e-4
    assert err <= tol, (err, scale)
