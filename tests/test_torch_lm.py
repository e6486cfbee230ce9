"""The port's LM (`repro_torch.models.{layers,lm}`, `repro_torch.configs`)
against the JAX package's, on the CPU.

The same JAX-initialised weights (carried by `convert.lm_params_from_numpy`)
and the same numpy inputs go through both packages' layers, `forward`,
`prefill` and `decode_step`, on the SMOKE configs of the six
architectures the port covers: tinyllama (GQA), qwen3 (qk-norm), qwen2.5
(QKV bias), qwen2-vl (M-RoPE, embeddings as input), hubert (encoder-only,
prefill) and tinyllama with a sliding window (the ring-buffer cache).

Tolerances:
  * f32 (the SMOKE config with ``dtype=float32``): ``rtol=1e-5, atol=1e-5``
    on logits and caches, and identical greedy tokens. The packages sum the
    same f32 products in other orders (and XLA contracts some products into
    FMAs), a few ulp per op.
  * bf16, one op (the norms, rope, M-RoPE, linear, the MLP, decode
    attention): every element bitwise equal to the JAX value or one bf16
    ulp from it. Each op rounds to bf16 where the JAX op does, so only a
    rounding boundary between the two packages' f32 results can part them;
    a wrong cast order (rmsnorm's scale in f32, rope in bf16) moves
    elements by more.
  * bf16, the model (logits and caches of `forward`, `prefill`,
    `decode_step`): ``|diff| <= 2**-5 * max|ref|``. A one-ulp difference
    (2**-8 relative) feeds two layers, the final norm and the
    unembedding. Measured: at most 1.1% of the logits' scale.

The JAX package's own decode contracts (`tests/test_lm_decode.py`,
`tests/test_models_zoo.py`) are ported as port-only tests, the analytic
parameter counts equal the JAX ones for all ten configs, and all ten
build, prefill and decode on the CPU. The MoE, MLA, SSM and hybrid
families are held against JAX in `tests/test_torch_lm_families.py`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_np
from repro import configs as jconfigs
from repro.models import layers as jL
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import layers as tL
from repro_torch.models import lm as tlm

ARCHS = ("tinyllama-1.1b", "qwen3-1.7b", "qwen2.5-14b", "qwen2-vl-72b",
         "hubert-xlarge", "tinyllama-window")
BF16_REL = 2.0 ** -5


def _cfgs(arch, dtype="f32"):
    name = "tinyllama-1.1b" if arch == "tinyllama-window" else arch
    jcfg, tcfg = jconfigs.get(name, smoke=True), tconfigs.get(name,
                                                              smoke=True)
    if arch == "tinyllama-window":
        jcfg = dataclasses.replace(jcfg, sliding_window=8)
        tcfg = dataclasses.replace(tcfg, sliding_window=8)
    if dtype == "f32":
        jcfg = dataclasses.replace(jcfg, dtype=jnp.float32)
        tcfg = dataclasses.replace(tcfg, dtype=torch.float32)
    return jcfg, tcfg


def _models(arch, dtype="f32", seed=0):
    jcfg, tcfg = _cfgs(arch, dtype)
    jp = jlm.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                      device="cpu")
    return jcfg, tcfg, jp, tp


def _inputs(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "tokens":
        return rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    return rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)


def _f32(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


def _close(got, want, dtype):
    got, want = _f32(got), _f32(np.asarray(jnp.asarray(want, jnp.float32)))
    assert got.shape == want.shape
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        err = np.abs(got - want).max()
        assert err <= BF16_REL * np.abs(want).max(), err


def _bf16_steps(x) -> np.ndarray:
    """bf16 values as integers in value order: adjacent bf16 numbers are
    one apart, and -0 and +0 are both 0."""
    bits = (x.view(torch.int16).numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x).view(np.int16)).astype(np.int32)
    return np.where(bits < 0, -(bits & 0x7FFF), bits)


def _op_close(got, want, dtype):
    """One op: f32 as `_close`; bf16 elementwise within one bf16 ulp."""
    if dtype == "f32":
        return _close(got, want, dtype)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert tuple(got.shape) == want.shape
    ulps = np.abs(_bf16_steps(got) - _bf16_steps(want))
    assert ulps.max() <= 1, (ulps.max(), (ulps > 1).sum())


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_norms_match_jax(dtype):
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 48)).astype(np.float32) * 3
    scale = rng.standard_normal(48).astype(np.float32)
    bias = rng.standard_normal(48).astype(np.float32)
    tn = tL.rmsnorm_init(48, device="cpu")
    tn.scale.data = torch.from_numpy(scale)
    _op_close(tL.rmsnorm(tn, torch.from_numpy(x).to(tdt)),
           jL.rmsnorm({"scale": jnp.asarray(scale)},
                      jnp.asarray(x).astype(jdt)), dtype)
    ln = tL.layernorm_init(48, device="cpu")
    ln.scale.data, ln.bias.data = torch.from_numpy(scale), \
        torch.from_numpy(bias)
    _op_close(tL.layernorm(ln, torch.from_numpy(x).to(tdt)),
           jL.layernorm({"scale": jnp.asarray(scale),
                         "bias": jnp.asarray(bias)},
                        jnp.asarray(x).astype(jdt)), dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("theta", [10000.0, 1_000_000.0])
def test_rope_matches_jax(dtype, theta):
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 7)).astype(np.int32)
    np.testing.assert_allclose(to_np(tL.rope_freqs(32, theta, device="cpu")),
                               np.asarray(jL.rope_freqs(32, theta)),
                               rtol=1e-6)
    for got, want in zip(tL.rope_tables(torch.from_numpy(pos), 32, theta),
                         jL.rope_tables(jnp.asarray(pos), 32, theta)):
        np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    tx, jx = torch.from_numpy(x).to(tdt), jnp.asarray(x).astype(jdt)
    _op_close(tL.apply_rope(tx, torch.from_numpy(pos), theta),
           jL.apply_rope(jx, jnp.asarray(pos), theta), dtype)
    tabs = tL.rope_tables(torch.from_numpy(pos), 32, theta)
    _op_close(tL.apply_rope(tx, torch.from_numpy(pos), theta, tables=tabs),
           jL.apply_rope(jx, jnp.asarray(pos), theta), dtype)
    pos3 = rng.integers(0, 300, (3, 2, 7)).astype(np.int32)
    _op_close(tL.apply_mrope(tx, torch.from_numpy(pos3), theta, (4, 6, 6)),
           jL.apply_mrope(jx, jnp.asarray(pos3), theta, (4, 6, 6)), dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bias", [False, True])
def test_linear_and_mlp_match_jax(dtype, bias):
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 24)).astype(np.float32)
    w = [rng.standard_normal(s).astype(np.float32) * 0.2
         for s in ((24, 40), (24, 40), (40, 24))]
    b = rng.standard_normal(40).astype(np.float32)
    jp = {"w": jnp.asarray(w[0]).astype(jdt)}
    if bias:
        jp["b"] = jnp.asarray(b).astype(jdt)
    tp = tL.Linear(torch.from_numpy(w[0]).to(tdt),
                   torch.from_numpy(b).to(tdt) if bias else None)
    tx, jx = torch.from_numpy(x).to(tdt), jnp.asarray(x).astype(jdt)
    _op_close(tL.linear(tp, tx), jL.linear(jp, jx), dtype)
    jm = {k: {"w": jnp.asarray(a).astype(jdt)}
          for k, a in zip(("gate", "up", "down"), w)}
    tm = tL.MLP(*(tL.Linear(torch.from_numpy(a).to(tdt)) for a in w))
    _op_close(tL.mlp(tm, tx), jL.mlp(jm, jx), dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("heads,kv,cur", [(8, 2, 5), (4, 4, 16), (6, 1, 1)])
def test_decode_attention_matches_jax(dtype, heads, kv, cur):
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    rng = np.random.default_rng(heads + kv + cur)
    q = rng.standard_normal((2, 1, heads, 16)).astype(np.float32)
    k = rng.standard_normal((2, 16, kv, 16)).astype(np.float32)
    v = rng.standard_normal((2, 16, kv, 16)).astype(np.float32)
    got = tL.decode_attention(*(torch.from_numpy(a).to(tdt)
                                for a in (q, k, v)), cur)
    want = jL.decode_attention(*(jnp.asarray(a).astype(jdt)
                                 for a in (q, k, v)), jnp.int32(cur))
    assert got.dtype == tdt
    _op_close(got, want, dtype)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_jax(arch, dtype):
    jcfg, tcfg, jp, tp = _models(arch, dtype)
    s = 12
    x = _inputs(jcfg, 2, s + 1)
    jl, _ = jlm.forward(jp, jcfg, jnp.asarray(x))
    tl, aux = tlm.forward(tp, tcfg, x)
    _close(tl, jl, dtype)
    assert float(aux) == 0.0
    jpl, jc = jlm.prefill(jp, jcfg, jnp.asarray(x[:, :s]), max_len=s + 4)
    tpl, tc = tlm.prefill(tp, tcfg, x[:, :s], max_len=s + 4)
    _close(tpl, jpl, dtype)
    _close(tc.k, jc.k, dtype)
    _close(tc.v, jc.v, dtype)
    assert tc.length == int(jc.length) == s
    if not jcfg.causal:
        return
    jd, jc2 = jlm.decode_step(jp, jcfg, jnp.asarray(x[:, s:s + 1]), jc)
    td, tc2 = tlm.decode_step(tp, tcfg, x[:, s:s + 1], tc)
    _close(td, jd, dtype)
    _close(tc2.k, jc2.k, dtype)
    _close(tc2.v, jc2.v, dtype)
    assert tc2.length == int(jc2.length) == s + 1


@pytest.mark.parametrize("arch", [a for a in ARCHS if a != "hubert-xlarge"])
def test_greedy_tokens_match_jax(arch):
    """f32: eight greedy steps from a prefill give the same tokens (token
    configs feed their own argmax back; embedding configs feed the same
    random embeddings)."""
    jcfg, tcfg, jp, tp = _models(arch)
    x = _inputs(jcfg, 2, 10, seed=5)
    feed = _inputs(jcfg, 2, 8, seed=6)
    jlog, jc = jlm.prefill(jp, jcfg, jnp.asarray(x), max_len=24)
    tlog, tc = tlm.prefill(tp, tcfg, x, max_len=24)
    jt, tt = [], []
    for i in range(8):
        jt.append(np.asarray(jnp.argmax(jlog, -1)))
        tt.append(to_np(torch.argmax(tlog, -1)))
        if jcfg.input_mode == "tokens":
            jin, tin = jt[-1][:, None], tt[-1][:, None]
        else:
            jin = tin = feed[:, i:i + 1]
        jlog, jc = jlm.decode_step(jp, jcfg, jnp.asarray(jin), jc)
        tlog, tc = tlm.decode_step(tp, tcfg, tin, tc)
        jlog, tlog = jlog[:, 0], tlog[:, 0]
    np.testing.assert_array_equal(np.stack(tt), np.stack(jt))


def test_sliding_window_ring_matches_jax_past_the_window():
    """A prompt longer than the window lays its last w keys on their ring
    slots; decoding past the window keeps matching JAX (f32)."""
    jcfg, tcfg, jp, tp = _models("tinyllama-window")
    x = _inputs(jcfg, 1, 20, seed=7)
    jlog, jc = jlm.prefill(jp, jcfg, jnp.asarray(x[:, :13]), max_len=32)
    tlog, tc = tlm.prefill(tp, tcfg, x[:, :13], max_len=32)
    assert tc.k.shape[2] == jc.k.shape[2] == 8
    _close(tc.k, jc.k, "f32")
    for i in range(13, 20):
        jlog, jc = jlm.decode_step(jp, jcfg, jnp.asarray(x[:, i:i + 1]), jc)
        tlog, tc = tlm.decode_step(tp, tcfg, x[:, i:i + 1], tc)
        _close(tlog, jlog, "f32")
    _close(tc.k, jc.k, "f32")


def test_precompute_rope_is_the_same_model():
    jcfg, tcfg, jp, tp = _models("qwen3-1.7b")
    x = _inputs(jcfg, 2, 9)
    want, _ = tlm.forward(tp, tcfg, x)
    got, _ = tlm.forward(tp, dataclasses.replace(tcfg, precompute_rope=True),
                         x)
    np.testing.assert_array_equal(to_np(got), to_np(want))


# ---------------------------------------------------------------------------
# the JAX package's decode contracts, on the port alone
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    cfg = tconfigs.get("tinyllama-1.1b", smoke=True)
    return cfg, tlm.init_params(0, cfg, device="cpu")


def test_prefill_matches_step_by_step_decode(tiny):
    cfg, params = tiny
    prompt = np.random.RandomState(0).randint(0, cfg.vocab, size=12)
    full, _ = tlm.prefill(params, cfg, prompt[None, :], max_len=32)
    logits, cache = tlm.prefill(params, cfg, prompt[None, :1], max_len=32)
    for t in prompt[1:]:
        logits3, cache = tlm.decode_step(
            params, cfg, torch.full((1, 1), int(t)), cache)
        logits = logits3[:, 0]
    np.testing.assert_allclose(_f32(full), _f32(logits), rtol=2e-3,
                               atol=2e-3)


def test_parity_across_prefill_splits(tiny):
    cfg, params = tiny
    prompt = np.random.RandomState(1).randint(0, cfg.vocab, size=10)
    ref, _ = tlm.prefill(params, cfg, prompt[None, :], max_len=32)
    for split in (4, 7):
        logits, cache = tlm.prefill(params, cfg, prompt[None, :split],
                                    max_len=32)
        for t in prompt[split:]:
            logits3, cache = tlm.decode_step(
                params, cfg, torch.full((1, 1), int(t)), cache)
            logits = logits3[:, 0]
        assert int(torch.argmax(ref)) == int(torch.argmax(logits))


@pytest.mark.parametrize("arch", [a for a in ARCHS if a != "hubert-xlarge"])
def test_decode_matches_forward(arch):
    """prefill + one decode step (teacher forcing) == the full forward at
    that position, in bf16 (the JAX contract's 1e-3 x scale + 1e-4)."""
    _, cfg = _cfgs(arch, "bf16")
    params = tlm.init_params(0, cfg, device="cpu")
    s = 24
    seq = _inputs(cfg, 2, s + 1, seed=3)
    full, _ = tlm.forward(params, cfg, seq)
    _, cache = tlm.prefill(params, cfg, seq[:, :s], max_len=s + 4)
    dl, _ = tlm.decode_step(params, cfg, seq[:, s:s + 1], cache)
    scale = float(full[:, s].float().abs().max()) + 1e-6
    err = float((dl[:, 0].float() - full[:, s].float()).abs().max())
    assert err <= 1e-3 * scale + 1e-4, (err, scale)


def test_sliding_window_decode_past_the_window_matches_forward():
    """The ring buffer (window 8): decoding at position 20 matches the
    windowed full forward."""
    _, cfg = _cfgs("tinyllama-window", "bf16")
    params = tlm.init_params(1, cfg, device="cpu")
    s = 20
    seq = _inputs(cfg, 1, s + 1, seed=4)
    full, _ = tlm.forward(params, cfg, seq)
    _, cache = tlm.prefill(params, cfg, seq[:, :s], max_len=s + 4)
    dl, _ = tlm.decode_step(params, cfg, seq[:, s:s + 1], cache)
    scale = float(full[:, s].float().abs().max()) + 1e-6
    err = float((dl[:, 0].float() - full[:, s].float()).abs().max())
    assert err <= 1e-3 * scale + 1e-4, (err, scale)


def test_encoder_prefill_only():
    cfg = tconfigs.get("hubert-xlarge", smoke=True)
    params = tlm.init_params(0, cfg, device="cpu")
    x = np.random.default_rng(1).standard_normal(
        (2, 32, cfg.d_model)).astype(np.float32)
    logits, _ = tlm.prefill(params, cfg, x)
    assert logits.shape == (2, cfg.vocab) and logits.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# configs, init, and the layout still to come
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_param_counts_match_jax(arch):
    assert tconfigs.list_archs() == jconfigs.list_archs()
    for smoke in (False, True):
        j, t = jconfigs.get(arch, smoke), tconfigs.get(arch, smoke)
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()
        assert (t.name, t.family, t.n_layers, t.d_model, t.vocab) == \
            (j.name, j.family, j.n_layers, j.d_model, j.vocab)
    for alias in jconfigs.ALIASES:
        assert tconfigs.get(alias) == tconfigs.get(jconfigs.ALIASES[alias])


@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_every_config_builds_and_decodes(arch):
    """All ten SMOKE configs build, prefill and decode a step on the CPU:
    finite logits, the cache one token longer."""
    cfg = tconfigs.get(arch, smoke=True)
    params = tlm.init_params(0, cfg, device="cpu")
    x = _inputs(cfg, 2, 6, seed=8)
    logits, cache = tlm.prefill(params, cfg, x[:, :5], max_len=8)
    assert logits.shape == (2, cfg.vocab) and cache.length == 5
    step, cache = tlm.decode_step(params, cfg, x[:, 5:], cache)
    assert step.shape == (2, 1, cfg.vocab) and cache.length == 6
    assert bool(torch.isfinite(logits).all() and torch.isfinite(step).all())


def test_init_params_draws_the_jax_distributions():
    """Normal weights times din**-0.5, the embedding times 0.02, zero
    biases, unit norms; a function of the seed."""
    cfg = dataclasses.replace(tconfigs.get("qwen2.5-14b", smoke=True),
                              d_model=256, vocab=2048)
    p = tlm.init_params(0, cfg, device="cpu")
    again = tlm.init_params(0, cfg, device="cpu")
    other = tlm.init_params(1, cfg, device="cpu")
    for (name, a), b, c in zip(p.named_parameters(), again.parameters(),
                               other.parameters()):
        assert torch.equal(a, b), name
        assert a.dtype == (torch.float32 if name.endswith("scale")
                           else torch.bfloat16), name
        if name.endswith("scale"):
            assert torch.equal(a, torch.ones_like(a))
        elif name.endswith(".b"):
            assert not a.any()
        else:
            assert not torch.equal(a, c), name
            want = 0.02 if name == "embed" else a.shape[0] ** -0.5
            assert abs(float(a.float().std()) / want - 1) < 0.1, name
    assert p.embed.shape == (cfg.vocab, cfg.d_model)
    assert p.layers[0].attn.q.w.shape == (cfg.d_model,
                                          cfg.n_heads * cfg.head_dim)
    assert len(p.layers) == cfg.n_layers


def test_bf16_leaves_carry_their_bits():
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((5, 7)), jnp.bfloat16)
    got = convert._tensor(np.asarray(x))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(x.astype(jnp.float32)))
