"""DeepSeek-V3 as published, on the port (`repro_torch.models.{layers,lm}`,
`configs.deepseek_v3.PUBLISHED_SMOKE` in f32), against the plain reference
(`bench/reference/deepseek_v3.py`, the copy frozen with the benchmark), on
the CPU.

What is held:
  * `lm.features` equals the reference's features within 1e-5 relative
    (f32 products summed in other orders, a few ulp an op), with every MoE
    layer's routing ids identical.
  * `prefill` then `decode_step` (the weight-absorbed MLA over the
    compressed cache) equal the reference's full forward on logits within
    1e-5 relative to their scale.
  * The group-limited router against a brute-force one over every way of
    keeping groups: ties to the lower id, the bias choosing but not
    weighting, the weights renormalised times 2.5.
  * YaRN's inverse frequencies and the softmax scale against the closed
    form of the published values.
  * Dropless routing past 4,096 tokens under skewed routing, and the
    capacity rule dropping there.
  * The expert share: on one MoE layer, what every chip's share computes,
    the shared expert counted once, adds up to the uncut reference layer.
  * The analytic parameter counts of the published model.
  * `HybridClassifier` hands token ids over as integers and frames as
    float32, as before.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch
from _torch_parity import to_np  # noqa: F401  (one torch thread per worker)

from bench.reference import deepseek_v3 as R
from repro_torch.configs import deepseek_v3 as D
from repro_torch.core import hybrid
from repro_torch.models import layers as tL
from repro_torch.models import lm as tlm

CFG = dataclasses.replace(D.PUBLISHED_SMOKE, dtype=torch.float32)
UNCUT = dataclasses.replace(CFG, experts_held=0)
REL = 1e-5


def ref_cfg(cfg: tlm.ArchConfig) -> dict:
    """The reference's configuration (config.json's keys) of ``cfg``."""
    y = cfg.yarn
    return {
        "hidden_size": cfg.d_model, "num_attention_heads": cfg.n_heads,
        "q_lora_rank": cfg.q_lora_rank, "kv_lora_rank": cfg.kv_lora_rank,
        "qk_nope_head_dim": cfg.qk_nope_dim,
        "qk_rope_head_dim": cfg.qk_rope_dim, "v_head_dim": cfg.v_head_dim,
        "first_k_dense_replace": cfg.first_k_dense,
        "n_routed_experts": cfg.n_held, "router_experts": cfg.n_experts,
        "expert_offset": cfg.expert_offset,
        "num_experts_per_tok": cfg.top_k, "n_group": cfg.n_group,
        "topk_group": cfg.topk_group, "norm_topk_prob": True,
        "routed_scaling_factor": cfg.routed_scaling_factor,
        "rms_norm_eps": 1e-6, "rope_theta": cfg.rope_theta,
        "rope_scaling": {
            "type": "yarn", "factor": y.factor,
            "original_max_position_embeddings": y.original_max,
            "beta_fast": y.beta_fast, "beta_slow": y.beta_slow,
            "mscale": y.mscale, "mscale_all_dim": y.mscale_all_dim}}


def ref_layer(layer: tlm.Layer, cfg: tlm.ArchConfig) -> dict:
    a, nope, rope = layer.attn, cfg.qk_nope_dim, cfg.qk_rope_dim
    lw = {"attn_norm": layer.ln1.scale, "q_a": a.q_a.w,
          "q_a_norm": a.q_a_norm.scale,
          "q_b": R.interleave_rope_columns(a.q_b.w, nope + rope, rope),
          "kv_a": R.interleave_rope_columns(
              a.kv_a.w, cfg.kv_lora_rank + rope, rope),
          "kv_a_norm": a.kv_a_norm.scale, "kv_b": a.kv_b.w, "o": a.o.w,
          "ffn_norm": layer.ln2.scale}
    if layer.moe is None:
        lw.update(gate=layer.mlp.gate.w, up=layer.mlp.up.w,
                  down=layer.mlp.down.w)
    else:
        m = layer.moe
        lw.update(router=m.router.w, bias=m.bias, experts_gate=m.gate,
                  experts_up=m.up, experts_down=m.down,
                  shared_gate=m.shared.gate.w, shared_up=m.shared.up.w,
                  shared_down=m.shared.down.w)
    return lw


def ref_weights(model: tlm.LM, cfg: tlm.ArchConfig) -> dict:
    return {"embed": model.embed, "final_norm": model.final_norm.scale,
            "unembed": model.unembed.w,
            "layers": [ref_layer(layer, cfg) for layer in model.layers]}


def model_of(cfg, seed=0, bias_std=0.05):
    """Seeded weights with a drawn score-correction bias (zero at init)."""
    g = torch.Generator().manual_seed(seed)
    model = tlm.init_params(g, cfg, device="cpu")
    for layer in model.layers:
        if layer.moe is not None:
            layer.moe.bias.copy_(bias_std * torch.randn(
                layer.moe.bias.shape, generator=g))
    return model


def tokens(cfg, b, s, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32))


def port_routes(fn):
    """``fn()`` with the port's routing ids recorded, one (T, k) a call."""
    orig, got = tL.route, []

    def rec(*args, **kw):
        out = orig(*args, **kw)
        got.append(out[3])
        return out

    tL.route = rec
    try:
        return fn(), got
    finally:
        tL.route = orig


@pytest.mark.parametrize("seed", [0, 1])
def test_features_match_reference(seed):
    model, x = model_of(CFG, seed), tokens(CFG, 2, 24, seed)
    counts = tL.MoECounts()
    got, routes = port_routes(
        lambda: tlm.features(model, CFG, x, counts=counts))
    assert got.shape == (2, CFG.d_model) and got.dtype == torch.float32
    w, rc = ref_weights(model, CFG), ref_cfg(CFG)
    n_moe = CFG.n_moe_layers
    for i in range(2):
        want_routes = []
        want = R.features(w, rc, x[i], R.FLOAT32, want_routes)
        err = float((got[i] - want).norm() / want.norm())
        assert err <= REL, err
        for j, ids in enumerate(want_routes):
            t = x.shape[1]
            assert torch.equal(routes[j][i * t:(i + 1) * t], ids)
    assert len(routes) == n_moe
    # every slot sent to a held expert was computed, none dropped
    held = sum(int(((r >= 0) & (r < CFG.n_held)).sum()) for r in routes)
    assert counts.held_rows == held and counts.dropped_slots == 0
    assert len(counts.calls) == n_moe


def test_features_never_read_the_unembedding():
    model, x = model_of(CFG), tokens(CFG, 1, 8)
    want = tlm.features(model, CFG, x)
    model.unembed.w.data = torch.full_like(model.unembed.w, float("nan"))
    assert torch.equal(tlm.features(model, CFG, x), want)


def test_prefill_and_decode_match_reference_logits():
    model, x = model_of(UNCUT, 3), tokens(UNCUT, 2, 20, 3)
    s, steps = 16, 4
    w, rc = ref_weights(model, UNCUT), ref_cfg(UNCUT)
    last, cache = tlm.prefill(model, UNCUT, x[:, :s], max_len=s + steps)
    got = [last]
    for t in range(steps - 1):
        out, cache = tlm.decode_step(model, UNCUT, x[:, s + t:s + t + 1],
                                     cache)
        got.append(out[:, 0])
    for i in range(2):
        want = R.logits(w, rc, x[i, :s + steps - 1], R.FLOAT32)
        for t, g in enumerate(got):
            ref = want[s - 1 + t]
            err = float((g[i] - ref).abs().max() / ref.abs().max())
            assert err <= REL, (i, t, err)


def brute_force_route(scores, bias, top_k, n_group, topk_group, scale):
    """The router by enumeration: for each token, every set of
    ``topk_group`` groups; the set whose groups' two best biased scores
    sum highest (ties to the set of lower group ids), then the ``top_k``
    biased scores within it, ties to the lower id."""
    import itertools

    t, e = scores.shape
    size = e // n_group
    ids_out, w_out = [], []
    for row in range(t):
        c = [np.float32(scores[row, j]) + np.float32(bias[j])
             for j in range(e)]
        gs = []
        for g in range(n_group):
            best = sorted(c[g * size:(g + 1) * size], reverse=True)
            gs.append(np.float32(best[0]) + np.float32(best[1]))
        # the kept groups: ranked by score, then by lower group id
        ranked = sorted(range(n_group), key=lambda g: (-gs[g], g))
        kept = set(ranked[:topk_group])
        assert kept in [set(s) for s in itertools.combinations(
            range(n_group), topk_group)]
        cands = [j for j in range(e) if j // size in kept]
        ids = sorted(cands, key=lambda j: (-c[j], j))[:top_k]
        w = np.array([float(scores[row, j]) for j in ids])
        ids_out.append(ids)
        w_out.append(w / w.sum() * scale)
    return np.array(ids_out), np.array(w_out)


def _router(e, bias):
    """A router over ``e`` experts whose logits are its (T, e) input."""
    moe = tL.moe_init(torch.Generator().manual_seed(0), e, 2, e, 0, 2,
                      dtype=torch.float32, bias=True)
    moe.router.w.data = torch.eye(e)
    moe.bias.copy_(bias)
    return moe


def test_group_router_against_brute_force():
    e, n_group, topk_group, top_k = 16, 4, 2, 4
    g = torch.Generator().manual_seed(5)
    # logits with ties: one row of equal logits, and repeated values
    logits = torch.randn((12, e), generator=g)
    logits[0] = 0.5
    logits[1, ::2] = logits[1, 1::2]
    logits[2, :4] = logits[2, 8:12]
    bias = 0.2 * torch.randn((e,), generator=g)
    bias[4:8] = 0.0
    moe, x = _router(e, bias), logits
    _, scores, w, ids = tL.route(
        moe, x, top_k, "sigmoid_group", n_group=n_group,
        topk_group=topk_group, scale=2.5)
    want_ids, want_w = brute_force_route(scores, bias, top_k, n_group,
                                         topk_group, 2.5)
    assert np.array_equal(ids.numpy(), want_ids)
    np.testing.assert_allclose(w.numpy(), want_w, rtol=1e-6)
    # all scores tied and no bias: groups 0 and 1, experts 0-3
    _, _, _, tied = tL.route(_router(e, torch.zeros(e)), x[:1], top_k,
                             "sigmoid_group", n_group=n_group,
                             topk_group=topk_group, scale=2.5)
    assert tied[0].tolist() == [0, 1, 2, 3]


def test_bias_chooses_but_does_not_weight():
    e = 16
    x = torch.linspace(-1, 1, e)[None]
    plain = _router(e, torch.zeros(e))
    _, scores, w0, ids0 = tL.route(plain, x, 4, "sigmoid_group", n_group=1,
                                   topk_group=1, scale=1.0)
    assert sorted(ids0[0].tolist()) == [12, 13, 14, 15]
    # a bias that lifts the four lowest experts over the rest
    biased = _router(e, torch.cat([torch.ones(4), torch.zeros(e - 4)]))
    _, scores_b, w1, ids1 = tL.route(biased, x, 4, "sigmoid_group",
                                     n_group=1, topk_group=1, scale=2.5)
    assert torch.equal(scores_b, scores)  # the bias is no part of a score
    assert sorted(ids1[0].tolist()) == [0, 1, 2, 3]
    want = scores[0, ids1[0]] / scores[0, ids1[0]].sum() * 2.5
    torch.testing.assert_close(w1[0], want, rtol=1e-6, atol=0)
    assert math.isclose(float(w1.sum()), 2.5, rel_tol=1e-6)


def test_yarn_frequencies_and_scale_closed_form():
    cfg = D.PUBLISHED
    y = cfg.yarn
    assert tL.yarn_ramp(64, cfg.rope_theta, y) == (10, 23)
    for beta, want in ((32, 10), (1, 23)):
        raw = 64 * math.log(4096 / (beta * 2 * math.pi)) / (
            2 * math.log(10000))
        assert (math.floor(raw) if beta == 32 else math.ceil(raw)) == want
    got = tL.rope_freqs(64, cfg.rope_theta, device="cpu", yarn=y).double()
    i = np.arange(32)
    extra = 10000.0 ** (-2 * i / 64)
    m = 1 - np.clip((i - 10) / (23 - 10), 0, 1)
    want = extra / 40 * (1 - m) + extra * m
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6)
    scale = 192 ** -0.5 * (0.1 * math.log(40) + 1) ** 2
    assert math.isclose(cfg.softmax_scale, scale, rel_tol=1e-12)
    assert abs(scale - 0.135234) < 1e-6
    assert math.isclose(R.softmax_scale(ref_cfg(cfg)), scale, rel_tol=1e-12)
    torch.testing.assert_close(R.yarn_inv_freq(ref_cfg(cfg)),
                               got.float(), rtol=0, atol=0)
    # cos and sin are not scaled (mscale / mscale_all_dim = 1)
    pos = torch.arange(8)[None]
    cos, sin = tL.rope_tables(pos, 64, cfg.rope_theta, y)
    torch.testing.assert_close(cos, torch.cos(pos[..., None].float()
                                              * got.float()))


def _skewed_moe(cfg, t, seed=0):
    """(layer, x (1, t, d)): routing skewed onto expert 0 and its
    group."""
    g = torch.Generator().manual_seed(seed)
    moe = tL.moe_init(g, cfg.d_model, cfg.d_ff_expert, cfg.n_experts,
                      cfg.n_shared_experts, cfg.d_ff_expert,
                      dtype=torch.float32, n_held=cfg.n_held, bias=True)
    moe.router.w.data[:, 0] += 0.5  # most tokens rank expert 0 first
    x = torch.randn((1, t, cfg.d_model), generator=g).abs()
    return moe, x


def test_dropless_past_4096_tokens_under_skewed_routing():
    t = 4608
    moe, x = _skewed_moe(CFG, t)
    kw = dict(top_k=CFG.top_k, router_type=CFG.router_type,
              n_group=CFG.n_group, topk_group=CFG.topk_group,
              routed_scale=CFG.routed_scaling_factor)
    counts = tL.MoECounts()
    _, routes = port_routes(lambda: tL.moe(moe, x, dropless=True,
                                           counts=counts, **kw))
    ids = routes[0]
    per_expert = torch.bincount(ids.reshape(-1), minlength=CFG.n_experts)
    assert int(per_expert[0]) > tL.capacity(t, CFG.top_k, CFG.n_experts,
                                            CFG.capacity_factor)
    assert counts.dropped_slots == 0
    assert counts.calls == [per_expert[:CFG.n_held].tolist()]
    assert counts.held_rows == int(per_expert[:CFG.n_held].sum())
    # the capacity rule drops there, and the dropless layer differs
    capped = tL.MoECounts()
    tL.moe(moe, x, counts=capped, **kw)
    assert capped.dropped_slots > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_shares_add_up_to_the_uncut_layer(seed):
    """Each chip holds 4 of the 16 experts; what the four shares compute
    alone, with the shared expert (which every chip computes) counted
    once, is the uncut reference layer's output."""
    uncut = model_of(UNCUT, seed)
    layer = uncut.layers[CFG.first_k_dense]
    x = torch.randn((1, 24, CFG.d_model),
                    generator=torch.Generator().manual_seed(seed))
    shared = tL.mlp(layer.moe.shared, x)
    total = shared.clone()
    held = CFG.n_held
    for lo in range(0, CFG.n_experts, held):
        m = layer.moe
        part = tL.MoE(m.router, m.gate[lo:lo + held], m.up[lo:lo + held],
                      m.down[lo:lo + held], m.shared, m.bias)
        y, _ = tL.moe(part, x, top_k=CFG.top_k, router_type=CFG.router_type,
                      n_group=CFG.n_group, topk_group=CFG.topk_group,
                      routed_scale=CFG.routed_scaling_factor,
                      expert_offset=lo, dropless=True)
        total = total + (y - shared)
    lw = ref_layer(layer, UNCUT)
    want = R.moe(lw, x[0], ref_cfg(UNCUT), R.FLOAT32)
    err = float((total[0] - want).abs().max() / want.abs().max())
    assert err <= REL, err


def test_shard_map_impl_routes_as_the_published_router():
    """``moe_impl="shard_map"`` takes `moe`'s router options: with no mesh
    the features, routing and counters are `moe`'s exactly; under a
    forced 1x2 mesh the uncut model's experts, cut over "model", give the
    reference's features with its routing; a held share there raises."""
    from repro_torch.distributed import context, forcemesh

    context.clear()  # an earlier test's service may have installed a mesh
    x = tokens(CFG, 2, 24, 3)
    sm = dataclasses.replace(CFG, moe_impl="shard_map")
    model = model_of(CFG, 3)
    c_sm, c_moe = tL.MoECounts(), tL.MoECounts()
    got, got_routes = port_routes(
        lambda: tlm.features(model, sm, x, counts=c_sm))
    want, want_routes = port_routes(
        lambda: tlm.features(model, CFG, x, counts=c_moe))
    assert torch.equal(got, want) and c_sm == c_moe and c_sm.held_rows
    assert all(torch.equal(a, b) for a, b in zip(got_routes, want_routes))
    uncut = model_of(UNCUT, 3)
    w, rc = ref_weights(uncut, UNCUT), ref_cfg(UNCUT)
    forcemesh.install((1, 2), device="cpu")
    try:
        got, routes = port_routes(lambda: tlm.features(
            uncut, dataclasses.replace(UNCUT, moe_impl="shard_map"), x))
        with pytest.raises(ValueError, match="holding 4"):
            tlm.features(model, sm, x)
    finally:
        context.clear()
    for i in range(2):
        want_routes = []
        want = R.features(w, rc, x[i], R.FLOAT32, want_routes)
        assert float((got[i] - want).norm() / want.norm()) <= REL
        for j, ids in enumerate(want_routes):
            assert torch.equal(torch.sort(routes[j].view(2, 24, -1)[i]).values,
                               torch.sort(ids).values)


def test_the_held_experts_alone_are_drawn():
    model = tlm.init_params(0, dataclasses.replace(
        D.PUBLISHED, n_layers=4, experts_held=8), device="meta")
    dense, moe = model.layers[0], model.layers[3]
    assert dense.moe is None and dense.mlp.gate.w.shape == (7168, 18432)
    assert moe.moe.gate.shape == (8, 7168, 2048)
    assert moe.moe.router.w.shape == (7168, 256)
    assert moe.moe.bias.shape == (256,)
    n = sum(p.numel() for p in model.parameters())
    norms = sum(p.numel() for name, p in model.named_parameters()
                if name.endswith("scale"))
    cfg = dataclasses.replace(D.PUBLISHED, n_layers=4, experts_held=8)
    assert n - norms == cfg.param_count()


def test_published_parameter_counts():
    cfg = D.PUBLISHED
    total, active = cfg.param_count(), cfg.active_param_count()
    assert abs(total / 671e9 - 1) <= 0.005, total
    assert round(total / 1e9, 1) == 671.0
    assert abs(active / 37e9 - 1) <= 0.02, active
    assert round(active / 1e9, 2) == 37.55
    # one chip's share at 7 of 61 layers: the benchmark's configuration
    share = dataclasses.replace(cfg, n_layers=7, experts_held=8)
    assert round(share.param_count() / 1e9, 2) == 5.94
    # the registry's configs keep the JAX package's counts
    assert D.CONFIG.param_count() == 703_796_805_632


def test_integer_inputs_reach_the_front_end_as_integers():
    seen = []

    def fn(params, x):
        seen.append(x.dtype)
        return torch.stack([x.float().mean(dim=1), -x.float().mean(dim=1)],
                           dim=1)

    ids = np.array([[1, 2, 3], [7, 8, 9], [4, 4, 4], [9, 9, 9]],
                   dtype=np.int32)
    head = hybrid.fit_acam_head(fn, None, ids, np.array([0, 1, 0, 1]), 2,
                                device="cpu")
    clf = hybrid.HybridClassifier(None, fn, head, device="cpu")
    clf.predict(ids)
    clf.predict(torch.from_numpy(ids).long())
    assert seen == [torch.int32, torch.int32, torch.int64]


def test_frame_predictions_unchanged():
    """Float frames reach the front end as float32, the predictions equal
    those of frames cast by hand."""
    from repro_torch.models import cnn

    model = cnn.init_student(torch.Generator().manual_seed(0),
                             cnn.StudentConfig(), device="cpu").eval()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 32, 32, 1))  # float64 frames
    y = np.arange(64) % 10
    head = hybrid.fit_acam_head(cnn.student_features, model, x, y, 10,
                                k=2, device="cpu")
    clf = hybrid.HybridClassifier(model, cnn.student_features, head,
                                  device="cpu")
    got = clf.predict(x)
    by_hand = cnn.student_features(model, torch.as_tensor(x,
                                                          dtype=torch.float32))
    want, _ = head(by_hand)
    assert torch.equal(got, want)
    assert torch.equal(got, clf.predict(x.astype(np.float32)))
