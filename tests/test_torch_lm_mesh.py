"""The LM zoo on a mesh: the port's sharded step builders
(`repro_torch.launch.steps.build_{train,prefill,decode}_step`) and
`layers.moe_shardmap` against the JAX package's own sharded ones, on the
CPU: the dense, padded-head and expert-parallel MoE SMOKE configs here,
the MLA, SSM and hybrid families in `test_torch_lm_mesh_families.py`
(the JAX oracle and the tolerances: `_torch_mesh`). Also here:
`moe_shardmap` above 4096 tokens a data shard (slots dropped; f32 within
1e-5 and bf16 within 2^-5 of the scale, the aux loss 1e-5), the default
MoE's global drops under a mesh step, a 1x1 mesh against
`make_train_step`, the ZeRO-3 hooks, the stored blocks and the card
requirement.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_mesh import (MOE_S, TOL, check_serve_steps, check_train_step,
                         mesh24 as make_mesh24, start_oracle, tree)
from _torch_parity import to_np

from repro import configs as jconfigs
from repro.models import layers as jL
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.distributed import context, sharding
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import layers as tL
from repro_torch.models import lm as tlm

CASES = {
    "tinyllama": ("tinyllama-1.1b", {}),
    "qwen_pad": ("qwen2.5-14b", {"head_pad_multiple": 4}),
    "phi_sm": ("phi3.5-moe-42b-a6.6b", {"moe_impl": "shard_map"}),
}


@pytest.fixture(scope="module", autouse=True)
def _jax_job(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_lm_mesh") / "out.npz"
    return start_oracle(CASES, path, moe=True), path


@pytest.fixture(scope="module")
def jax_out(_jax_job):
    job, path = _jax_job
    job.result(timeout=900)
    return dict(np.load(path))


@pytest.fixture
def mesh24():
    yield make_mesh24()
    context.clear()


@pytest.mark.parametrize("name", CASES)
def test_train_step_matches_jaxs_sharded_step(name, jax_out, mesh24):
    check_train_step(jax_out, name, CASES, mesh24)


@pytest.mark.parametrize("name", CASES)
def test_prefill_and_decode_match_jaxs_sharded_steps(name, jax_out, mesh24):
    check_serve_steps(jax_out, name, CASES, mesh24)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_moe_shardmap_drops_the_slots_jax_drops(dt, jax_out, mesh24):
    """4608 tokens a data shard: the capacity is the capacity factor's
    (`layers.capacity` of T / dp), and most of expert 0's slots drop."""
    z = jax_out
    cfg = tconfigs.get("phi3.5-moe-42b-a6.6b", smoke=True)
    p_np = tree(z, f"moe_{dt}/p/")
    dtype = getattr(torch, dt)
    p = tL.MoE(tL.Linear(torch.from_numpy(p_np["router"]["w"])),
               *(convert._tensor(p_np[k]).to(dtype)
                 for k in ("gate", "up", "down")))
    x = torch.from_numpy(z[f"moe_{dt}/x"]).to(dtype)
    cap = tL.capacity(MOE_S, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
    _, _, _, ids = tL.route(p, x[:1].reshape(MOE_S, -1), cfg.top_k, "softmax")
    assert int((ids == 0).sum()) > cap  # expert 0 drops in shard 0
    y, aux = tL.moe_shardmap(p, x, top_k=cfg.top_k)
    want = z[f"moe_{dt}/y"]
    err = float(np.abs(to_np(y.float()) - want).max())
    tol = TOL if dt == "float32" else 2 ** -5
    assert err <= tol * float(np.abs(want).max())
    assert abs(float(aux) - float(z[f"moe_{dt}/aux"])) <= 1e-5 * float(
        z[f"moe_{dt}/aux"])
    # unsharded, the capacity is the whole batch's: other slots drop
    context.clear()
    y1, _ = tL.moe_shardmap(p, x, top_k=cfg.top_k)
    assert float((y1 - y).abs().max()) > 1e-3


def test_gspmd_moe_keeps_the_global_batchs_drops():
    """The default MoE under a mesh step is JAX's global function: with
    past 4096 tokens in all, each data coordinate keeps the slots of the
    global sort (the counts of the coordinates before it come first), as
    `jax` `layers.moe` on the whole batch does."""
    cfg = jconfigs.get("phi3.5-moe-42b-a6.6b", smoke=True)
    jp = jL.moe_init(jax.random.PRNGKey(5), cfg.d_model, cfg.d_ff_expert,
                     cfg.n_experts, 0, cfg.d_ff_expert, dtype=jnp.float32)
    jp["router"]["w"] = jp["router"]["w"].at[:, 0].add(0.5)
    x = np.array(jax.random.normal(jax.random.PRNGKey(6),
                                   (2, 2304, cfg.d_model)) + 1)
    want, want_aux = jL.moe(jp, jnp.asarray(x), top_k=cfg.top_k)
    p = tL.MoE(tL.Linear(torch.from_numpy(np.array(jp["router"]["w"]))),
               *(torch.from_numpy(np.array(jp[k]))
                 for k in ("gate", "up", "down")))
    p.layer = 0
    mesh = context.Mesh([["cpu"], ["cpu"]], ("data", "model"))
    prefix, ys = {}, []
    for i in range(2):
        shard = tsteps._shard(mesh, i, x.shape[0] * x.shape[1], prefix)
        with context.running(shard):
            y, _ = tL.moe(p, torch.from_numpy(x[i:i + 1]), top_k=cfg.top_k)
        tsteps._add_counts(prefix, shard)
        ys.append(y)
    got = torch.cat(ys)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))
    # alone, each half keeps its own first `cap` slots: not the same
    alone, _ = tL.moe(p, torch.from_numpy(x[1:2]), top_k=cfg.top_k)
    assert float((alone - ys[1]).abs().max()) > 1e-3
    assert np.isfinite(float(want_aux))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "phi3.5-moe-42b-a6.6b",
                                  "mamba2-2.7b", "qwen2-vl-72b",
                                  "hubert-xlarge"])
def test_a_1x1_mesh_gives_make_train_steps_result(arch):
    cfg = dataclasses.replace(tconfigs.get(arch, smoke=True),
                              dtype=torch.float32)
    batch = ttrain.synthetic_batch(cfg, 2, 16, 0, device="cpu")
    ref = tlm.init_params(0, cfg, device="cpu")
    mesh = tmesh.make_host_mesh("cpu")
    fn, in_specs, _, opt = tsteps.build_train_step(cfg, mesh)
    params = sharding.shard_model(ref, in_specs[0], mesh)
    state = opt.init(params)
    params, state, metrics = fn(params, state, batch)
    one = tsteps.make_optimizer(cfg)
    st = one.init(tsteps.cnn_trainer.params_of(ref))
    ref, st, _, loss = tsteps.make_train_step(cfg, one)(ref, st, None, batch)
    assert float(metrics["loss"]) == float(loss)
    got = sharding.sharded_tensors(params)
    for k, p in ref.named_parameters():
        assert torch.equal(got[k].full(), p.detach()), k
        assert torch.equal(state.mu[k].full(), st.mu[k]), k


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "hubert-xlarge"])
def test_embedding_inputs_on_a_2x2_mesh(arch):
    """Embeddings in (and qwen2-vl's M-RoPE positions, cut over data on
    axis 1): a 2x2 step within 1e-5 of the single-device step (loss and
    moments), the prefill logits within 1e-5 of the unsharded call's."""
    cfg = dataclasses.replace(tconfigs.get(arch, smoke=True),
                              dtype=torch.float32)
    batch = ttrain.synthetic_batch(cfg, 4, 16, 0, device="cpu")
    batch["inputs"] = batch["inputs"].float()
    ref = tlm.init_params(0, cfg, device="cpu")
    mesh = context.Mesh(np.full((2, 2), "cpu", dtype=object).tolist(),
                        ("data", "model"))
    fn, in_specs, _, opt = tsteps.build_train_step(cfg, mesh,
                                                   example_batch=batch)
    assert tuple(in_specs[2]["inputs"]) == ("data", None, None)
    params = sharding.shard_model(ref, in_specs[0], mesh)
    state = opt.init(params)
    params, state, metrics = fn(params, state, batch)
    one = tsteps.make_optimizer(cfg)
    st = one.init(tsteps.cnn_trainer.params_of(ref))
    pf, in_sp, _ = tsteps.build_prefill_step(
        cfg, mesh, example_args=(ref, batch["inputs"],
                                 *([batch["positions"]]
                                   if "positions" in batch else [])))
    want, _ = tlm.prefill(ref, cfg, batch["inputs"], batch.get("positions"))
    got, _ = pf(sharding.shard_model(ref, in_sp[0], mesh), batch["inputs"],
                batch.get("positions"))
    assert float((got.full() - want).abs().max()) <= TOL * float(
        want.abs().max())
    _, st, _, loss = tsteps.make_train_step(cfg, one)(ref, st, None, batch)
    assert abs(float(metrics["loss"]) - float(loss)) <= TOL * float(loss)
    for k, m in st.mu.items():
        assert float((state.mu[k].full() - m).abs().max()) <= TOL * float(
            m.abs().max()), k


def test_zero3_hooks_gather_to_the_tp_compute_specs():
    """fsdp_tp installs the layer and head hooks (storage -> "tp" specs,
    the same values); tp installs none; `context.clear` drops them."""
    cfg = tconfigs.get("tinyllama-1.1b", smoke=True)
    mesh = context.Mesh(np.full((2, 2), "cpu", dtype=object).tolist(),
                        ("data", "model"))
    model = tlm.init_params(0, cfg, device="cpu")
    store = sharding.shard_model(model, sharding.param_specs(
        cfg, mesh, "fsdp_tp"), mesh)
    compute = sharding.param_specs(cfg, mesh, "tp")
    sharding.register_zero3_constraints(cfg, mesh, "fsdp_tp")
    try:
        layer = context.constrain_layer(store.layers[1])
        q = layer.attn.q.w
        assert tuple(store.layers[1].attn.q.w.spec) == ("data", "model")
        assert tuple(q.spec) == tuple(compute["layers"]["attn"]["q"]["w"][1:])
        assert torch.equal(q.full(), model.layers[1].attn.q.w)
        head = context.constrain_head(tlm.Head(store.embed, store.unembed,
                                               store.final_norm))
        assert tuple(head.unembed.w.spec) == (None, "model")
        x = torch.ones(3)
        assert context.constrain(x, "dp", None) is x
        sharding.register_zero3_constraints(cfg, mesh, "tp")
        assert context.constrain_layer(store.layers[1]) is store.layers[1]
        sharding.register_zero3_constraints(cfg, mesh, "fsdp_tp")
    finally:
        context.clear()
    assert context.constrain_layer(store.layers[1]) is store.layers[1]


def test_block_storage_and_replicas_after_a_step(mesh24):
    """Each coordinate stores the block its spec gives it; copies stay
    equal after the update."""
    cfg = dataclasses.replace(tconfigs.get("tinyllama-1.1b", smoke=True),
                              dtype=torch.float32)
    fn, in_specs, _, opt = tsteps.build_train_step(cfg, mesh24, mode="tp")
    params = sharding.shard_model(tlm.init_params(0, cfg, device="cpu"),
                                  in_specs[0], mesh24)
    state = opt.init(params)
    params, state, _ = fn(params, state, ttrain.synthetic_batch(
        cfg, 4, 8, 0, device="cpu"))
    q = sharding.sharded_tensors(params)["layers.0.attn.q.w"]
    assert tuple(q.spec) == (None, "model")  # tp: copies over data
    for j in range(4):
        assert torch.equal(q.blocks[(0, j)], q.blocks[(1, j)])
        assert q.blocks[(0, j)].shape == (cfg.d_model, 32)
    assert len(q.owners()) == 4


def test_a_mesh_step_without_a_card_raises(monkeypatch):
    """No fallback: the production mesh and a forced mesh default to the
    card, and raise without one unless the CPU is asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.make_production_mesh()
    from repro_torch.distributed import forcemesh
    with pytest.raises(RuntimeError, match="CUDA"):
        forcemesh.install((2, 2))
    context.clear()
    with pytest.raises(ValueError, match="256 devices"):
        tmesh.make_production_mesh(device="cpu")
