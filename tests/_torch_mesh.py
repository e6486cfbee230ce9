"""Shared parts of the mesh LM parity tests (`tests/test_torch_lm_mesh*.py`):
JAX's sharded builders run in a subprocess (`start_oracle`) on eight
forced host devices and a (data 2, model 4) mesh with Auto axes, under
``with mesh:`` (the default Explicit axes refuse
`with_sharding_constraint`); the port's builders run on a forced 2x4 mesh
of the CPU from JAX's initial weights and are held to them
(`check_train_step`, `check_serve_steps`). Tolerances:
  * the loss within 1e-5 relative, the global gradient norm within 1e-5;
  * both AdamW moments after one step within 1e-5 of each leaf's scale;
  * the parameters after the step within 1e-5 of each leaf's scale where
    JAX's gradient is above 1e-3 of its leaf's largest, and within two
    learning rates elsewhere: Adam's first step moves an element by
    lr * g / (|g| + eps), so a gradient near rounding level moves its
    element by anything up to lr either way;
  * prefill and decode logits and every cache field within 1e-5 of the
    scale.
"""
import dataclasses

import numpy as np
import torch
from _torch_parity import JaxJob, to_np

from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.distributed import context, sharding
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm

B, S, PROMPT, MAX_LEN = 4, 16, 12, 16
LR = 3e-4
TOL = 1e-5
# moe_shardmap past the exact-capacity limit: 4608 tokens a dp shard
MOE_B, MOE_S = 2, 4608

ORACLE = """
import dataclasses, json
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro import configs
from repro.distributed import context as mctx, sharding as sh
from repro.launch import steps
from repro.models import layers as L, lm

CASES = {cases!r}
B, S, PL, ML = {B}, {S}, {PROMPT}, {MAX_LEN}
res = {{}}
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)


def save(prefix, tree):
    for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
        res[prefix + "/".join(str(k.key) for k in path)] = np.asarray(x)


for name, (arch, kw) in CASES.items():
    cfg = dataclasses.replace(configs.get(arch, smoke=True),
                              dtype=jnp.float32, **kw)
    rng = np.random.RandomState(1)
    toks = rng.randint(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = rng.randint(0, cfg.vocab, (B, S)).astype(np.int32)
    labels[0, 3] = -1
    batch = {{"inputs": jnp.asarray(toks), "labels": jnp.asarray(labels)}}
    params = lm.init_params(jax.random.PRNGKey(0), cfg)
    save(name + "/init/", params)
    res[name + "/tokens"], res[name + "/labels"] = toks, labels
    mctx.set_mesh_axes(sh.dp_axes(mesh), "model", mesh=mesh)
    with mesh:
        fn, ins, outs, opt = steps.build_train_step(cfg, mesh,
                                                    example_batch=batch)
        p = jax.device_put(params, sh.to_shardings(ins[0], mesh))
        o = jax.device_put(opt.init(params), sh.to_shardings(ins[1], mesh))
        p, o, met = fn(p, o, batch)
        res[name + "/loss"] = np.asarray(met["loss"])
        res[name + "/gnorm"] = np.asarray(met["grad_norm"])
        save(name + "/params/", p)
        save(name + "/mu/", o.mu)
        save(name + "/nu/", o.nu)
        prompt = jnp.asarray(toks[:, :PL])
        pf, pin, _ = steps.build_prefill_step(cfg, mesh, max_len=ML,
                                              example_args=(params, prompt))
        p = jax.device_put(params, sh.to_shardings(pin[0], mesh))
        logits, cache = pf(p, prompt)
        res[name + "/prefill_logits"] = np.asarray(logits)
        for f in lm.Cache._fields[:-1]:
            if getattr(cache, f) is not None:
                res[name + "/prefill/" + f] = np.asarray(getattr(cache, f))
        tok = jnp.asarray(toks[:, PL:PL + 1])
        dc, _, _ = steps.build_decode_step(cfg, mesh,
                                           example_args=(p, tok, cache))
        logits, cache = dc(p, tok, cache)
        res[name + "/decode_logits"] = np.asarray(logits)
        for f in lm.Cache._fields[:-1]:
            if getattr(cache, f) is not None:
                res[name + "/decode/" + f] = np.asarray(getattr(cache, f))
    mctx.clear()
"""

MOE_ORACLE = """
# moe_shardmap past 4096 tokens a dp shard, every token routed to expert 0
cfg = configs.get("phi3.5-moe-42b-a6.6b", smoke=True)
for dt in ("float32", "bfloat16"):
    p = L.moe_init(jax.random.PRNGKey(5), cfg.d_model, cfg.d_ff_expert,
                   cfg.n_experts, 0, cfg.d_ff_expert, dtype=jnp.dtype(dt))
    p["router"]["w"] = p["router"]["w"].at[:, 0].add(0.5)
    x = (jax.random.normal(jax.random.PRNGKey(6),
                           ({MOE_B}, {MOE_S}, cfg.d_model)) + 1).astype(dt)
    save("moe_" + dt + "/p/", jax.tree.map(lambda a: a.astype(jnp.float32),
                                           p))
    res["moe_" + dt + "/x"] = np.asarray(x.astype(jnp.float32))
    mctx.set_mesh_axes("data", "model", mesh=mesh)
    with mesh:
        y, aux = jax.jit(lambda p, x: L.moe_shardmap(
            p, x, top_k=cfg.top_k))(p, x)
    mctx.clear()
    res["moe_" + dt + "/y"] = np.asarray(y.astype(jnp.float32))
    res["moe_" + dt + "/aux"] = np.asarray(aux)
"""


def start_oracle(cases: dict, path, moe: bool = False) -> JaxJob:
    """JAX's sharded train / prefill / decode steps for ``cases`` (name
    -> (arch, config changes)), and with ``moe`` `moe_shardmap` past 4096
    tokens a shard, into the ``.npz`` at ``path``."""
    code = ORACLE.format(cases=cases, B=B, S=S, PROMPT=PROMPT,
                         MAX_LEN=MAX_LEN)
    if moe:
        code += MOE_ORACLE.format(MOE_B=MOE_B, MOE_S=MOE_S)
    code += (f"np.savez({str(path)!r}, **res)\n"
             "print(\"OUT\", json.dumps({\"n\": len(res)}))\n")
    return JaxJob(code, ndev=8)


def mesh24() -> context.Mesh:
    """A forced (data 2, model 4) mesh of the CPU, installed."""
    mesh = context.Mesh(np.full((2, 4), "cpu", dtype=object).tolist(),
                        ("data", "model"))
    context.set_mesh_axes("data", "model", mesh)
    return mesh


def tree(z: dict, prefix: str) -> dict:
    return convert.nest({k[len(prefix):].replace("/", "."): v
                         for k, v in z.items() if k.startswith(prefix)})


def setup(z: dict, name: str, cases: dict):
    arch, kw = cases[name]
    cfg = dataclasses.replace(tconfigs.get(arch, smoke=True),
                              dtype=torch.float32, **kw)
    model = convert.lm_params_from_numpy(tree(z, f"{name}/init/"), cfg,
                                         device="cpu")
    batch = {"inputs": torch.from_numpy(z[f"{name}/tokens"]),
             "labels": torch.from_numpy(z[f"{name}/labels"])}
    return cfg, model, batch


def close(got, want: np.ndarray, what: str) -> None:
    got = to_np(got.full() if isinstance(got, sharding.ShardedTensor)
                else got)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert got.shape == want.shape, what
    assert err <= TOL * scale, f"{what}: {err} > {TOL} x {scale}"


def check_train_step(z: dict, name: str, cases: dict, mesh) -> None:
    cfg, model, batch = setup(z, name, cases)
    fn, in_specs, out_specs, opt = tsteps.build_train_step(
        cfg, mesh, example_batch=batch)
    params = sharding.shard_model(model, in_specs[0], mesh)
    state = opt.init(params)
    params, state, metrics = fn(params, state, batch)
    loss, want = float(metrics["loss"]), float(z[f"{name}/loss"])
    assert abs(loss - want) <= TOL * abs(want)
    assert abs(float(metrics["grad_norm"]) - float(z[f"{name}/gnorm"])) \
        <= TOL * float(z[f"{name}/gnorm"])
    assert int(state.step.full()) == 1
    moments = {}
    for tag, tensors in (("mu", state.mu), ("nu", state.nu)):
        got = convert.flatten_tree(sharding.model_tree(tensors, mesh))
        for k, st in got.items():
            want = z[f"{name}/{tag}/" + k.replace(".", "/")]
            close(st, want, f"{tag} {k}")
            moments[(tag, k)] = want
    got = convert.flatten_tree(sharding.model_tree(
        sharding.sharded_tensors(params), mesh))
    assert set(got) == {k for _, k in moments}
    for k, st in got.items():
        want = z[f"{name}/params/" + k.replace(".", "/")]
        g = np.abs(moments[("mu", k)])  # (1 - b1) |g|: the gradient's size
        steady = g > 1e-3 * g.max()
        diff = np.abs(to_np(st.full()) - want)
        assert diff[steady].max(initial=0) <= TOL * np.abs(want).max(), k
        assert diff.max() <= 2 * LR, k


def check_serve_steps(z: dict, name: str, cases: dict, mesh) -> None:
    cfg, model, batch = setup(z, name, cases)
    prompt = batch["inputs"][:, :PROMPT]
    pf, in_sp, out_sp = tsteps.build_prefill_step(
        cfg, mesh, max_len=MAX_LEN, example_args=(model, prompt))
    params = sharding.shard_model(model, in_sp[0], mesh)
    logits, cache = pf(params, prompt)
    assert tuple(logits.spec) == tuple(out_sp[0])
    close(logits, z[f"{name}/prefill_logits"], "prefill logits")
    fields = [f for f in tlm.CACHE_FIELDS if getattr(cache, f) is not None]
    assert fields == [f for f in tlm.CACHE_FIELDS
                      if f"{name}/prefill/{f}" in z]
    for f in fields:
        assert tuple(getattr(cache, f).spec) == tuple(getattr(out_sp[1], f))
        close(getattr(cache, f), z[f"{name}/prefill/{f}"], f"prefill {f}")
    tok = batch["inputs"][:, PROMPT:PROMPT + 1]
    dc, _, d_out = tsteps.build_decode_step(
        cfg, mesh, example_args=(model, tok, cache))
    logits, cache = dc(params, tok, cache)
    assert cache.length == PROMPT + 1
    assert tuple(logits.spec) == tuple(d_out[0])
    close(logits, z[f"{name}/decode_logits"], "decode logits")
    for f in fields:
        close(getattr(cache, f), z[f"{name}/decode/{f}"], f"decode {f}")
