"""The dry run's probes (`repro_torch.launch.steps.build_layer_probe`,
`build_embed_head_probe`) against the JAX package's own, on the CPU.

JAX's probes run in a subprocess on eight forced host devices, under
``with mesh:`` on meshes with Auto axes (the default Explicit axes refuse
`with_sharding_constraint`), as `tests/_torch_mesh.py` runs the sharded
builders; the port's run on a 1x1 mesh and a forced 2x4 mesh of the CPU
from JAX's initial weights (`convert`), the SMOKE configs in f32. Cases:
the layer probe (train, train with the gradient, and decode for causal
configs) and the embed-and-head probe (train with the gradient, and
prefill), for tinyllama, phi3.5-moe, deepseek-v3 (MLA), mamba2, hymba,
qwen2-vl (M-RoPE, embeddings in) and hubert (an encoder: no decode).
Outputs, caches and gradients within 1e-5 of the scale (`_torch_mesh`'s
tolerance); the prefill head's sum of logits within 1e-5 of the summed
magnitudes.
"""
import dataclasses

import numpy as np
import pytest
import torch
from _torch_mesh import TOL, close, tree
from _torch_parity import JaxJob

from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.distributed import context
from repro_torch.launch import steps as tsteps
from repro_torch.models import layers as L
from repro_torch.models import lm as tlm

ARCHS = {"tinyllama": "tinyllama-1.1b", "phi": "phi3.5-moe-42b-a6.6b",
         "deepseek": "deepseek-v3-671b", "mamba2": "mamba2-2.7b",
         "hymba": "hymba-1.5b", "qwen2vl": "qwen2-vl-72b",
         "hubert": "hubert-xlarge"}
MESHES = {"1x1": (1, 1), "2x4": (2, 4)}
B, S = 4, 16

ORACLE = """
import dataclasses, json
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro import configs
from repro.distributed import context as mctx, sharding as sh
from repro.launch import steps
from repro.models import lm

ARCHS, MESHES = {archs!r}, {meshes!r}
B, S = {B}, {S}
res = {{}}


def save(prefix, tree):
    for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
        res[prefix + "/".join(str(k.key) for k in path)] = np.asarray(
            jnp.asarray(x, jnp.float32))


for name, arch in ARCHS.items():
    cfg = dataclasses.replace(configs.get(arch, smoke=True),
                              dtype=jnp.float32)
    params = lm.init_params(jax.random.PRNGKey(0), cfg)
    save(name + "/init/", params)
    layer = jax.tree.map(lambda x: x[0], params["layers"])
    head = {{k: params[k] for k in ("embed", "unembed", "final_norm")
            if k in params}}
    rng = np.random.RandomState(3)
    h = rng.randn(B, S, cfg.d_model).astype(np.float32)
    h1 = rng.randn(B, 1, cfg.d_model).astype(np.float32)
    cache = lm.init_cache(cfg, B, S)
    cache_l = {{f: rng.randn(*getattr(cache, f).shape[1:]).astype(
        getattr(cache, f).dtype) for f in lm._cache_layer_fields(cfg)}}
    if cfg.input_mode == "embeds":
        inp = np.asarray(jnp.asarray(rng.randn(B, S, cfg.d_model),
                                     jnp.bfloat16).astype(jnp.float32))
    else:
        inp = rng.randint(0, cfg.vocab, (B, S)).astype(np.int32)
    lbl = rng.randint(0, cfg.vocab, (B, S)).astype(np.int32)
    res[name + "/h"], res[name + "/h1"] = h, h1
    res[name + "/inputs"], res[name + "/labels"] = inp, lbl
    for f, x in cache_l.items():
        res[name + "/cache/" + f] = x
    jinp = jnp.asarray(inp, jnp.bfloat16) if cfg.input_mode == "embeds" \\
        else jnp.asarray(inp)
    for mname, shape in MESHES.items():
        mesh = jax.make_mesh(shape, ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)
        mctx.set_mesh_axes(sh.dp_axes(mesh), "model", mesh=mesh)
        key = name + "/" + mname
        with mesh:
            fn, _, _ = steps.build_layer_probe(cfg, mesh, kind="train",
                                               seq=S, batch=B,
                                               with_grad=False)
            res[key + "/layer"] = np.asarray(fn(layer, h))
            fn, _, _ = steps.build_layer_probe(cfg, mesh, kind="train",
                                               seq=S, batch=B,
                                               with_grad=True)
            gp, gh = fn(layer, h)
            save(key + "/layer_grad/", gp)
            res[key + "/layer_grad_h"] = np.asarray(gh)
            if cfg.causal:
                fn, _, _ = steps.build_layer_probe(cfg, mesh, kind="decode",
                                                   seq=S, batch=B,
                                                   with_grad=False)
                out, new = fn(layer, h1, cache_l)
                res[key + "/decode"] = np.asarray(out)
                save(key + "/decode_cache/", new)
            fn, _, _ = steps.build_embed_head_probe(cfg, mesh, kind="train",
                                                    seq=S, batch=B,
                                                    with_grad=True)
            save(key + "/head_grad/", fn(head, jinp, lbl))
            fn, _, _ = steps.build_embed_head_probe(cfg, mesh,
                                                    kind="prefill", seq=S,
                                                    batch=B, with_grad=False)
            res[key + "/head_prefill"] = np.asarray(fn(head, jinp, lbl))
        mctx.clear()
"""


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_probes") / "out.npz"
    code = ORACLE.format(archs=ARCHS, meshes=MESHES, B=B, S=S)
    code += (f"np.savez({str(path)!r}, **res)\n"
             "print(\"OUT\", json.dumps({\"n\": len(res)}))\n")
    JaxJob(code, ndev=8).result(timeout=900)
    return dict(np.load(path))


def _setup(z: dict, name: str, mesh_name: str):
    cfg = dataclasses.replace(tconfigs.get(ARCHS[name], smoke=True),
                              dtype=torch.float32)
    model = convert.lm_params_from_numpy(tree(z, f"{name}/init/"), cfg,
                                         device="cpu")
    mesh = context.Mesh(np.full(MESHES[mesh_name], "cpu",
                                dtype=object).tolist(), ("data", "model"))
    context.set_mesh_axes("data", "model", mesh)
    return cfg, model, mesh


def _inputs(z: dict, name: str, cfg):
    inp = torch.from_numpy(z[f"{name}/inputs"])
    if cfg.input_mode == "embeds":
        inp = inp.to(torch.bfloat16)
    return inp, torch.from_numpy(z[f"{name}/labels"])


def _close_grads(got: dict, z: dict, prefix: str) -> None:
    """Gradients by port name against the JAX leaves under ``prefix``."""
    want = {k[len(prefix):].replace("/", "."): v for k, v in z.items()
            if k.startswith(prefix)}
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k, st in got.items():
        close(st, want[k], f"gradient {k}")


@pytest.fixture
def clean_mesh():
    yield
    context.clear()


CASES = [(n, m) for n in ARCHS for m in MESHES]


@pytest.mark.parametrize("name,mesh_name", CASES)
def test_layer_probe_train(name, mesh_name, jax_out, clean_mesh):
    z = jax_out
    cfg, model, mesh = _setup(z, name, mesh_name)
    fn, args, in_sp = tsteps.build_layer_probe(cfg, mesh, kind="train",
                                               seq=S, batch=B,
                                               with_grad=False)
    assert args[1].shape == (B, S, cfg.d_model) and args[1].is_meta
    out = fn(model.layers[0], torch.from_numpy(z[f"{name}/h"]))
    close(out, z[f"{name}/{mesh_name}/layer"], "layer output")


@pytest.mark.parametrize("name,mesh_name", CASES)
def test_layer_probe_train_with_grad(name, mesh_name, jax_out, clean_mesh):
    z = jax_out
    cfg, model, mesh = _setup(z, name, mesh_name)
    fn, _, _ = tsteps.build_layer_probe(cfg, mesh, kind="train", seq=S,
                                        batch=B, with_grad=True)
    grads, grad_h = fn(model.layers[0], torch.from_numpy(z[f"{name}/h"]))
    close(grad_h, z[f"{name}/{mesh_name}/layer_grad_h"], "gradient of h")
    _close_grads(grads, z, f"{name}/{mesh_name}/layer_grad/")


@pytest.mark.parametrize("name,mesh_name",
                         [c for c in CASES if c[0] != "hubert"])
def test_layer_probe_decode(name, mesh_name, jax_out, clean_mesh):
    z = jax_out
    cfg, model, mesh = _setup(z, name, mesh_name)
    fn, args, _ = tsteps.build_layer_probe(cfg, mesh, kind="decode",
                                           seq=S, batch=B, with_grad=False)
    cache_l = {f: torch.from_numpy(z[f"{name}/cache/{f}"]).to(x.dtype)
               for f, x in args[2].items()}
    out, new = fn(model.layers[0], torch.from_numpy(z[f"{name}/h1"]),
                  cache_l)
    close(out, z[f"{name}/{mesh_name}/decode"], "decode output")
    assert set(new) == set(cache_l)
    for f, st in new.items():
        close(st, z[f"{name}/{mesh_name}/decode_cache/{f}"], f"cache {f}")


@pytest.mark.parametrize("name,mesh_name", CASES)
def test_embed_head_probe_train_with_grad(name, mesh_name, jax_out,
                                          clean_mesh):
    z = jax_out
    cfg, model, mesh = _setup(z, name, mesh_name)
    fn, _, _ = tsteps.build_embed_head_probe(cfg, mesh, kind="train", seq=S,
                                             batch=B, with_grad=True)
    grads = fn(model, *_inputs(z, name, cfg))
    _close_grads(grads, z, f"{name}/{mesh_name}/head_grad/")


@pytest.mark.parametrize("name,mesh_name", CASES)
def test_embed_head_probe_prefill(name, mesh_name, jax_out, clean_mesh):
    z = jax_out
    cfg, model, mesh = _setup(z, name, mesh_name)
    fn, _, _ = tsteps.build_embed_head_probe(cfg, mesh, kind="prefill",
                                             seq=S, batch=B, with_grad=False)
    inputs, labels = _inputs(z, name, cfg)
    got = float(fn(model, inputs, labels))
    want = float(z[f"{name}/{mesh_name}/head_prefill"])
    # the scale of a sum: the summed magnitudes (the logits cancel)
    h = L.rmsnorm(model.final_norm, tlm._embed_in(model, cfg, inputs))
    scale = float(L.linear(model.unembed, h).abs().sum())
    assert abs(got - want) <= TOL * scale
