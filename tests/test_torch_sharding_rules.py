"""The LM's sharding rules and sharded storage against the JAX package's
(`repro_torch.distributed.sharding`), on the CPU; head padding; the
elastic re-mesh; the small helpers of `core.quant` and `ft.elastic`.

  * the rules are plain data: `param_specs`, `opt_state_specs`,
    `batch_specs`, `cache_specs` and `validate_divisibility` equal JAX's
    leaf by leaf for all ten configs at full width, on (1, 1), (2, 4),
    (16, 16) and (2, 16, 16), modes tp and fsdp_tp (JAX on an
    `AbstractMesh`, the port from meta-device shapes: nothing allocated);
  * the blocks: on forced 2x4 and 2x2x2 ("pod") meshes each leaf's block
    map is JAX's ``devices_indices_map`` (eight forced host devices in a
    subprocess), and each stored block holds that slice;
  * head padding: JAX's three geometries, the padded layout of JAX's own
    draws bit for bit, padded logits within 1e-5 of JAX's and of the
    unpadded model's;
  * `remesh_restore`: a 2x2 checkpoint onto 1x2, and a JAX checkpoint
    onto a port mesh, the same logical leaves bit for bit.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import JaxJob, to_np

from repro import configs as jconfigs
from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.core import quant as jquant
from repro.distributed import sharding as jsharding
from repro.ft import elastic as jelastic
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core import quant as tquant
from repro_torch.distributed import context, sharding
from repro_torch.ft import elastic as telastic
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm

ARCHS = tuple(tconfigs.ALIASES)
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
MODES = ("tp", "fsdp_tp")
BLOCK_ARCHS = ("tinyllama-1.1b", "phi3.5-moe-42b-a6.6b", "deepseek-v3-671b",
               "mamba2-2.7b")
BLOCK_MESHES = {"2x4": ((2, 4), ("data", "model")),
                "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


def port_mesh(shape, names) -> context.Mesh:
    return context.Mesh(np.full(shape, "cpu", dtype=object), names)


def _spec_tree(tree):
    """Specs (either package's) -> nested plain tuples."""
    if isinstance(tree, dict):
        return {k: _spec_tree(v) for k, v in tree.items()}
    if tree is None:
        return None
    return tuple(tree)


# ---------------------------------------------------------------------------
# the rules, at full width
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_jaxs_at_full_width(arch, mesh_name):
    shape, names = MESHES[mesh_name]
    jmesh = jax.sharding.AbstractMesh(shape, names)
    tmesh_ = port_mesh(shape, names)
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    for mode in MODES:
        want = jsharding.param_specs(jcfg, jmesh, mode)
        got = sharding.param_specs(tcfg, tmesh_, mode)
        assert _spec_tree(got) == _spec_tree(want), mode
        jo, to = jsharding.opt_state_specs(want), sharding.opt_state_specs(got)
        assert tuple(to.step) == tuple(jo.step) == ()
        assert _spec_tree(to.mu) == _spec_tree(jo.mu)
        assert _spec_tree(to.nu) == _spec_tree(jo.nu)
        assert sharding.validate_divisibility(tcfg, tmesh_, mode) == \
            jsharding.validate_divisibility(jcfg, jmesh, mode)
    assert _spec_tree(sharding.batch_specs(tcfg, tmesh_)) == \
        _spec_tree(jsharding.batch_specs(jcfg, jmesh))
    jc, tc = jsharding.cache_specs(jcfg, jmesh), sharding.cache_specs(
        tcfg, tmesh_)
    assert tc._fields == jc._fields
    for f in jc._fields:
        assert _spec_tree(getattr(tc, f)) == _spec_tree(getattr(jc, f)), f
    assert sharding.dp_axes(tmesh_) == jsharding.dp_axes(jmesh)


def test_fit_spec_drops_what_does_not_divide():
    mesh = port_mesh((2, 4), ("data", "model"))
    jmesh = jax.sharding.AbstractMesh((2, 4), ("data", "model"))
    P, JP = sharding.P, jax.sharding.PartitionSpec
    for spec, shape in (((("data",), "model"), (6, 8)), (("data", None),
                                                         (3, 5)),
                        (("model",), (50280, 7)), ((), (4, 4))):
        want = jsharding.fit_spec(JP(*spec), shape, jmesh)
        assert tuple(sharding.fit_spec(P(*spec), shape, mesh)) == \
            tuple(want)


# ---------------------------------------------------------------------------
# the blocks, against JAX's placement
# ---------------------------------------------------------------------------

BLOCKS_JOB = """
import dataclasses, json
import numpy as np
import jax
from jax.sharding import NamedSharding
from repro import configs
from repro.distributed import sharding as sh
from repro.models import lm

out = {{}}
for mname, (shape, names) in {meshes!r}.items():
    mesh = jax.make_mesh(shape, names)
    pos = {{d.id: list(c) for c, d in np.ndenumerate(mesh.devices)}}
    for arch in {archs!r}:
        cfg = configs.get(arch, smoke=True)
        shapes = jax.eval_shape(lambda: lm.init_params(
            jax.random.PRNGKey(0), cfg))
        for mode in ("tp", "fsdp_tp"):
            specs = sh.param_specs(cfg, mesh, mode)
            leaves = {{}}
            for (path, x), s in zip(
                    jax.tree_util.tree_flatten_with_path(shapes)[0],
                    jax.tree_util.tree_leaves(
                        specs, is_leaf=lambda v: isinstance(
                            v, jax.sharding.PartitionSpec))):
                m = NamedSharding(mesh, s).devices_indices_map(x.shape)
                leaves[".".join(str(k.key) for k in path)] = {{
                    json.dumps(pos[d.id]): [list(sl.indices(n)[:2])
                                            for sl, n in zip(idx, x.shape)]
                    for d, idx in m.items()}}
            out[f"{{mname}}/{{arch}}/{{mode}}"] = leaves
        bs = sh.batch_specs(cfg, mesh)
        m = NamedSharding(mesh, bs["labels"]).devices_indices_map((8, 4))
        out[f"{{mname}}/{{arch}}/labels"] = {{
            json.dumps(pos[d.id]): [list(sl.indices(n)[:2])
                                    for sl, n in zip(idx, (8, 4))]
            for d, idx in m.items()}}
print("OUT", json.dumps(out))
"""


@pytest.fixture(scope="module", autouse=True)
def _blocks_job():
    return JaxJob(BLOCKS_JOB.format(meshes=BLOCK_MESHES, archs=BLOCK_ARCHS),
                  ndev=8)


@pytest.fixture(scope="module")
def jax_blocks(_blocks_job):
    return _blocks_job.result()


def _block_map(index: dict) -> dict:
    return {json.dumps(list(c)): [[s.start, s.stop] for s in idx]
            for c, idx in index.items()}


@pytest.mark.parametrize("mesh_name", BLOCK_MESHES)
@pytest.mark.parametrize("arch", BLOCK_ARCHS)
def test_block_maps_are_jaxs_placement(arch, mesh_name, jax_blocks):
    shape, names = BLOCK_MESHES[mesh_name]
    mesh = port_mesh(shape, names)
    cfg = tconfigs.get(arch, smoke=True)
    model = tlm.init_params(0, cfg, device="cpu")
    flat = convert.lm_stack({k: p for k, p in model.named_parameters()})
    for mode in MODES:
        want = jax_blocks[f"{mesh_name}/{arch}/{mode}"]
        specs = sharding.param_specs(cfg, mesh, mode)
        got = {}
        for path, x in flat.items():
            node = specs
            for part in path.split("."):
                node = node[part]
            st = sharding.NamedSharding(mesh, node).place(x)
            got[path] = _block_map(st.index)
            for c, idx in st.index.items():  # each block holds its slice
                assert torch.equal(st.blocks[c], x[idx]), (path, c)
        assert got == want, mode
        # the per-layer tensors of a sharded model: their leaf's blocks
        # without the layer axis
        tensors = sharding.sharded_tensors(sharding.shard_model(
            model, specs, mesh))
        for name, st in tensors.items():
            stacked = want[sharding._jax_path(name)]
            drop = 1 if name.startswith("layers.") else 0
            assert _block_map(st.index) == {
                c: idx[drop:] for c, idx in stacked.items()}, name
    labels = sharding.NamedSharding(mesh, sharding.batch_specs(
        cfg, mesh)["labels"]).devices_indices_map((8, 4))
    assert _block_map(labels) == jax_blocks[f"{mesh_name}/{arch}/labels"]


def test_a_spec_that_does_not_divide_raises():
    mesh = port_mesh((2, 4), ("data", "model"))
    with pytest.raises(ValueError, match="evenly divide"):
        sharding.NamedSharding(mesh, sharding.P(None, "model")).place(
            torch.zeros(5, 5))


def test_resident_bytes_follow_the_specs():
    """fsdp_tp stores 1 / (data x model) of a weight at each coordinate;
    tp stores 1 / model, copied over data."""
    cfg = tconfigs.get("tinyllama-1.1b", smoke=True)
    mesh = port_mesh((2, 2), ("data", "model"))
    model = tlm.init_params(0, cfg, device="cpu")
    w = model.layers[0].mlp.gate.w
    for mode, parts in (("fsdp_tp", 4), ("tp", 2)):
        st = sharding.shard_model(model, sharding.param_specs(
            cfg, mesh, mode), mesh).layers[0].mlp.gate.w
        assert set(st.nbytes().values()) == {
            w.numel() * w.element_size() // parts}


# ---------------------------------------------------------------------------
# head padding
# ---------------------------------------------------------------------------

PAD_CASES = {
    # JAX's tests/test_models_zoo.py geometries
    "gqa": ("qwen2.5-14b", dict(n_heads=10, n_kv_heads=2, head_dim=16,
                                d_model=96, d_ff=128), 4, (12, 4, 2, 3)),
    "mha": ("qwen1.5-32b", dict(n_heads=5, n_kv_heads=5, head_dim=16,
                                d_model=80, d_ff=128), 4, (8, 8, 1, 1)),
    "qwen14b_m16": ("qwen2.5-14b", dict(n_heads=40, n_kv_heads=8), 16,
                    (48, 16, 2, 3)),
}


def _pad_cfgs(case):
    arch, kw, m, _ = PAD_CASES[case]
    j0 = dataclasses.replace(jconfigs.get(arch, smoke=True),
                             dtype=jnp.float32, **kw)
    t0 = dataclasses.replace(tconfigs.get(arch, smoke=True),
                             dtype=torch.float32, **kw)
    return (j0, dataclasses.replace(j0, head_pad_multiple=m), t0,
            dataclasses.replace(t0, head_pad_multiple=m))


@pytest.mark.parametrize("case", PAD_CASES)
def test_head_padding_geometry_and_layout_are_jaxs(case):
    j0, j1, t0, t1 = _pad_cfgs(case)
    geom = PAD_CASES[case][3]
    assert tlm._pad_geom(t1) == jlm._pad_geom(j1) == geom
    assert tlm.padded_heads(t1) == jlm.padded_heads(j1) == geom[:2]
    idx, valid = jlm._q_head_map(j1)
    assert tlm._q_head_map(t1) == (list(idx), list(valid))
    key = jax.random.PRNGKey(0)
    jp0 = jax.tree.map(np.asarray, jlm.init_params(key, j0))
    jp1 = jax.tree.map(np.asarray, jlm.init_params(key, j1))
    base = convert.lm_params_from_numpy(jp0, t0, device="cpu")
    # the port's re-lay of JAX's unpadded draws is JAX's padded init
    for i, layer in enumerate(base.layers):
        a = layer.attn
        got = {"q": tlm.pad_q(a.q, t1, 1), "k": tlm.pad_kv(a.k, t1),
               "v": tlm.pad_kv(a.v, t1), "o": tlm.pad_q(a.o, t1, 0)}
        for k, lin in got.items():
            want = jp1["layers"]["attn"][k]
            assert torch.equal(lin.w, torch.from_numpy(np.array(want["w"][i]))), k
            if "b" in want:
                assert torch.equal(lin.b, torch.from_numpy(np.array(want["b"][i]))), k
    # and a padded port model holds JAX's padded tree leaf by leaf
    padded = convert.lm_params_from_numpy(jp1, t1, device="cpu")
    back = convert.lm_params_to_numpy(padded, t1)
    for k, v in convert.flatten_tree(back).items():
        np.testing.assert_array_equal(v, convert.flatten_tree(jp1)[k])


@pytest.mark.parametrize("case", PAD_CASES)
def test_padded_logits_equal_jaxs_and_the_unpadded_ones(case):
    j0, j1, t0, t1 = _pad_cfgs(case)
    key = jax.random.PRNGKey(0)
    jp1 = jlm.init_params(key, j1)
    x = np.random.RandomState(4).randint(0, j0.vocab, (2, 12)).astype(
        np.int32)
    want, _ = jlm.forward(jp1, j1, jnp.asarray(x))
    want = np.asarray(want)
    padded = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp1), t1,
                                          device="cpu")
    got, _ = tlm.forward(padded, t1, torch.from_numpy(x))
    scale = float(np.abs(want).max())
    assert float(np.abs(to_np(got) - want).max()) <= 1e-5 * scale
    # the port's own init: the same draws, padded or not, one function
    p0, p1 = tlm.init_params(0, t0, device="cpu"), tlm.init_params(
        0, t1, device="cpu")
    l0, _ = tlm.forward(p0, t0, torch.from_numpy(x))
    l1, _ = tlm.forward(p1, t1, torch.from_numpy(x))
    assert float((l0 - l1).abs().max()) <= 1e-5 * float(l0.abs().max())
    # prefill and decode through the padded kv cache
    lp, cache = tlm.prefill(p1, t1, torch.from_numpy(x[:, :8]), max_len=12)
    assert cache.k.shape[3] == tlm.padded_heads(t1)[1]
    ld, _ = tlm.decode_step(p1, t1, torch.from_numpy(x[:, 8:9]), cache)
    assert float((ld[:, 0] - l0[:, 8]).abs().max()) <= 1e-5 * float(
        l0.abs().max())


def test_head_padding_is_a_noop_where_kv_does_not_divide():
    cfg = dataclasses.replace(tconfigs.get("hymba-1.5b", smoke=True),
                              head_pad_multiple=16, n_heads=10, n_kv_heads=5)
    jcfg = dataclasses.replace(jconfigs.get("hymba-1.5b", smoke=True),
                               head_pad_multiple=16, n_heads=10,
                               n_kv_heads=5)
    assert tlm._pad_geom(cfg) is None and jlm._pad_geom(jcfg) is None
    assert tlm.padded_heads(cfg) == (10, 5)


# ---------------------------------------------------------------------------
# elastic re-mesh
# ---------------------------------------------------------------------------

def test_remesh_restore_moves_a_2x2_checkpoint_onto_1x2(tmp_path):
    cfg = dataclasses.replace(tconfigs.get("phi3.5-moe-42b-a6.6b",
                                           smoke=True), dtype=torch.float32)
    m22 = port_mesh((2, 2), ("data", "model"))
    fn, in_specs, _, opt = tsteps.build_train_step(cfg, m22)
    params = sharding.shard_model(tlm.init_params(0, cfg, device="cpu"),
                                  in_specs[0], m22)
    state = opt.init(params)
    params, state, _ = fn(params, state, ttrain.synthetic_batch(
        cfg, 4, 8, 0, device="cpu"))
    tree = {"params": sharding.model_tree(sharding.sharded_tensors(params),
                                          m22),
            "opt": state._replace(mu=sharding.model_tree(state.mu, m22),
                                  nu=sharding.model_tree(state.nu, m22))}
    ckpt = Checkpointer(tmp_path)
    ckpt.save(1, tree)
    m12 = port_mesh((1, 2), ("data", "model"))
    specs = sharding.param_specs(cfg, m12)
    new_specs = {"params": specs,
                 "opt": sharding.opt_state_specs(specs)}
    like = sharding.tree_map(lambda st: torch.empty(0), tree,
                             is_leaf=lambda x: isinstance(
                                 x, sharding.ShardedTensor))
    got = telastic.remesh_restore(ckpt, 1, like, m12, new_specs)
    flat_want = convert.flatten_tree(tree["params"])
    for k, st in convert.flatten_tree(got["params"]).items():
        assert st.mesh is m12
        assert tuple(st.spec) == tuple(convert.flatten_tree(specs)[k])
        assert torch.equal(st.full(), flat_want[k].full()), k
    assert int(got["opt"].step.full()) == 1
    # the restored tree runs a step on the new mesh
    fn12, _, _, _ = tsteps.build_train_step(cfg, m12)
    model = sharding.shard_model(tlm.init_params(0, cfg, device="cpu"),
                                 specs, m12)
    sharding.load_tensors(model, sharding.untree(got["params"]))
    restored = state._replace(step=got["opt"].step,
                              mu=sharding.untree(got["opt"].mu),
                              nu=sharding.untree(got["opt"].nu))
    _, _, met = fn12(model, restored, ttrain.synthetic_batch(
        cfg, 4, 8, 1, device="cpu"))
    assert np.isfinite(float(met["loss"]))


def test_remesh_restore_places_a_jax_checkpoint(tmp_path):
    jcfg = jconfigs.get("tinyllama-1.1b", smoke=True)
    jp = jlm.init_params(jax.random.PRNGKey(3), jcfg)
    JCheckpointer(tmp_path).save(7, {"params": jp})
    cfg = tconfigs.get("tinyllama-1.1b", smoke=True)
    mesh = port_mesh((2, 2), ("data", "model"))
    specs = sharding.param_specs(cfg, mesh)
    like = {"params": jax.tree.map(lambda _: torch.empty(0), jp)}
    got = telastic.remesh_restore(Checkpointer(tmp_path), 7, like, mesh,
                                  {"params": specs})
    want = convert.flatten_tree(jax.tree.map(np.asarray, jp))
    for k, st in convert.flatten_tree(got["params"]).items():
        np.testing.assert_array_equal(convert._numpy(st.full()), want[k])
        assert tuple(st.spec) == tuple(convert.flatten_tree(specs)[k])


def test_production_mesh_over_forced_devices():
    context.force_devices([torch.device("cpu")] * 512)
    try:
        m = tmesh.make_production_mesh(device="cpu")
        assert m.shape == {"data": 16, "model": 16} and m.virtual
        m = tmesh.make_production_mesh(multi_pod=True, device="cpu")
        assert m.shape == {"pod": 2, "data": 16, "model": 16}
        assert sharding.dp_axes(m) == ("pod", "data")
        assert m.ranks(("pod", "data"))[17][3] == (1, 1, 3)
    finally:
        context.clear()


def test_launcher_installs_its_mesh_and_clears_it(monkeypatch):
    seen = []
    real = ttrain._train

    def spy(args, cfg, dev):
        seen.append((context.get(), context.get_mesh()))
        return real(args, cfg, dev)

    monkeypatch.setattr(ttrain, "_train", spy)
    out = ttrain.main(["--arch", "tinyllama-1.1b", "--smoke", "--steps",
                       "1", "--batch", "2", "--seq", "8"], device="cpu")
    assert np.isfinite(out["final_loss"])
    (axes, mesh), = seen
    assert axes == ("data", "model") and mesh.shape == {"data": 1,
                                                        "model": 1}
    assert context.get() is None and context.get_mesh() is None
    # 256 forced devices give the production mesh
    monkeypatch.setenv("REPRO_FORCE_MESH", "16x16")
    seen.clear()
    ttrain.main(["--arch", "tinyllama-1.1b", "--smoke", "--steps", "1",
                 "--batch", "16", "--seq", "4"], device="cpu")
    assert seen[0][1].shape == {"data": 16, "model": 16}
    assert context.get() is None


# ---------------------------------------------------------------------------
# the small helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["mean", "median"])
def test_binarize_with_stats_matches_jax(method):
    x = np.random.RandomState(0).randn(64, 32).astype(np.float32)
    jb, jt = jquant.binarize_with_stats(jnp.asarray(x), method)
    tb, tt = tquant.binarize_with_stats(torch.from_numpy(x), method)
    np.testing.assert_allclose(to_np(tt), np.asarray(jt), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(to_np(tb), np.asarray(jb))
    assert set(np.unique(to_np(tb))) <= {0.0, 1.0}


@pytest.mark.parametrize("args", [(256, 8, 6, 8), (256, 8, 8, 8),
                                  (100, 4, 3, 7), (1, 2, 1, 16)])
def test_rescale_schedule_matches_jax(args):
    g, old, new, per = args
    assert telastic.rescale_schedule(g, old, new, per) == \
        jelastic.rescale_schedule(g, old, new, per)


def test_heartbeat_matches_jax():
    j, t = jelastic.Heartbeat(timeout_s=5.0), telastic.Heartbeat(
        timeout_s=5.0)
    for hb in (j, t):
        hb.beat(0, now=1.0)
        hb.beat(1, now=8.0)
        hb.beat(2, now=3.9)
    for now in (2.0, 6.5, 9.0, 14.0):
        assert t.dead_hosts(now=now) == j.dead_hosts(now=now)
    t.beat(3)
    assert t.dead_hosts() == [0, 1, 2]
