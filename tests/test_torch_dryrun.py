"""The port's dry run (`repro_torch.launch.dryrun`), its op census
(`repro_torch.analysis.census`), the H100 roofline and the report, on the
CPU, against the JAX package where it has the same function:

  * the roofline's arithmetic equals JAX's with JAX's constants set to the
    card's (monkeypatched: the JAX package is not edited);
  * the report prints JAX's text from one set of records;
  * the padding report is JAX's `validate_divisibility`;
  * SMOKE tinyllama train on a 2x4 mesh: ``memory.argument_bytes`` is
    XLA's ``argument_size_in_bytes`` for JAX's `build_train_step` on an
    Auto 2x4 mesh of eight forced host devices (a subprocess);
  * the census: the layer probe's product FLOPs are the analytic sum of
    its products and at most XLA's ``cost_analysis`` FLOPs for JAX's
    probe; the (S, S) scores found at their bytes; on the 2x4 mesh the
    collective bytes are the blocks each layer weight gathers from other
    owners; peak live bytes follow frees;
  * the MoE on the meta device: its modelled experts give ``2 * 3 * d *
    d_ff_expert * kept`` product FLOPs, and a CPU tensor never takes that
    branch;
  * ``dryrun.main`` on one full-width cell (a few seconds here) prints
    "all dry-run cells passed" and ``report.main`` tables its record.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AxisType
from _torch_parity import JaxJob

from repro import configs as jconfigs
from repro.analysis import report as jreport
from repro.analysis import roofline as jroofline
from repro.distributed import context as jctx
from repro.distributed import sharding as jsharding
from repro.launch import steps as jsteps
from repro_torch import configs as tconfigs
from repro_torch.analysis import census, report, roofline
from repro_torch.distributed import context, sharding
from repro_torch.launch import dryrun, shapes, steps
from repro_torch.models import layers as L
from repro_torch.models import lm

ARGS_ORACLE = """
import json
import jax
from jax.sharding import AxisType
from repro import configs
from repro.distributed import context as mctx, sharding as sh
from repro.launch import shapes, steps
from repro.models import lm

cfg = configs.get("tinyllama-1.1b", smoke=True)
spec = shapes.input_specs(cfg, "train_4k", smoke=True)
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
mctx.set_mesh_axes("data", "model", mesh=mesh)
with mesh:
    params = jax.eval_shape(lambda: lm.init_params(jax.random.PRNGKey(0),
                                                   cfg))
    fn, ins, _, opt = steps.build_train_step(cfg, mesh,
                                             example_batch=spec.args[0])
    ma = fn.lower(params, jax.eval_shape(opt.init, params),
                  *spec.args).compile().memory_analysis()
print("OUT", json.dumps({"argument_bytes": int(ma.argument_size_in_bytes)}))
"""


@pytest.fixture(scope="module")
def jax_args():
    return JaxJob(ARGS_ORACLE, ndev=8)


@pytest.fixture
def clean_mesh():
    yield
    context.clear()


# ---------------------------------------------------------------------------
# roofline and report
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("terms", [
    (3.1e12, 2.2e10, 1.5e8, 256, 4.4e15),
    (2.0e9, 7.5e11, 0.0, 1, 1.0e9),
    (5.0e11, 1.0e9, 9.0e11, 512, 0.0),
])
def test_roofline_arithmetic_is_jaxs(terms, monkeypatch):
    monkeypatch.setattr(jroofline, "PEAK_FLOPS", roofline.PEAK_FLOPS)
    monkeypatch.setattr(jroofline, "HBM_BW", roofline.HBM_BW)
    monkeypatch.setattr(jroofline, "ICI_BW", roofline.LINK_BW)
    assert roofline.Roofline(*terms).row() == jroofline.Roofline(*terms).row()
    for kind in ("train", "serve"):
        assert roofline.model_flops(1_100_048_384, 8192, kind) == \
            jroofline.model_flops(1_100_048_384, 8192, kind)


def test_roofline_constants_are_the_cards():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (
        989e12, 3.35e12, 450e9)
    assert roofline.FLOPS_BY_DTYPE == {"torch.bfloat16": 989e12,
                                       "torch.float16": 989e12,
                                       "torch.float32": 67e12}


def _records() -> list[dict]:
    rng = np.random.RandomState(0)
    recs = []
    for arch in ("tinyllama-1.1b", "qwen3-1.7b", "mamba2-2.7b"):
        for mesh in ("pod16x16", "pod2x16x16"):
            for opt in (False, True):
                t = rng.uniform(1e-6, 3.0, 3)
                bound = float(t.max())
                recs.append({
                    "arch": arch, "shape": "train_4k", "mesh": mesh,
                    "opt": opt, "mode": "fsdp_tp",
                    "roofline": {
                        "t_compute_s": t[0], "t_memory_s": t[1],
                        "t_collective_s": t[2], "t_bound_s": bound,
                        "dominant": ["compute", "memory", "collective"][
                            int(t.argmax())],
                        "useful_frac": rng.uniform(), "mfu_bound":
                            rng.uniform(), "roofline_frac": t[0] / bound},
                    "memory": {"argument_bytes": int(rng.randint(1, 2**34)),
                               "temp_bytes": int(rng.randint(1, 2**36))}})
    recs.append({"arch": "tinyllama-1.1b", "shape": "long_500k",
                 "mesh": "pod16x16", "opt": False, "skipped": "no"})
    return recs


@pytest.mark.parametrize("opt", [False, True], ids=["base", "opt"])
@pytest.mark.parametrize("mesh", ["pod16x16", "pod2x16x16"])
def test_report_table_is_jaxs(mesh, opt):
    recs = _records()
    assert report.table(recs, mesh, opt) == jreport.table(recs, mesh, opt)


@pytest.mark.parametrize("mesh", ["pod16x16", "pod2x16x16"])
def test_report_compare_and_candidates_are_jaxs(mesh):
    recs = _records()
    assert report.compare(recs, mesh) == jreport.compare(recs, mesh)
    assert report.candidates(recs, mesh) == jreport.candidates(recs, mesh)
    for x in (3.5, 0.25, 1.5e-3, 2e-5, 1e-9):
        assert report.fmt_s(x) == jreport.fmt_s(x)


def test_report_main_prints_jaxs_text(tmp_path, capsys, monkeypatch):
    for i, r in enumerate(_records()):
        (tmp_path / f"{i:02d}.json").write_text(json.dumps(r))
    for argv in ([], ["--opt"], ["--compare"], ["--mesh", "pod2x16x16"]):
        report.main(["--dir", str(tmp_path), *argv])
        got = capsys.readouterr().out
        monkeypatch.setattr("sys.argv", ["report", "--dir", str(tmp_path),
                                         *argv])
        jreport.main()
        assert got == capsys.readouterr().out


@pytest.mark.parametrize("arch", tconfigs.list_archs())
def test_padding_report_is_jaxs(arch):
    for shape, names in (((16, 16), ("data", "model")),
                         ((2, 16, 16), ("pod", "data", "model"))):
        jmesh = jax.sharding.AbstractMesh(shape, names)
        tmesh = dryrun.meta_mesh(shape, names)
        for mode in ("tp", "fsdp_tp"):
            want = jsharding.validate_divisibility(jconfigs.get(arch), jmesh,
                                                   mode)[:8]
            got = sharding.validate_divisibility(tconfigs.get(arch), tmesh,
                                                 mode)[:8]
            assert sorted(got) == sorted(want)


# ---------------------------------------------------------------------------
# the memory record
# ---------------------------------------------------------------------------

def test_argument_bytes_are_xlas(jax_args, clean_mesh):
    """SMOKE tinyllama train_4k (4 x 64) on 2x4: the largest coordinate's
    parameters, both f32 moments, the int32 step counter and its batch
    rows, byte for byte what XLA gives the per-device program."""
    cfg = tconfigs.get("tinyllama-1.1b", smoke=True)
    spec = shapes.input_specs(cfg, "train_4k", smoke=True)
    rec, _ = dryrun.cell_record(cfg, spec, dryrun.meta_mesh((2, 4)))
    want = jax_args.result(timeout=600)["argument_bytes"]
    assert rec["memory"]["argument_bytes"] == want
    assert rec["mode"] == "fsdp_tp"
    assert rec["padding_report"] == []
    parts = rec["memory"]["temp_parts"]
    assert rec["memory"]["temp_bytes"] == parts["saved_layer_inputs"] + max(
        parts["head_peak"], parts["gradients"] + parts["layer_peak"])
    # remat's saved inputs: 2 layers x coordinate 0's 2 rows x 64 x 128 bf16
    assert parts["saved_layer_inputs"] == 2 * 2 * 64 * 128 * 2


def test_temp_bytes_track_the_whole_step(clean_mesh):
    """The record's estimate against the whole SMOKE step traced on meta
    under the census (what the card's allocator would see) at 1x1: within
    15%, as `chip_smoke.py` holds it against the card."""
    cfg = tconfigs.get("tinyllama-1.1b", smoke=True)
    spec = shapes.input_specs(cfg, "train_4k", smoke=True)
    mesh = dryrun.meta_mesh((1, 1))
    rec, _ = dryrun.cell_record(cfg, spec, mesh)
    context.set_mesh_axes("data", "model", mesh)
    fn, in_specs, _, opt = steps.build_train_step(
        cfg, mesh, example_batch=spec.args[0])
    params = sharding.shard_model(lm.init_params(0, cfg, device="meta"),
                                  in_specs[0], mesh)
    state = opt.init(params)
    with census.Census() as c:
        fn(params, state, spec.args[0])
    temp = rec["memory"]["temp_bytes"]
    assert abs(temp - c.peak_bytes) <= 0.15 * c.peak_bytes, (temp,
                                                             c.peak_bytes)


# ---------------------------------------------------------------------------
# the census
# ---------------------------------------------------------------------------

B, S = 2, 32


def _layer_census(cfg, mesh, **kw):
    fn, args, _ = steps.build_layer_probe(cfg, mesh, seq=S, batch=B, **kw)
    placed = fn.place(*args)
    with census.Census() as c:
        fn(*placed, only=[0])
    return c, placed


def test_layer_probe_flops_are_the_products(clean_mesh):
    """tinyllama SMOKE at one query chunk: q, k, v, o, the scores, the
    probability-weighted sum and the three MLP products, 2 m n k each, and
    no more than XLA counts for JAX's probe (its count adds elementwise
    ops)."""
    cfg = dataclasses.replace(tconfigs.get("tinyllama-1.1b", smoke=True),
                              q_chunk=S, remat=False)
    d, hd, h, kv, ff = (cfg.d_model, cfg.head_dim, cfg.n_heads,
                        cfg.n_kv_heads, cfg.d_ff)
    t = B * S
    want = 2 * t * d * (h * hd + 2 * kv * hd) + 2 * t * h * hd * d \
        + 2 * 2 * B * h * S * S * hd + 3 * 2 * t * d * ff
    c, _ = _layer_census(cfg, dryrun.meta_mesh((1, 1)), kind="train",
                         with_grad=False)
    assert c.flops() == want
    counts = census.op_census(c)
    assert counts["mm"] == 7 and counts["bmm"] == 2
    jcfg = dataclasses.replace(jconfigs.get("tinyllama-1.1b", smoke=True),
                               q_chunk=S, remat=False)
    jmesh = jax.make_mesh((1, 1), ("data", "model"),
                          axis_types=(AxisType.Auto,) * 2)
    jctx.set_mesh_axes("data", "model", mesh=jmesh)
    try:
        with jmesh:
            fn, args, _ = jsteps.build_layer_probe(
                jcfg, jmesh, kind="train", seq=S, batch=B, with_grad=False)
            cost = fn.lower(*args).compile().cost_analysis()
    finally:
        jctx.clear()
    cost = cost[0] if isinstance(cost, (list, tuple)) else cost
    assert want <= cost["flops"]


def test_bytes_with_trailing_dims_finds_the_scores(clean_mesh):
    """The forward's materialised (S, S) scores: the logits, scaled,
    masked, softmaxed and the fully-masked rows zeroed, five f32 tensors
    of B x H x S x S; beside them only the (S, S) boolean masks."""
    cfg = dataclasses.replace(tconfigs.get("tinyllama-1.1b", smoke=True),
                              q_chunk=S, remat=False, dtype=torch.float32)
    c, _ = _layer_census(cfg, dryrun.meta_mesh((1, 1)), kind="train",
                         with_grad=False)
    scores = [op for op in c.ops if op.written and op.out_shapes
              and op.out_shapes[0][-2:] == (S, S)]
    f32 = [op for op in scores if op.out_dtypes[0] == "torch.float32"]
    assert len(f32) == 5
    assert all(op.written == B * cfg.n_heads * S * S * 4 for op in f32)
    assert all(op.out_dtypes[0] == "torch.bool" and op.written == S * S
               for op in scores if op not in f32)
    assert census.bytes_with_trailing_dims(c, S, S) == sum(
        op.written for op in scores)
    assert census.bytes_with_trailing_dims(c, S, S + 1) == 0


@pytest.mark.parametrize("mode", ["fsdp_tp", "tp"])
def test_collective_bytes_are_the_gathered_blocks(mode, clean_mesh):
    """On a 2x4 mesh coordinate (0, 0) gathers each layer weight whole:
    it reads every block another coordinate owns, once; its batch rows
    are its own."""
    cfg = tconfigs.get("tinyllama-1.1b", smoke=True)
    mesh = dryrun.meta_mesh((2, 4))
    c, placed = _layer_census(cfg, mesh, kind="train", with_grad=False,
                              mode=mode)
    want = sum(st.nbytes()[o] for st in sharding.sharded_tensors(
        placed[0]).values() for o in st.owners() if o != (0, 0))
    assert want > 0
    assert census.collective_bytes(c, (0, 0)) == {"all-gather": want}
    assert census.total_collective_bytes(c, (1, 0)) == 0  # not run


def test_peak_bytes_follow_frees():
    with census.Census() as c:
        a = torch.empty((1024,), device="meta")  # 4 KiB
        b = a * 2  # 4 KiB more
        del a
        d = b + 1  # a freed: the peak stays 8 KiB
        e = d.view(32, 32)  # a view: nothing new
    assert c.peak_bytes == 8192 and c.live_bytes == 8192
    del b, d, e
    assert c.live_bytes == 0
    muls = [op for op in c.ops if op.name == "mul"]
    assert muls[0].bytes == 8192 and muls[0].written == 4096
    assert [op.bytes for op in c.ops if op.name == "view"] == [0]


def test_census_flops_are_flop_counters():
    from torch.utils.flop_counter import FlopCounterMode

    x = torch.randn(3, 5, 7, requires_grad=True)
    w = torch.randn(7, 4, requires_grad=True)

    def f():
        (torch.einsum("bsd,df->bsf", x, w).sum() + (x @ w).sum()).backward()

    with FlopCounterMode(display=False) as fc:
        f()
    with census.Census() as c:
        f()
    assert c.flops() == fc.get_total_flops() > 0


# ---------------------------------------------------------------------------
# the MoE on the meta device
# ---------------------------------------------------------------------------

def _moe_meta(cfg, t: int):
    p = lm.init_params(0, dataclasses.replace(cfg, n_layers=1),
                       device="meta").layers[0].moe
    x = torch.empty((1, t, cfg.d_model), dtype=cfg.dtype, device="meta")
    return p, x


@pytest.mark.parametrize("shardmap", [False, True], ids=["moe", "shard_map"])
def test_meta_moe_models_the_kept_rows(shardmap, clean_mesh):
    """phi3.5-moe SMOKE at 64 tokens, top 2: every slot kept (64 <= 4096
    tokens, the capacity is T), spread over the experts: the experts'
    products are 2 * 3 * d * d_ff_expert * T * top_k, on one device or
    expert-parallel over a 2x4 mesh's model ranks."""
    cfg = tconfigs.get("phi3.5-moe-42b-a6.6b", smoke=True)
    t = 64
    p, x = _moe_meta(cfg, t)
    if shardmap:
        mesh = dryrun.meta_mesh((1, 4))
        context.set_mesh_axes("data", "model", mesh)
    fn = L.moe_shardmap if shardmap else L.moe
    with census.Census() as c:
        y, _ = fn(p, x, top_k=cfg.top_k)
    assert y.shape == x.shape and y.is_meta
    kept = t * cfg.top_k
    assert kept % cfg.n_experts == 0
    experts = sum(op.flops for op in c.ops if op.name == "bmm")
    assert experts == 2 * 3 * cfg.d_model * cfg.d_ff_expert * kept


def test_meta_moe_capacity_caps_the_rows():
    """Past 4096 tokens the capacity factor's slots: each expert takes at
    most ``cap`` rows."""
    cfg = tconfigs.get("phi3.5-moe-42b-a6.6b", smoke=True)
    t = 8192
    p, x = _moe_meta(cfg, t)
    with census.Census() as c:
        L.moe(p, x, top_k=cfg.top_k, capacity_factor=0.5)
    cap = L.capacity(t, cfg.top_k, cfg.n_experts, 0.5)
    kept = min(t * cfg.top_k, cfg.n_experts * cap)
    rows = min(-(-kept // cfg.n_experts), cap)
    assert sum(op.flops for op in c.ops if op.name == "bmm") == \
        2 * 3 * cfg.d_model * cfg.d_ff_expert * rows * cfg.n_experts


def test_cpu_moe_never_takes_the_meta_branch(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the meta branch on a CPU tensor")

    monkeypatch.setattr(L, "_modelled_experts", refuse)
    cfg = dataclasses.replace(tconfigs.get("phi3.5-moe-42b-a6.6b",
                                           smoke=True), dtype=torch.float32)
    p = lm.init_params(0, dataclasses.replace(cfg, n_layers=1),
                       device="cpu").layers[0].moe
    x = torch.randn(2, 8, cfg.d_model)
    y, _ = L.moe(p, x, top_k=cfg.top_k)
    assert torch.isfinite(y).all()


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

def test_dryrun_main_on_a_full_width_cell(tmp_path, capsys, clean_mesh):
    """tinyllama-1.1b decode_32k on the pod mesh (256 meta coordinates) in
    a few seconds, its trace kept; long_500k skipped with JAX's reason;
    then the report over the record."""
    dryrun.main(["--arch", "tinyllama-1.1b", "--shape", "decode_32k",
                 "--out", str(tmp_path), "--keep-trace"])
    out = capsys.readouterr().out
    assert "all dry-run cells passed" in out
    rec = json.loads((tmp_path / "tinyllama-1.1b_decode_32k_pod16x16.json"
                      ).read_text())
    assert rec["mode"] == "tp" and rec["trace_s"] > 0
    assert rec["memory"]["argument_bytes"] > 0
    assert rec["roofline"]["hlo_flops_dev"] > 0
    assert rec["probe"]["collective_by_kind"]["all-gather"] > 0
    assert (tmp_path / "tinyllama-1.1b_decode_32k_pod16x16.trace.txt"
            ).read_text().count(" mm ") > 0
    assert context.get_mesh() is None and context.devices("cpu") == [
        torch.device("cpu")]
    skipped = dryrun.run_cell("tinyllama-1.1b", "long_500k", False, tmp_path)
    assert skipped["skipped"] == (
        "pure full-attention arch skips long_500k (sub-quadratic required)")
    report.main(["--dir", str(tmp_path)])
    table = capsys.readouterr().out
    assert "| tinyllama-1.1b | decode_32k | tp |" in table
