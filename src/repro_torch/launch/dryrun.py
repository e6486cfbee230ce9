"""Multi-pod dry run on the port: for every (architecture x input-shape x
mesh) cell, build the step on the production mesh and derive the
roofline terms, touching no card. The JAX package's
`repro/launch/dryrun.py`, which compiles each cell with XLA on 512 forced
host devices; the port works on the meta device instead (shapes and
dtypes, no memory, no values).

Per cell this driver:
  1. builds the full step (train / prefill / decode) with the sharded
     builders of `repro_torch.launch.steps` on the production mesh
     (`launch.mesh.make_production_mesh` over a forced list of 256 or 512
     meta devices), places the parameters, the optimizer state, the batch
     and, for decode, the cache as `ShardedTensor`s, and does not call the
     step: ``memory.argument_bytes`` is the largest coordinate's resident
     block bytes (JAX's ``argument_size_in_bytes`` of the per-device
     program);
  2. runs the loop-free single-layer probes (fwd, and fwd+bwd for train)
     plus the embed/head probe at one data coordinate's shapes under the
     op census (`repro_torch.analysis.census`), with ``q_chunk = seq``
     and ``remat = False`` as JAX does; totals follow JAX's arithmetic:
     with remat a layer is fwd + (fwd+bwd), ``n_layers`` times the layer
     plus the head, plus the analytic optimizer terms;
  3. takes the collective bytes from the census (what coordinate 0 reads
     from blocks other coordinates own);
  4. writes one JSON per cell into --out (default experiments/dryrun/),
     with JAX's keys (``cost_reported`` is the probes' own sum here, and
     ``trace_s`` stands where JAX has ``compile_s``).

What the record does not claim. The port computes each dense product over
"model" whole on the data coordinate's device (GSPMD splits it; a
tensor-parallel split is a ROADMAP item), so its per-device FLOPs, bytes
and collective bytes are the port's own, not GSPMD's split, and are not
comparable with the JAX dry run's per-device cost. The census counts
product FLOPs only and eager bytes (no fusion). ``memory.temp_bytes`` is
an estimate, not an allocator's figure: remat's saved layer inputs
(``n_layers`` x one layer's input) plus the larger of the head probe's
peak live bytes and coordinate 0's gradient blocks with the layer
probe's peak, that probe run at the cell's own ``q_chunk`` (the counting
probes' single chunk materialises every (S, S) score at once). The
roofline's rates are an H100 SXM's
(`repro_torch.analysis.roofline`): every time in a record is analysis,
not a measurement.

Usage (on the CPU; no card needed):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-14b --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --out experiments/dryrun
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time
import traceback

import numpy as np
import torch

from repro_torch import configs
from repro_torch.analysis import census as census_lib
from repro_torch.analysis import roofline as rl
from repro_torch.distributed import context as mesh_ctx
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import shapes as shapes_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.models import lm

OPT_FLOPS_PER_PARAM = 18.0  # AdamW update + global-norm clip (analytic)
OPT_BYTES_PER_PARAM = 22.0  # bf16 param rw + f32 mu/nu rw + grad read


#: beyond-baseline performance settings (§Perf hillclimb). Applied by --opt.
#: head padding is train/prefill-only: padded kv heads would inflate the
#: decode KV cache.
OPT_FLAGS = dict(precompute_rope=True, moe_impl="shard_map",
                 capacity_factor=1.0)
OPT_FLAGS_TRAIN = dict(head_pad_multiple=16)


def production_mesh(multi_pod: bool) -> mesh_ctx.Mesh:
    """The production mesh over 256 (512 for two pods) forced meta
    devices; `mesh_ctx.clear` drops the forced list."""
    n = 512 if multi_pod else 256
    mesh_ctx.force_devices([torch.device("meta")] * n)
    return mesh_lib.make_production_mesh(multi_pod=multi_pod, device="meta")


def meta_mesh(shape: tuple, axis_names=("data", "model")) -> mesh_ctx.Mesh:
    """A mesh of ``shape`` over the meta device."""
    return mesh_ctx.Mesh(np.full(shape, "meta", dtype=object).tolist(),
                         axis_names)


def choose_mode(cfg: lm.ArchConfig, kind: str, mesh) -> str:
    """JAX's rule: ZeRO-3 (fsdp_tp) to train; to serve, replicate over dp
    ("tp") when a model shard fits beside the cache, else fsdp_tp."""
    if kind == "train":
        return "fsdp_tp"
    model_shard_bytes = cfg.param_count() * 2 / mesh.shape["model"]
    return "tp" if model_shard_bytes <= 4.5e9 else "fsdp_tp"


def _resident(tensors: list) -> int:
    """The largest coordinate's bytes of ``tensors`` (`ShardedTensor`s)."""
    per: dict = {}
    for st in tensors:
        for c, n in st.nbytes().items():
            per[c] = per.get(c, 0) + n
    return max(per.values())


def _placed_step(cfg: lm.ArchConfig, spec: shapes_lib.CellSpecs, mesh,
                 mode: str) -> tuple[list, list]:
    """The step built on ``mesh`` and its operands placed (not called):
    (the parameters, every other `ShardedTensor` the step takes)."""
    model = lm.init_params(0, cfg, device="meta")
    if spec.kind == "train":
        _, in_specs, _, opt = steps_lib.build_train_step(
            cfg, mesh, mode=mode, example_batch=spec.args[0])
        params = sharding.shard_model(model, in_specs[0], mesh)
        state = opt.init(params)
        batch = sharding.place(spec.args[0],
                               sharding.to_shardings(in_specs[2], mesh))
        return list(sharding.sharded_tensors(params).values()), [
            *state.mu.values(), *state.nu.values(), state.step,
            *batch.values()]
    if spec.kind == "prefill":
        _, in_sp, _ = steps_lib.build_prefill_step(
            cfg, mesh, mode=mode, max_len=spec.seq,
            example_args=(model,) + spec.args)
    else:
        _, in_sp, _ = steps_lib.build_decode_step(
            cfg, mesh, mode=mode, example_args=(model,) + spec.args)
    params = sharding.shard_model(model, in_sp[0], mesh)
    ops = list(spec.args)
    if spec.kind == "decode":  # the cache: its tensor fields
        cache, cache_sp = ops.pop(), in_sp[2]
        ops += [getattr(cache, f) for f in lm.CACHE_FIELDS
                if getattr(cache, f) is not None]
        sps = list(in_sp[1:2]) + [getattr(cache_sp, f) for f in
                                  lm.CACHE_FIELDS
                                  if getattr(cache, f) is not None]
    else:
        sps = list(in_sp[1:])
    return list(sharding.sharded_tensors(params).values()), [
        sharding.NamedSharding(mesh, sp).place(x) for x, sp in zip(ops, sps)]


def _probe(fn, args, coord0) -> tuple[dict, census_lib.Census]:
    """One probe at coordinate 0 under the census -> (cost, census)."""
    placed = fn.place(*args)
    with census_lib.Census() as c:
        fn(*placed, only=[0])
    return {"flops": float(c.flops(coord0)), "bytes": float(c.bytes(coord0)),
            "peak_bytes": c.peak_bytes}, c


def cell_record(cfg: lm.ArchConfig, spec: shapes_lib.CellSpecs, mesh, *,
                mode: str | None = None) -> tuple[dict, census_lib.Census]:
    """The dry run of one cell on ``mesh`` (meta devices) -> (the record's
    ``mode``, ``memory``, ``cost_reported``, ``roofline``, ``probe``,
    ``padding_report``, ``trace_s``; the forward layer probe's census).
    Installs the mesh and clears it after."""
    mode = mode or choose_mode(cfg, spec.kind, mesh)
    chips = int(mesh.devices.size)
    t0 = time.time()
    mesh_ctx.set_mesh_axes(sharding.dp_axes(mesh), "model", mesh)
    try:
        # ---- 1. the full step: placed operands, the per-device bytes ----
        params, others = _placed_step(cfg, spec, mesh, mode)
        argument_bytes = _resident(params + others)
        coord0 = mesh.ranks(sharding.dp_axes(mesh), "model")[0][0]
        # the gradient blocks coordinate 0 owns (its share of the grads)
        owned = sum(st.nbytes()[c] for st in params for c in st.owners()
                    if c == coord0)
        del params, others

        # ---- 2. loop-free probes at one coordinate, under the census ----
        probe_cfg = dataclasses.replace(cfg, q_chunk=max(spec.seq, 1),
                                        remat=False)
        n_l = cfg.n_layers
        with_grad = spec.kind == "train"
        lay_kind = "train" if spec.kind != "decode" else "decode"
        fn, args, _ = steps_lib.build_layer_probe(
            probe_cfg, mesh, kind=lay_kind, seq=spec.seq, batch=spec.batch,
            mode=mode, with_grad=False)
        c_fwd, fwd = _probe(fn, args, coord0)
        coll_fwd = census_lib.total_collective_bytes(fwd, coord0)
        # (S, S) scores materialised by the probe's single chunk: the
        # flash kernel keeps them on chip; charged write + read and taken
        # off the memory term. FLOPs are unaffected.
        ss_fwd = census_lib.bytes_with_trailing_dims(fwd, spec.seq,
                                                     spec.seq, coord0)
        if cfg.ssm or cfg.hybrid:  # SSD chunk matrices, likewise
            ss_fwd += census_lib.bytes_with_chunk_pair(fwd, cfg.ssm_chunk,
                                                       coord0)
        layout_fwd = census_lib.bytes_of_layout_ops(fwd, coord0)
        if with_grad:
            fn, args, _ = steps_lib.build_layer_probe(
                probe_cfg, mesh, kind="train", seq=spec.seq,
                batch=spec.batch, mode=mode, with_grad=True)
            c_fb, fb = _probe(fn, args, coord0)
            coll_fb = census_lib.total_collective_bytes(fb, coord0)
            ss_fb = census_lib.bytes_with_trailing_dims(fb, spec.seq,
                                                        spec.seq, coord0)
            if cfg.ssm or cfg.hybrid:
                ss_fb += census_lib.bytes_with_chunk_pair(fb, cfg.ssm_chunk,
                                                          coord0)
            layout_fb = census_lib.bytes_of_layout_ops(fb, coord0)
            # remat: true per-layer = fwd (forward pass) + fwd+bwd
            layer_flops = c_fwd["flops"] + c_fb["flops"]
            layer_bytes_raw = c_fwd["bytes"] + c_fb["bytes"]
            layer_ss = 2.0 * (ss_fwd + ss_fb)
            layer_layout = 2.0 * (layout_fwd + layout_fb)  # write + re-read
            layer_coll = coll_fwd + coll_fb
            del fb
        else:
            layer_flops, layer_bytes_raw, layer_coll = (
                c_fwd["flops"], c_fwd["bytes"], coll_fwd)
            layer_ss = 2.0 * ss_fwd
            layer_layout = 2.0 * layout_fwd
        # memory term: take off (a) the (S, S) score materialisation and
        # (b) pure layout / conversion ops (a fused program keeps both out
        # of device memory), write + read charged; floor at 20%.
        layer_bytes = max(layer_bytes_raw - layer_ss - layer_layout,
                          0.2 * layer_bytes_raw)

        fn, args, _ = steps_lib.build_embed_head_probe(
            probe_cfg, mesh, kind=spec.kind, seq=spec.seq, batch=spec.batch,
            mode=mode, with_grad=with_grad)
        c_head, head = _probe(fn, args, coord0)
        coll_head = census_lib.total_collective_bytes(head, coord0)
        del head
        # the memory probe: the layer at the cell's own q_chunk (the
        # counting probes' single chunk materialises all (S, S) scores)
        fn, args, _ = steps_lib.build_layer_probe(
            dataclasses.replace(cfg, remat=False), mesh, kind=lay_kind,
            seq=spec.seq, batch=spec.batch, mode=mode, with_grad=with_grad)
        layer_peak = _probe(fn, args, coord0)[0]["peak_bytes"]

        n_params = cfg.param_count()
        # per-device totals (one data coordinate's share)
        flops = n_l * layer_flops + c_head["flops"]
        bytes_ = n_l * layer_bytes + c_head["bytes"]
        coll = n_l * layer_coll + coll_head
        if with_grad:
            flops += OPT_FLOPS_PER_PARAM * n_params / chips
            bytes_ += OPT_BYTES_PER_PARAM * n_params / chips

        tokens = spec.batch * (spec.seq if spec.kind != "decode" else 1)
        mf = rl.model_flops(
            cfg.active_param_count(), tokens,
            "train" if spec.kind == "train" else "serve")
        roof = rl.Roofline(flops_dev=flops, bytes_dev=bytes_,
                           coll_dev=float(coll), chips=chips,
                           model_flops=mf)
        # the step's temporaries, estimated: remat keeps each layer's
        # input for the backward (one coordinate's rows of (seq, d_model)
        # in the model's dtype); the head's backward runs first, the
        # layers' later, beside the gradients of every layer so far (at
        # most coordinate 0's owned blocks)
        rows = spec.batch // len(mesh.ranks(sharding.dp_axes(mesh)))
        saved = (n_l * max(rows, 1) * spec.seq * cfg.d_model
                 * cfg.dtype.itemsize) if with_grad and cfg.remat else 0
        grads = owned if with_grad else 0
        temp = saved + max(c_head["peak_bytes"], grads + layer_peak)
        rec = {
            "mode": mode,
            "memory": {"argument_bytes": int(argument_bytes),
                       "temp_bytes": int(temp),
                       "temp_parts": {
                           "saved_layer_inputs": int(saved),
                           "gradients": int(grads),
                           "layer_peak": int(layer_peak),
                           "head_peak": int(c_head["peak_bytes"])}},
            "cost_reported": {
                "flops": c_fwd["flops"] + (c_fb["flops"] if with_grad
                                           else 0.0) + c_head["flops"],
                "bytes": c_fwd["bytes"] + (c_fb["bytes"] if with_grad
                                           else 0.0) + c_head["bytes"]},
            "roofline": roof.row(),
            "probe": {
                "layer_flops": layer_flops, "layer_bytes": layer_bytes,
                "layer_bytes_raw": layer_bytes_raw,
                "layer_layout_bytes": layer_layout,
                "layer_score_materialization_bytes": layer_ss,
                "layer_collective_bytes": layer_coll,
                "head_flops": c_head["flops"], "head_bytes": c_head["bytes"],
                "head_collective_bytes": coll_head,
                "collective_by_kind": census_lib.collective_bytes(fwd,
                                                                  coord0),
                "op_census": census_lib.op_census(fwd, coord=coord0),
            },
            "padding_report": sharding.validate_divisibility(
                cfg, mesh, mode)[:8],
        }
        rec["trace_s"] = round(time.time() - t0, 1)
        return rec, fwd
    finally:
        mesh_ctx.clear()


def run_cell(arch: str, shape_id: str, multi_pod: bool, out_dir: pathlib.Path,
             *, keep_trace: bool = False, mode: str | None = None,
             opt: bool = False) -> dict:
    cfg = configs.get(arch)
    if opt:
        kind = shapes_lib.SHAPES[shape_id]["kind"]
        flags = dict(OPT_FLAGS)
        if kind in ("train", "prefill"):
            flags.update(OPT_FLAGS_TRAIN)
        cfg = dataclasses.replace(cfg, **flags)
    ok, reason = shapes_lib.applicable(cfg, shape_id)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    rec: dict = {"arch": arch, "shape": shape_id, "mesh": mesh_name,
                 "opt": opt}
    if not ok:
        rec["skipped"] = reason
        return rec

    spec = shapes_lib.input_specs(cfg, shape_id)
    mesh = production_mesh(multi_pod)
    body, fwd = cell_record(cfg, spec, mesh, mode=mode)
    rec.update(body)
    print(f"[{arch} x {shape_id} x {mesh_name}] traced in "
          f"{rec['trace_s']}s; memory={rec['memory']}")
    out_dir.mkdir(parents=True, exist_ok=True)
    suffix = "_opt" if opt else ""
    if keep_trace:
        coord0 = mesh.ranks(sharding.dp_axes(mesh), "model")[0][0]
        (out_dir / f"{arch}_{shape_id}_{mesh_name}{suffix}.trace.txt"
         ).write_text(fwd.text(coord0))
    path = out_dir / f"{arch}_{shape_id}_{mesh_name}{suffix}.json"
    path.write_text(json.dumps(rec, indent=1))
    r = rec["roofline"]
    print(f"    roofline: compute={r['t_compute_s']:.3e}s "
          f"memory={r['t_memory_s']:.3e}s collective={r['t_collective_s']:.3e}s "
          f"dominant={r['dominant']} useful={r['useful_frac']:.2f}")
    return rec


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--keep-trace", action="store_true",
                    help="also write the layer probe's op census")
    ap.add_argument("--mode", default=None, help="tp | fsdp_tp")
    ap.add_argument("--opt", action="store_true",
                    help="apply §Perf beyond-baseline settings (OPT_FLAGS)")
    args = ap.parse_args(argv)

    out_dir = pathlib.Path(args.out)
    archs = [args.arch] if args.arch else configs.list_archs()
    shape_ids = [args.shape] if args.shape else shapes_lib.SHAPE_IDS
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    failures = []
    for arch in archs:
        for shape_id in shape_ids:
            for mp in meshes:
                try:
                    run_cell(arch, shape_id, mp, out_dir,
                             keep_trace=args.keep_trace, mode=args.mode,
                             opt=args.opt)
                except Exception as e:  # noqa: BLE001 — report all cells
                    failures.append((arch, shape_id, mp, repr(e)))
                    print(f"FAIL [{arch} x {shape_id} x mp={mp}]: {e}")
                    traceback.print_exc()
    if failures:
        raise SystemExit(f"{len(failures)} dry-run cells failed: {failures}")
    print("all dry-run cells passed")


if __name__ == "__main__":
    main()
