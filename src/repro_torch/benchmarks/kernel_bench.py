"""Kernel micro-benchmarks of the port: each CUDA kernel against its plain
PyTorch version, at the JAX package's deployment shapes (B in {1, 256,
4096}; M = 10 templates, N = 784 features). Twin of the JAX package's
`benchmarks/kernel_bench.py`, with its rows under the same names.

Times are CUDA events on the card (the host clock on the CPU): the median
of ``iters`` calls after a warm-up, the kernel and its reference in turns
(kernel, reference, reference, kernel; each one's mean of its two), since
host clocks move up to 2x between calls.

``BENCH_torch_kernels.json`` (or ``--out PATH``) keeps the JAX schema, plus
``card`` and, in place of ``interpret``, ``kernels``::

    {"backend": "cuda" | "cpu",
     "kernels": "cuda" | "plain",  # the CUDA kernels, or (CPU tensors)
                                   # their plain versions
     "card": "NVIDIA H100 80GB HBM3, 700.00 W" | null,  # nvidia-smi
     "entries": [
       {"kernel": "acam_match",    # B7a | acam_similarity (B7b)
                                   # | acam_match_classify_fused (B1)
                                   # | acam_device_classify (RRAM physics)
                                   # | acam_match_serve (B3) /
                                   #   acam_similarity_serve (B6): ref_us =
                                   #   the compose tick (B4 / B5 + PyTorch)
                                   # | acam_similarity_classify_chunked (B6
                                   #   on the big bank; ref_us = the
                                   #   reference engine)
                                   # | acam_match_classify_sharded (B1 a
                                   #   shard under REPRO_FORCE_MESH;
                                   #   ref_us = the replicated call, plus
                                   #   bank_sharding / reduce /
                                   #   virtual_mesh)
        "b": 256, "m": 10, "n": 784,
        "ref_us": 123.4,           # plain version / reference engine
        "kernel_us": 4.5,          # the kernel path, us/call
        "speedup": 27.4,           # ref_us / kernel_us
        "ref_cell_matches_per_us": ..., "kernel_cell_matches_per_us": ...,
        "block": "local"}]}        # B7a / B7b only: the design taken

The raw `acam_match` / `acam_similarity` rows time the kernels directly
(their design from `repro_torch.kernels.tuning`); the ``*_classify*`` rows
go through `repro_torch.match.MatchEngine`, the path callers execute.
``--tune`` runs `tuning.autotune_acam` first; ``--smoke`` keeps B in {1,
256}. `run()` keeps the harness contract of `repro_torch.benchmarks.run`:
a list of ``{"name", "us_per_call", "derived"}`` rows.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess

import torch

from repro_torch.device import resolve
from repro_torch.kernels.tuning import time_us

BENCH_SHAPES = (1, 256, 4096)  # batch sizes; the paper bank is M=10, N=784
SMOKE_SHAPES = (1, 256)
M, N = 10, 784
N_SLOTS = 8
BIG_CLASSES, BIG_K = 1100, 2  # the big bank: past the fused-row budget
ITERS = 20


def card_name() -> str:
    """The card's name and power limit as `nvidia-smi` prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def turns(kernel, ref, device: torch.device,
          iters: int = ITERS) -> tuple[float, float]:
    """(kernel_us, ref_us) timed in turns (kernel, ref, ref, kernel), each
    the median of ``iters`` calls (`tuning.time_us`: CUDA events on a
    card, the host clock on the CPU)."""
    k1 = time_us(kernel, device, iters)
    r1 = time_us(ref, device, iters)
    r2 = time_us(ref, device, iters)
    k2 = time_us(kernel, device, iters)
    return (k1 + k2) / 2, (r1 + r2) / 2


def _compare_entry(kernel: str, b: int, m: int, n: int, ref_us: float,
                   kernel_us: float) -> dict:
    cells = b * m * n
    return {
        "kernel": kernel, "b": b, "m": m, "n": n,
        "ref_us": round(ref_us, 2), "kernel_us": round(kernel_us, 2),
        "speedup": round(ref_us / kernel_us, 4),
        "ref_cell_matches_per_us": round(cells / ref_us, 1),
        "kernel_cell_matches_per_us": round(cells / kernel_us, 1),
    }


def _binary(gen: torch.Generator, shape, p: float = 0.5) -> torch.Tensor:
    return (torch.rand(shape, generator=gen) > p).to(torch.float32)


def compare_kernels(batches=BENCH_SHAPES, *, iters: int = ITERS,
                    device=None) -> list[dict]:
    """Kernel-against-plain entries of both raw-score kernels (B7a, B7b),
    the fused classify (B1) and the device-physics backend, on ``device``
    (the card unless the caller asks for the CPU)."""
    from repro_torch import match
    from repro_torch.core import templates as T
    from repro_torch.kernels import tuning
    from repro_torch.kernels.acam_match import acam_match as am
    from repro_torch.kernels.acam_match import ops as match_ops
    from repro_torch.kernels.acam_similarity import acam_similarity as asim
    from repro_torch.kernels.acam_similarity import ops as sim_ops

    dev = resolve(device)
    gen = torch.Generator().manual_seed(0)
    thr = torch.zeros(N, device=dev)
    tmpl = _binary(gen, (M, N)).to(dev)
    lo = torch.zeros((M, N), device=dev)
    hi = _binary(gen, (M, N), 0.3).to(dev)
    bank = T.TemplateBank(templates=tmpl[:, None], lower=lo[:, None],
                          upper=hi[:, None],
                          valid=torch.ones((M, 1), dtype=torch.bool,
                                           device=dev),
                          thresholds=thr)
    eng_ref = match.engine_for(backend="reference")
    eng_ker = match.engine_for(backend="kernel")
    eng_dev = match.engine_for(backend="device")

    entries = []
    for b in batches:
        f = torch.randn((b, N), generator=gen).to(dev)
        it = max(3, iters // 4) if b >= 4096 else iters

        ker, ref = turns(lambda: match_ops.match_scores(f, thr, tmpl),
                         lambda: am.match_plain(f, thr, tmpl), dev, it)
        e = _compare_entry("acam_match", b, M, N, ref, ker)
        e["block"] = tuning.get_block("acam_match", (b, M, N), f.dtype, dev)
        entries.append(e)

        ker, ref = turns(lambda: sim_ops.similarity_scores(f, lo, hi),
                         lambda: asim.similarity_plain(f, lo, hi), dev, it)
        e = _compare_entry("acam_similarity", b, M, N, ref, ker)
        e["block"] = tuning.get_block("acam_similarity", (b, M, N), f.dtype,
                                      dev)
        entries.append(e)

        # end to end through the engine (what callers execute): the
        # reference backend against the kernel backend (B1) and the RRAM
        # device-physics backend
        ker, ref = turns(lambda: eng_ker.classify_features(f, bank),
                         lambda: eng_ref.classify_features(f, bank), dev, it)
        entries.append(_compare_entry("acam_match_classify_fused", b, M, N,
                                      ref, ker))
        dev_us, ref = turns(lambda: eng_dev.classify_features(f, bank),
                            lambda: eng_ref.classify_features(f, bank), dev,
                            it)
        entries.append(_compare_entry("acam_device_classify", b, M, N, ref,
                                      dev_us))
    return entries


def serve_entries(batches=BENCH_SHAPES, *, iters: int = ITERS,
                  device=None) -> list[dict]:
    """Mega-kernel against compose rows of the multi-tenant serve tick
    (`MatchEngine.classify_serve` with ``serve_fusion="mega"``, one B3 / B6
    launch, against ``"compose"``: B4 / B5 and PyTorch for the gather and
    the escalation), both on the kernel backend, so the speedup column is
    the fusion's gain. Then the big bank (`BIG_CLASSES` x 2 templates,
    past the fused-row budget): the similarity `classify_features_margin`
    on the kernel backend (B6) against the reference engine."""
    from repro_torch import match
    from repro_torch.core import templates as T

    dev = resolve(device)
    gen = torch.Generator().manual_seed(2)
    tmpl = _binary(gen, (M, 1, N)).to(dev)
    bank = T.TemplateBank(
        templates=tmpl, lower=torch.zeros_like(tmpl),
        upper=_binary(gen, (M, 1, N), 0.3).to(dev),
        valid=torch.ones((M, 1), dtype=torch.bool, device=dev),
        thresholds=torch.zeros(N, device=dev))
    thr_table = (torch.randn((N_SLOTS, N), generator=gen) * 0.1).to(dev)

    entries = []
    for b in batches:
        f = torch.randn((b, N), generator=gen).to(dev)
        slot = torch.randint(0, N_SLOTS, (b,), generator=gen,
                             dtype=torch.int32).to(dev)
        tau = torch.full((b,), 2.0, device=dev)
        it = max(3, iters // 4) if b >= 4096 else iters
        for method, name in (("feature_count", "acam_match_serve"),
                             ("similarity", "acam_similarity_serve")):
            mega, comp = (match.engine_from_config(match.EngineConfig(
                method=method, backend="kernel", serve_fusion=fusion))
                for fusion in ("mega", "compose"))
            mega_us, comp_us = turns(
                lambda e=mega: e.classify_serve(f, thr_table, slot, bank,
                                                tau=tau),
                lambda e=comp: e.classify_serve(f, thr_table, slot, bank,
                                                tau=tau), dev, it)
            entries.append(_compare_entry(name, b, M, N, comp_us, mega_us))

    big = _binary(gen, (BIG_CLASSES, BIG_K, N)).to(dev)
    big_bank = T.TemplateBank(
        templates=big, lower=torch.zeros_like(big),
        upper=torch.ones_like(big),
        valid=torch.ones((BIG_CLASSES, BIG_K), dtype=torch.bool,
                         device=dev),
        thresholds=torch.zeros(N, device=dev))
    eng_ref = match.engine_from_config(match.EngineConfig(
        method="similarity", backend="reference"))
    eng_ker = match.engine_from_config(match.EngineConfig(
        method="similarity", backend="kernel"))
    for b in batches[:2]:  # B 1 and 256, the JAX bench's big-bank rows
        f = torch.randn((b, N), generator=gen).to(dev)
        ker, ref = turns(
            lambda: eng_ker.classify_features_margin(f, big_bank),
            lambda: eng_ref.classify_features_margin(f, big_bank), dev,
            max(3, iters // 2))
        entries.append(_compare_entry("acam_similarity_classify_chunked", b,
                                      BIG_CLASSES * BIG_K, N, ref, ker))
    return entries


def sharded_classify_entries(batches=BENCH_SHAPES, *, classes: int = 512,
                             iters: int = ITERS, device=None) -> list[dict]:
    """The replicated-against-bank-sharded classify rows of the JAX bench:
    `MatchEngine.classify_features` over a ``classes``-row bank with the
    ``REPRO_FORCE_MESH`` mesh installed (class rows over "model", the
    batch over "data"; on one card a virtual mesh, its shards launched in
    turn) against the same engine replicated, in turns. No rows without a
    forced mesh, or when the model axis does not divide ``classes``."""
    from repro_torch import match
    from repro_torch.core import templates as T
    from repro_torch.distributed import context, forcemesh

    spec = forcemesh.env_spec()
    if spec is None:
        return []
    dev = resolve(device)
    mesh = forcemesh.install(spec, device=dev)
    # what the engine will do, not the mesh shape: a model axis that does
    # not divide `classes` runs bank-replicated
    plan, _ = match.plan_for(batch=batches[0], num_classes=classes)
    context.clear()
    if plan.bank_shards == 1:
        print(f"skipping sharded-classify rows: {classes} classes do not "
              f"shard over the {mesh.shape} mesh")
        return []
    gen = torch.Generator().manual_seed(1)
    tmpl = _binary(gen, (classes, 1, N)).to(dev)
    bank = T.TemplateBank(
        templates=tmpl, lower=torch.zeros_like(tmpl),
        upper=torch.ones_like(tmpl),
        valid=torch.ones((classes, 1), dtype=torch.bool, device=dev),
        thresholds=torch.zeros(N, device=dev))
    eng = match.engine_for(backend="kernel")

    def run(f, axes):
        context.clear()
        if axes:
            context.set_mesh_axes("data", "model", mesh)
        return eng.classify_features(f, bank)

    entries = []
    try:
        for b in batches:
            f = torch.randn((b, N), generator=gen).to(dev)
            it = max(3, iters // 4) if b >= 4096 else iters
            sharded_us, rep_us = turns(lambda: run(f, True),
                                       lambda: run(f, False), dev, it)
            e = _compare_entry("acam_match_classify_sharded", b, classes, N,
                               rep_us, sharded_us)
            e["bank_sharding"] = plan.bank_shards
            e["reduce"] = plan.reduce  # the merge the plan selected
            e["virtual_mesh"] = mesh.virtual
            entries.append(e)
    finally:
        context.clear()
    return entries


def write_bench_json(entries: list[dict],
                     path: str = "BENCH_torch_kernels.json", *,
                     device=None) -> None:
    dev = resolve(device)
    payload = {
        "backend": dev.type,
        # a wrapper runs its plain version on CPU tensors, its kernel on
        # CUDA ones: the device says which ran
        "kernels": "cuda" if dev.type == "cuda" else "plain",
        "card": card_name() if dev.type == "cuda" else None,
        "entries": entries,
    }
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)


def run(shapes=None, *, device=None,
        out: str = "BENCH_torch_kernels.json") -> list[dict]:
    """Every row, on ``device`` (the card unless the caller asks for the
    CPU), each timed over `ITERS` calls; ``shapes`` defaults to
    `SMOKE_SHAPES` under ``REPRO_BENCH_FAST=1``, else `BENCH_SHAPES` (the
    module's values at the call). Writes ``out``."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.kd_loss import kd_loss as kd
    from repro_torch.kernels.kd_loss.ref import kd_loss_ref
    from repro_torch.models.layers import chunked_attention

    dev = resolve(device)
    iters = ITERS
    if shapes is None:
        fast = os.environ.get("REPRO_BENCH_FAST", "0") == "1"
        shapes = SMOKE_SHAPES if fast else BENCH_SHAPES
    entries = compare_kernels(shapes, iters=iters, device=dev)
    entries += serve_entries(shapes, iters=iters, device=dev)
    entries += sharded_classify_entries(shapes, iters=iters, device=dev)
    write_bench_json(entries, out, device=dev)
    rows = []
    for e in entries:
        rows.append({
            "name": f"{e['kernel']}_b{e['b']}",
            "us_per_call": e["kernel_us"],
            "derived": (f"ref={e['ref_us']:.0f}us,speedup={e['speedup']:.2f},"
                        f"{e['kernel_cell_matches_per_us']:.0f} "
                        "cell-matches/us"),
        })

    gen = torch.Generator().manual_seed(0)
    zs = torch.randn((64, 32000), generator=gen).to(dev)
    zt = torch.randn((64, 32000), generator=gen).to(dev)
    y = torch.zeros((64,), dtype=torch.int32, device=dev)
    ker, us = turns(lambda: kd.kd_loss(zs, zt, y).mean(),
                    lambda: kd_loss_ref(zs, zt, y).mean(), dev, iters)
    rows.append({"name": "kd_loss_ref_64x32k", "us_per_call": us,
                 "derived": f"{64*32000*4/us/1e3:.1f} MB/ms logits,"
                            f"kernel={ker:.1f}us"})

    qq = torch.randn((1, 1024, 8, 64), generator=gen).to(dev, torch.bfloat16)
    kk = torch.randn((1, 1024, 2, 64), generator=gen).to(dev, torch.bfloat16)
    vv = torch.randn((1, 1024, 2, 64), generator=gen).to(dev, torch.bfloat16)
    ker, us = turns(lambda: fa_ops.attention(qq, kk, vv, causal=True),
                    lambda: chunked_attention(qq, kk, vv, causal=True), dev,
                    iters)
    flops = 2 * 2 * 1024 * 1024 * 8 * 64
    rows.append({"name": "chunked_attention_1k", "us_per_call": us,
                 "derived": f"{flops/us/1e3:.1f} MFLOP/ms,kernel={ker:.1f}us"})
    return rows


def main(argv=None, *, device=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tune", action="store_true",
                    help="autotune the kernels' designs before benchmarking")
    ap.add_argument("--smoke", action="store_true",
                    help="B in {1, 256} only")
    ap.add_argument("--out", default="BENCH_torch_kernels.json",
                    help="where to write the JSON")
    ap.add_argument("--device", default=device,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    shapes = SMOKE_SHAPES if args.smoke else BENCH_SHAPES
    if args.tune:
        from repro_torch.kernels import tuning
        for k, blk in tuning.autotune_acam(
                shapes=[(b, M, N) for b in shapes],
                device=args.device).items():
            print(f"tuned {k} -> {blk}")
    for r in run(shapes, device=args.device, out=args.out):
        print(r)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
