#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`).

    python3 chip_smoke.py [--report PATH]   # on a machine with a CUDA card

Builds the CUDA kernels from `src/repro_torch/csrc/` (all four sources,
one nvcc each, in parallel) and drives the port on one CUDA card, with no
JAX:

 1. kernels   B1-B4 and B7a (`acam_match.cu`) against their plain PyTorch
              versions on the card, at the shapes the main paths give them
              plus ragged, empty-window, all-invalid, tie and flush-to-zero
              probes; all bit-identical, B1, B3, B4 and B7a under both
              designs of the tiled kernel (local and cooperative). All five
              also at their class-tile boundaries: ties between duplicate
              templates on both sides of every boundary, windows starting
              and ending on boundaries (B2, B3, B4), an all-invalid class, C
              and B not multiples of the tiles, K 1-4, N 64, 784 and 1000
              (B2 on 1,100 classes, the others on 100 and 130), the expected
              winners checked by row (B7a: its counts N in every tie
              column, at M = C K up to 520); B3 with tenant slots outside
              the thresholds table (-1, T, T + 5: zero thresholds) and -inf
              taus on padding rows. One kernel name per B1-B4 and B7a call
              in the profile; both designs of B1, B3, B4 and B7a timed in
              turns at the main shapes, B1's also on 16-, 32- and 64-row
              banks (where `LOCAL_ROWS` switches), and B3's wrapper timed
              step by step on the host. B5, B6 and B7b
              (`acam_similarity.cu`) likewise, on binary and dyadic windows
              at alpha 1.0 and 0.37 (bit-identical), at two B6 chunks, and
              on one non-dyadic real-window case (S and margin within
              rtol 1e-5, atol 1e-6; pred equal where the top-two gap
              exceeds 1e-5); B5 and B6 (the tiled kernel's similarity
              scorer) under both designs in every case, at the class-tile
              and item-group boundaries as B1-B4 (C 100 and 130, B6 also
              1,100; K 1-4, N 64 / 784 / 1000, winners checked by row), on
              a mixed bank of binary and dyadic rows and an all-wildcard
              [0, 1] bank (every class ties: pred 0), both designs timed
              in turns; one kernel name per B5 / B6 call in the profile;
              B6 also timed on the big bank (64, 1,100, 2, 784), B5 and B6
              also on real windows at those three shapes (every row
              through the float sum of D); B5 and B6 under both designs
              (B6 also on 1,100 classes) on banks with NaN bounds, equal to
              the plain versions with NaN in the same places. B7b (the
              register-tiled kernel) at one either side of its query,
              row and slice tiles under both tilings, B, M or N of 1 and
              N = 1000: bit-identical on binary and dyadic windows, within
              rtol 1e-5 / atol 1e-6 on real ones, with operands one float
              off alignment (4-byte staging) and with NaN bounds and a NaN
              query; timed at (256, 10, 784) and on the big bank as raw
              scores (64, 2,200, 784). B8 (`kd_loss.cu`) within rel 1e-4,
              abs 1e-5 at the trainer's (128, 10), the bench (64, 32000),
              the Qwen vocabulary (8, 152064) (all three timed), (13,
              5000) and (3, 17), bf16 logits, a T/alpha sweep and
              out-of-range labels; its split design at V 1, 17, 1025, 4999
              (unaligned rows), 32000 and 152064 (B 8 and 1) in f32, bf16
              and f16, labels on the first and last column of each split
              and the row maximum in each split in turn, a student buffer
              off the teacher's alignment, two calls bitwise equal. B9
              (`flash_attention.cu`) within 2e-3 in f32 (the FP32 route)
              at the JAX test shapes, D = 96 and the (BH, S, D) face, and
              within 2^-6 (at unit scale, relative
              above it) in bf16 and f16 (the tensor-core route) at every
              head dim 32-128, GQA groups 1, 2 and 8, causal and not,
              ragged and unequal Sq and Sk, the bench shape (1, 1024, 8, 2,
              64) and the model shape (1, 4096, 16, 8, 128);
              `ops.attention` against `layers.chunked_attention` on the
              card. Times (CUDA events, median of 60 after warm-up): the
              kernel and its library yardstick in turns (kernel, library,
              library, kernel; each one's mean and both device times), the
              plain version; the yardsticks: B1-B4 the bipolar
              `torch.matmul` score product alone, partial; B7a:
              `torch.addmm` of the bipolar operands, the whole count; B9:
              `scaled_dot_product_attention` with the kv heads expanded;
              B5, B6, B7b, B8: none, no PyTorch call computes Eq. 9-11 or
              Eq. 1; B8 also times a partial `torch.logsumexp`. Bounds:
              bytes against operations (`bound`, `sim_bound`, `kd_bound`,
              `fa_bound`); B5 and B6 on binary windows against two popc
              per 32 window cells.
 2. paths     each main path driven through the entry points a user calls,
              with the launch counts set to 0 just before and read just
              after: `HybridClassifier.predict` (B1) at paper width (the
              Fig. 5 student, 32x32x1 -> 784 features, 10 classes), the
              multi-tenant `HybridService` tick (B3; 8 tenants x 10
              classes, 64 slots, tau 8 counts), the same service under
              ``serve_fusion="compose"`` (B4), and
              `MatchEngine.classify_features` on a bank past
              `MAX_FUSED_ROWS` (B2, one launch, answers equal to the CPU
              run's). The served answers must equal the
              compose tick's and those of the same service on the CPU,
              where each kernel runs its plain version. The similarity
              method (Eq. 9-11): `predict` with a similarity head (B5, one
              launch), the similarity service booted from a spec file
              through the port's launcher `repro_torch.launch.serve.main`
              (B6; launches equal dispatches, answers equal the CPU run's),
              a similarity `classify_features_margin` past `MAX_FUSED_ROWS`
              (B6, one launch), and
              `ACAMHead.scores` for both methods (B7a, B7b).
              Training (§II) at full width, no depth cut: the ResNet
              teacher (width 16, 3 blocks per stage, 1 epoch at batch 128)
              on `synthetic.load("train", n_per_class=64)` in greyscale, then
              the Fig. 5 student with KD from its logits, curriculum, the
              prune ramp and fine-tune and QAT; every loss finite, the final
              sparsity Eq. 5's, the first step's gradients on the card
              within relative L2 1e-4 of the CPU's taken through the same
              ReLU and max-pool branches (TF32 off in the backward; the
              branches a near-zero pre-activation takes may differ between
              devices, which is reported), the first-step loss within
              1e-5, the int8 fake-quant grid bit-identical on the card
              and the CPU, then `fit_acam_head` and `predict` (B1) on the
              trained front end. B8's `distillation_loss` on the trained
              student's logits against the trainer's Eq. 1 (rel 1e-4), and
              B9's `ops.attention` at the bench shape against
              `chunked_attention`.
 3. device    the §III device-physics backend (`repro_torch.core.acam`,
              plain PyTorch on the card, no kernel): the launcher booted
              from a ``backend="device"`` spec (8 tenants x 10 classes, 64
              slots, 256 requests, tau 200 counts) for both cells at sigma_program 0 and
              0.05, bit-identical to the CPU at 0 (decisions equal and
              margins within 1e-6 at 0.05); the big bank's
              `classify_features_margin` equal to the CPU's, and
              `sweep_program_noise` (8 draws, "global" and "per_shard" over
              2 arrays) predicting as the CPU does draw by draw; `to_acam`
              and 20 steps of `calibrate_windows` with a falling loss. Tick
              and wall times, device time and idle share, and the bytes
              bound of one sense pass are reported.
 4. paper_eval the paper's evaluation: on the trained
              student's 640 training features, `kmeans`,
              `generate_templates` (k 2 and 3) and `select_k_by_silhouette`
              on the card against the CPU (assignments equal, a flip only at
              a tie and then printed and replayed; centroids within rtol
              1e-5; banks bit for bit; silhouette within 1e-5, the same
              best k); `predict` with K = 2 and 3 heads (B1, equal to its
              plain version); `repro_torch.benchmarks.run` at the
              REPRO_BENCH_FAST scale with its kernel bench at B 1 and 256
              (every number finite, the energy rows the analytic ones,
              Table I's parameters and MACs `cnn`'s); the tuning table's
              `autotune_acam` at (1 | 256, 10, 784) into a cache of its own
              (every candidate bit-identical, `get_block` the winner, each
              candidate's device time), every earlier phase having run on
              an empty cache (the designs it took before the table); and
              `quickstart.main(["--fast", "--mc", "4"])` (B1 and B3
              launched, every number finite).
 5. control_plane  the single-card control plane at paper width (N 784,
              8 seeded tenants x 10 classes in the 128-class bank, k_max
              2, 64 slots): `apply_manifest` equal to imperative
              registration; `reconfigure` through slots 64 -> 32 -> 64,
              mega -> compose, feature count -> similarity (compose, then
              mega), the kernel -> the device backend at sigma 0 and a tau
              change, each answering its drained requests as a fresh build
              of the old spec does and the next ones as a fresh build of
              the new spec (B3, B4 and B6 launched); a blocking and an
              async snapshot, the service dropped and restored, answers
              bit-identical to a twin never killed, and the same snapshot
              restored on the CPU answering the same; half the tenants
              evicted and `compact` (every `bank_of` and answer
              unchanged); the `Autopilot` widening the slots over a
              saturating trace (its shard escalation blocked on one card)
              with every request answered once; `serving_bench` at smoke
              size; and training as a function of its seed
              (`training_repeatability`: the teacher and the 22-step
              student twice from one seed, every parameter and BN buffer
              bitwise equal, the first step and tensors at which two runs
              without the deterministic mode part, and the student's
              device time with the mode against without it). Times:
              reconfigure downtime per transition, `apply_manifest`, the
              snapshot writes, `recovery_ms`, `compact`, the bench's rows.
 6. report    the card's name and power limit, metrics and the energy
              split, the training step's time, device time and idle share,
              the paper's tables and the tuning winners, the control
              plane's numbers, one ``{"kernels": [...]}`` line (ten
              kernels), and as the last line ``{"ok": true, "device":
              {...}}``. ``--report PATH`` also writes every measurement to
              PATH as JSON, the tables' `bench_details.json` and
              `BENCH_torch_kernels.json` beside it in ``paper_eval/``, and
              the serving bench's `BENCH_torch_serving.json` and the
              snapshots in ``control_plane/``.

Every failed check raises, so the run exits non-zero. Without a CUDA card,
or without the repository beside it, it exits non-zero before any result.
"""
from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

# the trainer's deterministic mode needs cuBLAS's workspace setting before
# the process's first cuBLAS handle exists, long before the training phases
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

ROOT = Path(__file__).resolve().parent
CSRC = "src/repro_torch/csrc"
MATCH_SRC = f"{CSRC}/acam_match.cu"
SIM_SRC = f"{CSRC}/acam_similarity.cu"
KD_SRC = f"{CSRC}/kd_loss.cu"
FA_SRC = f"{CSRC}/flash_attention.cu"
SOURCES = ("acam_match", "acam_similarity", "kd_loss", "flash_attention")
MATCH_TPU = "src/repro/kernels/acam_match/acam_match.py"
SIM_TPU = "src/repro/kernels/acam_similarity/acam_similarity.py"
KD_TPU = "src/repro/kernels/kd_loss/kd_loss.py"
FA_TPU = "src/repro/kernels/flash_attention/flash_attention.py"
# kernel -> (its CUDA source, file:line of the TPU kernel's pallas_call)
KERNELS = {
    "acam_match_classify": (MATCH_SRC, f"{MATCH_TPU}:204"),  # B1
    "acam_match_classify_margins": (MATCH_SRC, f"{MATCH_TPU}:302"),  # B4
    "acam_match_classify_margins_chunked": (MATCH_SRC,
                                            f"{MATCH_TPU}:418"),  # B2
    "acam_match_serve": (MATCH_SRC, f"{MATCH_TPU}:575"),  # B3
    "acam_match": (MATCH_SRC, f"{MATCH_TPU}:126"),  # B7a
    "acam_similarity_classify": (SIM_SRC, f"{SIM_TPU}:195"),  # B5
    "acam_similarity_serve": (SIM_SRC, f"{SIM_TPU}:344"),  # B6
    "acam_similarity": (SIM_SRC, f"{SIM_TPU}:101"),  # B7b
    "kd_loss": (KD_SRC, f"{KD_TPU}:112"),  # B8
    "flash_attention": (FA_SRC, f"{FA_TPU}:90"),  # B9
}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
INT8_OPS_PER_S = 1.979e15  # H100 SXM dense int8 tensor rate
# FP32 / int instructions per second outside the tensor cores: 132 SMs x
# 128 lanes x 1.98 GHz, the 67 TFLOP/s FP32 peak with an FMA counted once
INSTR_PER_S = 33.5e12
SIM_INSTR_PER_CELL = 10  # Eq. 9-11 per (query, template row, feature)
# popc per second: 132 SMs x 16 per clock x 1.98 GHz (B5 and B6 on binary
# windows count hits with two popc per 32 (query, row, feature) cells)
POPC_PER_S = 4.18e12
# dense tensor-core rates for 16-bit operands, and FP32 outside them
FLOPS_PER_S = {"torch.bfloat16": 989e12, "torch.float16": 989e12,
               "torch.float32": 67e12}
# special-function (exp) rate: 132 SMs x 16 per clock x 1.98 GHz
SFU_PER_S = 4.18e12
KD_RTOL, KD_ATOL = 1e-4, 1e-5  # the JAX package's kd_loss test tolerance
FA_TOL_F32 = 2e-3  # the JAX package's flash attention test tolerance
# bf16: 2^-6 at unit scale and relative above it (about 4 ulps of bf16's
# 2^-8 unit roundoff); p is rounded to bf16 in both the kernel (at each
# tile's running max) and the plain version (at the row's), and the output
# is rounded to bf16
FA_TOL_BF16 = 2.0 ** -6
GRAD_RTOL = 1e-4  # card vs CPU, relative L2 per gradient tensor
N = 784  # Fig. 5 features
ITERS = 60
TENANTS = 8
# the similarity service's cascade threshold in match-count units (tau / N
# in Eq. 11 units): inside the served margins, so some requests escalate
SIM_TAU = 12.0


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def time_ms(fn, iters: int = ITERS) -> float:
    """Median per-call time with CUDA events (host launch cost included)."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def host_us(fn, calls: int = 200) -> float:
    """Host time per call in microseconds: ``calls`` calls enqueued back to
    back (no synchronisation between them), after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return host


def interleaved(kernel, library, iters: int = ITERS) -> dict:
    """A kernel and its library yardstick timed in turns (kernel, library,
    library, kernel) with `time_ms`, then each traced once for its device
    time and timed on the host alone (`host_us`): ms / library_ms are the
    means of each one's two runs."""
    k1 = time_ms(kernel, iters)
    l1 = time_ms(library, iters)
    l2 = time_ms(library, iters)
    k2 = time_ms(kernel, iters)
    return dict(ms=(k1 + k2) / 2, ms_runs=[k1, k2],
                library_ms=(l1 + l2) / 2, library_ms_runs=[l1, l2],
                library_device_ms=profile(library, reps=20)["device_ms"],
                host_us=host_us(kernel), library_host_us=host_us(library))


#: the profiles taken a second time (see `profile`): the caller and the
#: kernels that launched in each empty session
PROFILE_RETRIES: list = []


def launch_counts() -> dict:
    """Every kernel wrapper's launch count (`launch_modules`)."""
    return {k: v for mod in launch_modules() for k, v in mod.LAUNCHES.items()}


def profile(fn, reps: int = 1, retries: int = 2) -> dict:
    """`torch.profiler` over ``reps`` calls of ``fn`` (after one warm-up),
    per call: wall time, summed device time of every kernel and copy, the
    device's idle share of the wall time, and the device time per kernel
    name (top 8). Device times are None when the profiler recorded none.
    A session that recorded no device event at all while a kernel of the
    port launched (its wrapper's count rose) is taken again, up to
    ``retries`` times (two empty sessions in a row have happened on the
    card): each time the calling function and the kernels that launched
    go to `PROFILE_RETRIES` (the report lists them) and the result is
    marked ``retried``."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    before = launch_counts()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    launched = sorted(k for k, v in launch_counts().items()
                      if v > before.get(k, 0))
    by_name = {}
    for evt in prof.key_averages():
        dt = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
        if dt > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.key] = by_name.get(evt.key, 0.0) + dt / 1e3 / reps
    busy = sum(by_name.values())
    if not busy and retries and launched:
        caller = sys._getframe(1)
        while caller.f_code.co_name == "profile":
            caller = caller.f_back
        PROFILE_RETRIES.append(dict(caller=caller.f_code.co_name,
                                    launched=launched))
        return dict(profile(fn, reps, retries - 1), retried=True)
    return dict(wall_ms=wall_ms, device_ms=busy or None,
                idle_share=1 - busy / wall_ms if busy else None,
                by_kernel=dict(sorted(by_name.items(),
                                      key=lambda kv: -kv[1])[:8]))


# ---------------------------------------------------------------------------
# 1. kernels against their plain versions
# ---------------------------------------------------------------------------

def case(seed: int, b: int, c: int, k: int, n: int, device, *,
         t_rows: int = 8):
    """Random operands of one call: features, thresholds, a (C, K, N) {0,1}
    bank with ~80% valid rows, per-row windows (row 0 empty), tenant slots,
    and a thresholds table."""
    import torch

    rng = np.random.default_rng(seed)

    def dev(x):
        return torch.as_tensor(x, device=device)

    lo = rng.integers(0, max(c - 4, 1), size=b)
    hi = np.minimum(lo + rng.integers(1, c + 1, size=b), c)
    hi[0] = lo[0]
    return dict(
        f=dev(rng.standard_normal((b, n), dtype=np.float32)),
        thr=dev(rng.standard_normal(n, dtype=np.float32) * 0.1),
        t=dev((rng.random((c, k, n)) > 0.5).astype(np.float32)),
        valid=dev(rng.random((c, k)) > 0.2),
        lo=dev(lo.astype(np.int32)), hi=dev(hi.astype(np.int32)),
        table=dev(rng.standard_normal((t_rows, n), dtype=np.float32) * 0.1),
        slot=dev(rng.integers(0, t_rows, size=b).astype(np.int32)))


def faces(x: dict, c: int, k: int):
    """Each face's (wrapper, plain, args, kwargs) on one case."""
    import torch

    from repro_torch.kernels import layout
    from repro_torch.kernels.acam_match import acam_match as am
    from repro_torch.match import MAX_FUSED_ROWS

    cp = layout.padded_classes(c)
    chunk = layout.class_chunk(cp, k, MAX_FUSED_ROWS)
    t_km = layout.flatten_kmajor(x["t"], c)
    v_km = layout.valid_kmajor(x["valid"], c)
    t_kcp = layout.stack_kcp(x["t"], c)
    v_kcp = layout.valid_kcp(x["valid"], c)
    margins = am.serve_plain(x["f"], x["table"], x["slot"], t_kcp, v_kcp,
                             x["lo"], x["hi"], torch.zeros_like(x["f"][:, 0]),
                             c, chunk=chunk)[2]
    sign = torch.where(torch.arange(len(margins), device=margins.device) % 2
                       == 0, 0.5, -0.5)
    tau = (margins + sign).to(torch.float32)  # straddles every margin
    return {
        "acam_match_classify": (
            am.acam_match_classify, am.classify_plain,
            (x["f"], x["thr"], t_km, v_km, c), {}),
        "acam_match_classify_margins": (
            am.acam_match_classify_margins, am.classify_margins_plain,
            (x["f"], x["thr"], t_km, v_km, x["lo"], x["hi"], c), {}),
        "acam_match_classify_margins_chunked": (
            am.acam_match_classify_margins_chunked,
            am.classify_margins_chunked_plain,
            (x["f"], x["thr"], t_kcp, v_kcp, x["lo"], x["hi"], c),
            {"chunk": chunk}),
        "acam_match_serve": (
            am.acam_match_serve, am.serve_plain,
            (x["f"], x["table"], x["slot"], t_kcp, v_kcp, x["lo"], x["hi"],
             tau, c), {"chunk": chunk}),
        # raw (B, C * K) counts over the class-major flattened bank
        "acam_match": (
            lambda *a: (am.acam_match(*a),), lambda *a: (am.match_plain(*a),),
            (x["f"], x["thr"], x["t"].reshape(-1, x["t"].shape[-1])), {}),
    }


def compare(name: str, got, want) -> float:
    """Bit-identity of every output; returns the max |diff| of the finite
    float outputs (0.0 when identical)."""
    import torch

    err = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"{name} output {i}: {g.shape}/{g.dtype} vs {w.shape}/{w.dtype}")
        if g.dtype.is_floating_point:
            both = torch.isfinite(g) & torch.isfinite(w)
            if both.any():
                err = max(err, float((g[both] - w[both]).abs().max()))
        check(torch.equal(g, w), f"{name} output {i} differs from its plain "
              f"version (max |diff| {err})")
    return err


def bound(name: str, b: int, c: int, k: int, n: int, t_rows: int):
    """Least time for the call on an H100 SXM: the bytes it must move (each
    input read once, each output written once; templates counted for the C
    true classes) over 3.35 TB/s, against its B*K*C*N cell matches as two
    int8 operations each over 1,979 TOP/s. Returns (ms, bound_by, bytes)."""
    nbytes = b * n * 4 + k * c * n * 4 + k * c * 4 + b * 4 + b * c * 4
    if name == "acam_match":  # features, thresholds, templates, counts out
        nbytes = b * n * 4 + n * 4 + k * c * n * 4 + b * k * c * 4
    elif name == "acam_match_serve":
        nbytes += t_rows * n * 4 + b * 4 + 2 * b * 4 + b * 4 + b * 4 + b
    else:
        nbytes += n * 4
        if name != "acam_match_classify":
            nbytes += 2 * b * 4 + b * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * b * k * c * n / INT8_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes)


#: the faces of the tiled kernel whose design `LOCAL_ROWS` picks
DESIGN_FACES = ("acam_match_classify", "acam_match_serve",
                "acam_match_classify_margins", "acam_match")
#: `acam_match.LOCAL_ROWS` forcing each design of the tiled kernel
DESIGNS = {"local": 1 << 30, "cooperative": 0}


@contextlib.contextmanager
def design(name: str):
    """The `DESIGN_FACES` forced onto one design of the tiled kernel
    ("default": the one `acam_match.LOCAL_ROWS` picks)."""
    from repro_torch.kernels.acam_match import acam_match as am

    keep = am.LOCAL_ROWS
    am.LOCAL_ROWS = DESIGNS.get(name, keep)
    try:
        yield
    finally:
        am.LOCAL_ROWS = keep


def tile_probes(device, similarity: bool = False) -> dict:
    """B2 and the `DESIGN_FACES` (``similarity``: B5 and B6, the
    `SIM_DESIGN_FACES`, on binary windows) bit-identical to their plain
    versions where the tiled kernel's class tiles (`acam_match.CLASS_TILE`
    classes by `QUERY_TILE` queries) and item groups (8 tiles for the
    count, 4 for the similarity) could go wrong: exact ties between
    duplicate templates on both sides of every class-tile boundary, windows
    that start and end on boundaries (B2, B3, B4, B6), an all-invalid class,
    C not a multiple of the class tile and B not one of the query tile, for
    K 1-4 and N 64, 784 and 1000 (not a multiple of 32); B2 or B6 on a
    1,100-class bank (35 tiles), the others at C 100 and 130 (130: past one
    similarity group) under both designs. Rows 1-10 share one query (and,
    for B3 and B6, one slot), which classes e - 1 and e of every boundary e
    match exactly (template or window [q, q]: the full score, N or N
    inv_n); their decisions are checked by row. The similarity runs at
    alpha 1.0 (K even) and 0.37 (K odd). B7a counts the class-major (C K,
    N) bank, whose own tiles run over its M = C K rows: rows e - 1 and e of
    every boundary e there duplicate the query too, and every tie column of
    rows 1-10 must count N. Returns the number of cases per face."""
    import torch

    from repro_torch.kernels.acam_match import acam_match as am
    from repro_torch.kernels.acam_similarity.ref import inv_n

    ct = am.CLASS_TILE
    b = 2 * am.QUERY_TILE + 5
    check(b % am.QUERY_TILE != 0, "ragged probe batch")
    if similarity:
        big, names, seed0, fields = ("acam_similarity_serve",
                                     SIM_DESIGN_FACES, 800, ("lower", "upper"))
    else:
        big, names, seed0, fields = ("acam_match_classify_margins_chunked",
                                     DESIGN_FACES, 700, ("t",))
    runs = [(big, 1100, "default")]
    runs += [(face, c, how) for face in names for c in (100, 130)
             for how in DESIGNS]
    cases = {}
    for name, c, how in runs:
        check(c % ct != 0, "ragged probe bank")
        edges = list(range(ct, c, ct))
        ties = [e - 1 for e in edges] + edges
        last = edges[-1]
        # row: (window, expected pred, expected margin or None)
        rows = {1: ((0, c), ct - 1, 0.0), 2: ((ct, 2 * ct), ct, 0.0),
                3: ((ct - 1, ct + 1), ct - 1, 0.0),
                4: ((ct + 1, 2 * ct), 2 * ct - 1, None),
                5: ((last, c), last, None), 6: ((ct, ct), 0, 0.0),
                7: ((ct + 5, ct + 6), 0, 0.0),  # class ct + 5: all invalid
                8: ((0, ct), ct - 1, None), 9: ((2 * ct, last), 2 * ct, 0.0),
                10: ((last - 1, last + 1), last - 1, 0.0)}
        for k in (1, 2, 3, 4):
            for n in (64, 784, 1000):
                seed = seed0 + 10 * k + n + c
                x = (sim_case(seed, b, c, k, n, device, "binary")
                     if similarity else case(seed, b, c, k, n, device))
                x["f"][1:len(rows) + 1] = x["f"][1]
                x["slot"][1:len(rows) + 1] = 0
                x["table"][0] = x["thr"]
                q1 = (x["f"][1] > x["thr"]).to(torch.float32)
                for e in ties:
                    for field in fields:
                        x[field][e] = q1
                    x["valid"][e] = True
                x["valid"][ct + 5] = False
                # B7a's columns of the tie classes' templates
                tie_cols = {e * k + kk for e in ties for kk in range(k)}
                if name == "acam_match":  # ties on B7a's own tile edges
                    for e in range(ct, c * k, ct):
                        x["t"].view(-1, n)[e - 1:e + 1] = q1
                        tie_cols |= {e - 1, e}
                for row, ((lo, hi), _, _) in rows.items():
                    x["lo"][row], x["hi"][row] = lo, hi
                for row in range(len(rows) + 1, b):  # windows on tile edges
                    lo = edges[row % len(edges)] * (row % 2)
                    x["lo"][row] = lo
                    x["hi"][row] = min(c, lo + ct * (1 + row % 5))
                if similarity:
                    alpha = 1.0 if k % 2 == 0 else 0.37
                    face = sim_faces(x, c, k, alpha)[name]
                    full = float(np.float32(n) * np.float32(inv_n(n)))
                else:
                    face, full = faces(x, c, k)[name], n
                wrapper, plain, args, kw = face
                label = f"{name} tile probe ({how}) C={c} K={k} N={n}"
                with design(how):
                    got = wrapper(*args, **kw)
                compare(label, got, plain(*args, **kw))
                cases[name] = cases.get(name, 0) + 1
                if name == "acam_match":
                    check(bool((got[0][1:len(rows) + 1][:, sorted(tie_cols)]
                                == n).all()), f"{label}: tie columns not N")
                    continue
                pred, per_class = got[0].tolist(), got[1]
                margins = got[2].tolist() if len(got) > 2 else None
                for row, (_, want_pred, want_margin) in rows.items():
                    if name.endswith("_classify"):  # B1, B5: no windows
                        want_pred, want_margin = ct - 1, None
                        check(bool((per_class[row, ties] == full).all())
                              and per_class[row, ct + 5] == -np.inf,
                              f"{label} row {row}: tie classes not {full}")
                    margin = margins[row] if margins else None
                    check(pred[row] == want_pred and
                          want_margin in (None, margin),
                          f"{label} row {row}: {pred[row]}/{margin}, "
                          f"expected {want_pred}/{want_margin}")
    return cases


def slot_probes(device) -> int:
    """B3 with tenant slots outside the thresholds table (-1, T, T + 5: zero
    thresholds, as the TPU kernel's one-hot select reads), taus straddling
    every margin and -inf on padding rows, under both designs at the serve
    tick's bank and a one-tile bank. Bit-identical to the plain version;
    out-of-table rows count f > 0, padding rows never escalate. Returns the
    number of cases."""
    import torch

    from repro_torch.kernels import layout
    from repro_torch.kernels.acam_match import acam_match as am

    t_rows, cases = 8, 0
    for b, c, k in ((64, 128, 2), (21, 10, 1)):
        x = case(900 + c, b, c, k, N, device, t_rows=t_rows)
        out_of_table = torch.arange(b, device=device) % 4 == 1
        x["slot"][out_of_table] = torch.tensor(
            [-1, t_rows, t_rows + 5], dtype=torch.int32,
            device=device).repeat(b)[:int(out_of_table.sum())]
        wrapper, plain, args, kw = faces(x, c, k)["acam_match_serve"]
        args = list(args)
        padding = torch.arange(b, device=device) >= b - 5
        args[7] = torch.where(padding, float("-inf"), args[7])
        want = plain(*args, **kw)
        zero_thr = am.classify_plain(
            x["f"], torch.zeros(N, device=device),
            layout.flatten_kmajor(x["t"], c), layout.valid_kmajor(
                x["valid"], c), c)[1]
        for how in DESIGNS:
            label = f"acam_match_serve slot probe ({how}) C={c}"
            with design(how):
                got = wrapper(*args, **kw)
            compare(label, got, want)
            check(torch.equal(got[1][out_of_table], zero_thr[out_of_table]),
                  f"{label}: an out-of-table slot did not read zeros")
            check(not bool(got[3][padding].any()),
                  f"{label}: a padding row escalated")
            check(bool(got[3].any()) and not bool(got[3].all()),
                  f"{label}: taus straddle the margins")
            cases += 1
    return cases


def kernel_phase(device) -> dict:
    import torch

    from repro_torch.kernels import layout
    from repro_torch.kernels.acam_match import acam_match as am

    # (b, c, k, n): main-path shapes first (timed), then edge cases
    main_shapes = {
        "acam_match_classify": (256, 10, 1, N),  # HybridClassifier.predict
        "acam_match_classify_margins": (64, 128, 2, N),  # compose tick
        "acam_match_classify_margins_chunked": (64, 1100, 2, N),  # big bank
        "acam_match_serve": (64, 128, 2, N),  # serving tick
        "acam_match": (256, 10, 1, N),  # ACAMHead.scores
    }
    edge_shapes = [(37, 30, 2, 300), (1, 1, 1, 1), (200, 257, 3, 1000),
                   (16, 12, 4, 64), (16, 1100, 2, 64)]
    out = {}
    for seed, (name, (b, c, k, n)) in enumerate(main_shapes.items()):
        x = case(seed, b, c, k, n, device)
        wrapper, plain, args, kw = faces(x, c, k)[name]
        err = compare(name, wrapper(*args, **kw), plain(*args, **kw))
        q_pm = (x["f"] > x["thr"]).float() * 2 - 1
        ms, by, nbytes = bound(name, b, c, k, n, 8)
        if name == "acam_match":
            # the whole count: (N + Q~ . T~^T) / 2 in one call
            t_pm = x["t"].reshape(-1, n) * 2 - 1
            half_n = torch.tensor(n * 0.5, device=device)
            check(torch.equal(torch.addmm(half_n, q_pm, t_pm.T, alpha=0.5),
                              wrapper(*args, **kw)[0]),
                  "acam_match: torch.addmm yardstick computes another "
                  "function")
            library = (lambda: torch.addmm(half_n, q_pm, t_pm.T, alpha=0.5),
                       "torch.addmm of the bipolar operands (the whole "
                       "count; binarising not included)")
        else:
            t_pm = layout.flatten_kmajor(x["t"], c) * 2 - 1
            library = (lambda: torch.matmul(q_pm, t_pm.T),
                       "torch.matmul bipolar score product only (partial)")
        out[name] = dict(
            shape=dict(B=b, C=c, K=k, N=n), max_abs_err=err,
            **interleaved(lambda: wrapper(*args, **kw), library[0]),
            plain_ms=time_ms(lambda: plain(*args, **kw)),
            library_call=library[1],
            bound_ms=ms, bound_by=by, bound_bytes=nbytes,
            profile=profile(lambda: wrapper(*args, **kw), reps=20))
        if name in DESIGN_FACES or name.endswith("_chunked"):
            kernels_seen = out[name]["profile"]["by_kernel"]
            check(len(kernels_seen) == 1, f"{name}: one kernel per call, "
                  f"the profile shows {list(kernels_seen)}")
        if name in DESIGN_FACES:
            out[name]["design"] = ("local" if k * c <= am.LOCAL_ROWS
                                   else "cooperative")
            out[name]["designs"] = design_times(wrapper, plain, args, kw,
                                                name)
        if name == "acam_match_serve":
            out[name]["host_steps"] = host_steps(x, b, c, k, n, library[0])
    # both designs where `LOCAL_ROWS` puts the crossover: banks of 16, 32
    # and 64 template rows (K * C) at the predict shape
    for name, (b, c, k, n) in (("acam_match_classify", (256, 16, 1, N)),
                               ("acam_match_classify", (256, 32, 1, N)),
                               ("acam_match_classify", (256, 32, 2, N))):
        x = case(50 + c * k, b, c, k, n, device)
        wrapper, plain, args, kw = faces(x, c, k)[name]
        out[name].setdefault("crossover", {})[f"{k}x{c}"] = design_times(
            wrapper, plain, args, kw, f"{name} {b}x{c}x{k}x{n}")
    for seed, (b, c, k, n) in enumerate(edge_shapes):
        x = case(100 + seed, b, c, k, n, device)
        # duplicate templates: exact ties resolve to the lowest class
        if c > 3:
            x["t"][1] = x["t"][0]
            x["valid"][1] = x["valid"][0]
            x["valid"][2] = False  # an all-invalid class
        for name, (wrapper, plain, args, kw) in faces(x, c, k).items():
            for how in DESIGNS if name in DESIGN_FACES else ["default"]:
                with design(how):
                    got = wrapper(*args, **kw)
                out[name]["max_abs_err"] = max(
                    out[name]["max_abs_err"],
                    compare(f"{name} {b}x{c}x{k}x{n} ({how})", got,
                            plain(*args, **kw)))
    for name, count in tile_probes(device).items():
        out[name]["tile_probes"] = count
    out["acam_match_serve"]["slot_probes"] = slot_probes(device)
    # flush-to-zero probe: f one ulp above thr, at thr ~ 1 and at the
    # smallest normal (there (f - thr) is subnormal; FTZ would zero it)
    for thr_val in (1.0, float(np.finfo(np.float32).tiny)):
        c, k, n = 10, 1, 64
        x = case(7, 8, c, k, n, device, t_rows=1)
        thr = np.full(n, thr_val, np.float32)
        f = np.tile(np.nextafter(thr, np.float32(np.inf)), (8, 1))
        x["f"] = torch.as_tensor(f, device=device)
        x["thr"] = torch.as_tensor(thr, device=device)
        x["table"] = x["thr"][None, :].clone()
        x["slot"].zero_()
        x["t"].fill_(1.0)
        for name, (wrapper, plain, args, kw) in faces(x, c, k).items():
            for how in DESIGNS if name in DESIGN_FACES else ["default"]:
                with design(how):
                    got = wrapper(*args, **kw)
                label = f"{name} ftz probe thr={thr_val} ({how})"
                compare(label, got, plain(*args, **kw))
                best = got[1 if len(got) > 1 else 0].max(dim=1).values
                check(bool((best == n).all()),
                      f"{label}: flushed a subnormal difference")
    am.reset_launches()
    return out


def host_steps(x: dict, b: int, c: int, k: int, n: int, library) -> dict:
    """Where B3's host time goes on one main-path call (`host_us` of each
    step of its wrapper): the tensor checks, the layout and the one
    allocation, the launch (pointers, ctypes call, driver), the output
    views; beside the whole call and its library yardstick."""
    import torch

    from repro_torch.kernels import layout
    from repro_torch.kernels.acam_match import acam_match as am

    wrapper, _, args, kw = faces(x, c, k)["acam_match_serve"]
    f, table, slot, t_kcp, v_kcp, lo, hi, tau, _ = args
    device, f32, i32 = f.device, torch.float32, torch.int32
    cp = layout.padded_classes(c)
    specs = (("features", f, f32, (b, n)), ("thr_table", table, f32,
                                             tuple(table.shape)),
             ("tenant_slot", slot, i32, (b,)),
             ("templates_kcp", t_kcp, f32, (k, cp, n)),
             ("valid_kcp", v_kcp, f32, (k, cp)), ("class_lo", lo, i32, (b,)),
             ("class_hi", hi, i32, (b,)), ("tau", tau, f32, (b,)))
    lay = am.tiled_layout(b, c, margin=True,
                          scratch=am._scratch(b, n, k, cp, c), escalate=True)
    buf = torch.empty(lay.words, dtype=i32, device=device)
    base = buf.data_ptr()

    def launch():
        am._launch("acam_match_serve", device, f.data_ptr(),
                   table.data_ptr(), table.shape[0], slot.data_ptr(),
                   t_kcp.data_ptr(), v_kcp.data_ptr(), lo.data_ptr(),
                   hi.data_ptr(), tau.data_ptr(), b, n, k, cp, c, kw["chunk"],
                   None if lay.scratch is None else base + lay.scratch, base,
                   base + lay.per_class, base + lay.margin,
                   base + lay.escalate)

    steps = dict(
        checks=host_us(lambda: (am._tiled_shape(f, t_kcp, c),
                                am._require(device, specs))),
        layout_and_allocation=host_us(lambda: torch.empty(
            am.tiled_layout(b, c, margin=True,
                            scratch=am._scratch(b, n, k, cp, c),
                            escalate=True).words, dtype=i32, device=device)),
        launch=host_us(launch),
        views=host_us(lambda: am._outputs(buf, lay, b, c)),
        call=host_us(lambda: wrapper(*args, **kw)),
        library_call=host_us(library))
    am.reset_launches()
    return steps


def design_times(wrapper, plain, args, kw, name: str) -> dict:
    """Both designs of the tiled kernel on one face's main-path call, in
    turns (local, cooperative, cooperative, local): bit-identical to the
    plain version, then call time (mean of the two runs), device time and
    host time of each."""
    want = plain(*args, **kw)

    def call():
        return wrapper(*args, **kw)

    runs = {}
    for how in ("local", "cooperative", "cooperative", "local"):
        with design(how):
            compare(f"{name} ({how} design)", call(), want)
            runs.setdefault(how, []).append(time_ms(call))
    out = {}
    for how, ms in runs.items():
        with design(how):
            out[how] = dict(ms=sum(ms) / 2, ms_runs=ms,
                            device_ms=profile(call, reps=20)["device_ms"],
                            host_us=host_us(call))
    return out


# ---------------------------------------------------------------------------
# 1b. the similarity kernels against their plain versions
# ---------------------------------------------------------------------------

def windows(rng, c: int, k: int, n: int, kind: str):
    """(lower, upper) (C, K, N) windows: "binary" as `generate_templates`
    builds them ({0, 1}, upper >= lower), "dyadic" (multiples of 1/4: D is
    exact in any summation order) or "real" (non-dyadic floats)."""
    if kind == "binary":
        lo = (rng.random((c, k, n)) > 0.5).astype(np.float32)
        hi = np.maximum((rng.random((c, k, n)) > 0.5).astype(np.float32), lo)
    elif kind == "dyadic":
        lo = (rng.integers(-8, 1, (c, k, n)) / 4).astype(np.float32)
        hi = lo + (rng.integers(0, 9, (c, k, n)) / 4).astype(np.float32)
    else:
        lo = rng.standard_normal((c, k, n), dtype=np.float32) * 0.5
        hi = lo + np.abs(rng.standard_normal((c, k, n), dtype=np.float32))
    return lo, hi


def sim_case(seed: int, b: int, c: int, k: int, n: int, device, kind: str,
             *, t_rows: int = 8, edges: bool = False):
    """`case` plus windows of ``kind`` and raw queries for B7b (dyadic unless
    the windows are real). ``edges``: class 1 duplicates class 0 (exact
    ties), class 2 is all-invalid, and rows 1-3 get an all-invalid window,
    a single-class window and a tied window (row 0's is empty)."""
    import torch

    x = case(seed, b, c, k, n, device, t_rows=t_rows)
    rng = np.random.default_rng(seed + 1000)
    lo, hi = windows(rng, c, k, n, kind)
    q = (rng.standard_normal((b, n), dtype=np.float32) if kind == "real"
         else (rng.integers(-8, 9, (b, n)) / 4).astype(np.float32))
    x.update(lower=torch.as_tensor(lo, device=device),
             upper=torch.as_tensor(hi, device=device),
             q=torch.as_tensor(q, device=device))
    if edges and c > 3:
        x["lower"][1], x["upper"][1] = x["lower"][0], x["upper"][0]
        x["valid"][0, 0] = True
        x["valid"][1] = x["valid"][0]
        x["valid"][2] = False
        if b > 3:
            x["lo"][1:4] = torch.tensor([2, 0, 0], device=device)
            x["hi"][1:4] = torch.tensor([3, 1, 2], device=device)
    return x


def sim_faces(x: dict, c: int, k: int, alpha: float, chunk: int | None = None):
    """Each similarity face's (wrapper, plain, args, kwargs) on one case;
    taus straddle every served margin (row 0 -inf, as the scheduler pads)."""
    import torch

    from repro_torch.kernels import layout
    from repro_torch.kernels.acam_similarity import acam_similarity as asim
    from repro_torch.match import MAX_FUSED_ROWS

    n = x["f"].shape[1]
    cp = layout.padded_classes(c)
    chunk = chunk or layout.class_chunk(cp, k, MAX_FUSED_ROWS)
    lo_kcp = layout.stack_kcp(x["lower"], c)
    hi_kcp = layout.stack_kcp(x["upper"], c)
    v_kcp = layout.valid_kcp(x["valid"], c)
    margins = asim.serve_plain(
        x["f"], x["table"], x["slot"], lo_kcp, hi_kcp, v_kcp, x["lo"],
        x["hi"], torch.zeros_like(x["f"][:, 0]), c, alpha=alpha,
        chunk=chunk)[2]
    sign = torch.where(torch.arange(len(margins), device=margins.device) % 2
                       == 0, 1e-4, -1e-4)
    tau = (margins + sign).to(torch.float32)
    tau[0] = float("-inf")
    kw = {"alpha": alpha}
    return {
        "acam_similarity": (
            lambda *a, **k_: (asim.acam_similarity(*a, **k_),),
            lambda *a, **k_: (asim.similarity_plain(*a, **k_),),
            (x["q"], x["lower"].reshape(-1, n), x["upper"].reshape(-1, n)),
            kw),
        "acam_similarity_classify": (
            asim.acam_similarity_classify, asim.classify_plain,
            (x["f"], x["thr"], lo_kcp.reshape(-1, n), hi_kcp.reshape(-1, n),
             v_kcp.reshape(-1), c), kw),
        "acam_similarity_serve": (
            asim.acam_similarity_serve, asim.serve_plain,
            (x["f"], x["table"], x["slot"], lo_kcp, hi_kcp, v_kcp, x["lo"],
             x["hi"], tau, c), dict(kw, chunk=chunk)),
    }


def compare_close(name: str, got, want, tau=None) -> float:
    """Non-dyadic windows: scores and margins within rtol 1e-5, atol 1e-6
    (-inf where the plain version has -inf); pred equal wherever the plain
    version's top-two gap exceeds 1e-5; escalate equal wherever its margin
    is more than 1e-5 from tau. Returns the max |diff| of finite floats."""
    import torch

    err = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"{name} output {i}: {g.shape}/{g.dtype} vs {w.shape}/{w.dtype}")
        if g.dtype.is_floating_point:
            check(torch.equal(torch.isfinite(g), torch.isfinite(w)),
                  f"{name} output {i}: -inf at other positions")
            fin = torch.isfinite(w)
            if fin.any():
                err = max(err, float((g[fin] - w[fin]).abs().max()))
                check(torch.allclose(g[fin], w[fin], rtol=1e-5, atol=1e-6),
                      f"{name} output {i} outside rtol 1e-5, atol 1e-6 "
                      f"(max |diff| {err})")
    if len(want) >= 2:  # classify / serve: (pred, per_class, ...)
        if len(want) == 4:
            gap = want[2]
            sure = (want[2] - tau).abs() > 1e-5
            check(torch.equal(got[3][sure], want[3][sure]),
                  f"{name}: escalate differs away from tau")
        else:
            top = want[1].topk(min(2, want[1].shape[1]), dim=1).values
            gap = (top[:, 0] - top[:, -1] if top.shape[1] > 1
                   else torch.full_like(top[:, 0], float("inf")))
        clear = gap > 1e-5
        check(torch.equal(got[0][clear], want[0][clear]),
              f"{name}: pred differs where the top-two gap exceeds 1e-5")
    return err


def sim_bound(name: str, b: int, c: int, k: int, n: int, valid_rows: int,
              t_rows: int):
    """Least time for the call on an H100 SXM: the bytes it must move (each
    input read once, each output written once; windows counted for the
    valid rows only, which is all the kernel reads) over 3.35 TB/s, against
    its operations: for B5 and B6 on binary windows (every bound 0 or 1, as
    their timed cases are) two popc per 32 of the B * valid rows * N window
    cells over POPC_PER_S (D = N - H needs no float work); for B7b's raw
    queries SIM_INSTR_PER_CELL FP32 / int instructions per cell over
    INSTR_PER_S. Returns (ms, bound_by, bytes)."""
    win = 2 * valid_rows * n * 4
    if name == "acam_similarity":
        nbytes = b * n * 4 + win + b * valid_rows * 4
    elif name == "acam_similarity_classify":
        nbytes = b * n * 4 + n * 4 + win + k * c * 4 + b * 4 + b * c * 4
    else:  # serve: + table, slots, windows, tau in; margin, escalate out
        nbytes = (b * n * 4 + t_rows * n * 4 + b * 4 + win + k * c * 4
                  + 3 * b * 4 + b * 4 + b * c * 4 + b * 4 + b)
    t_bytes = nbytes / HBM_BYTES_PER_S
    if name != "acam_similarity":
        t_ops = 2 * b * valid_rows * -(-n // 32) / POPC_PER_S
    else:
        t_ops = b * valid_rows * n * SIM_INSTR_PER_CELL / INSTR_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes)


#: the similarity faces on the tiled kernel, whose design `LOCAL_ROWS` picks
SIM_DESIGN_FACES = ("acam_similarity_classify", "acam_similarity_serve")


def sim_designs(name: str):
    """The designs to hold a similarity face to: both for B5 and B6, the
    one it has for B7b."""
    return DESIGNS if name in SIM_DESIGN_FACES else ["default"]


def sim_bank_probes(device) -> int:
    """B5 and B6 under both designs at C 10 and 130 (K 2, N 784), and B6 on
    the 1,100-class bank, on two banks: a mixed bank (binary and dyadic
    rows in one bank: row (class, k) dyadic where class + k is odd, so each
    class takes its max over one row of each path; class 1 duplicates class
    0, so the tie resolves across the paths' rows), bit-identical at alpha
    1.0 and 0.37; and an all-wildcard bank (every window [0, 1], every row
    valid), where every class scores N inv_n and ties, so pred is 0 and,
    with every window [0, C), the margin 0. Returns the number of cases."""
    import torch

    from repro_torch.kernels.acam_similarity.ref import inv_n

    runs = [(face, c, how) for face in SIM_DESIGN_FACES for c in (10, 130)
            for how in DESIGNS] + [("acam_similarity_serve", 1100, "default")]
    cases = 0
    for name, c, how in runs:
        k, n = 2, N
        x = sim_case(950 + c, 21, c, k, n, device, "binary", edges=True)
        lo_d, hi_d = windows(np.random.default_rng(c), c, k, n, "dyadic")
        odd = ((torch.arange(c, device=device)[:, None]
                + torch.arange(k, device=device)[None, :]) % 2 == 1)
        x["lower"][odd] = torch_tensor(lo_d, device)[odd]
        x["upper"][odd] = torch_tensor(hi_d, device)[odd]
        x["lower"][1], x["upper"][1] = x["lower"][0], x["upper"][0]
        for alpha in (1.0, 0.37):
            wrapper, plain, args, kw = sim_faces(x, c, k, alpha)[name]
            with design(how):
                compare(f"{name} mixed bank ({how}) C={c} a={alpha}",
                        wrapper(*args, **kw), plain(*args, **kw))
            cases += 1
        x["lower"].zero_()
        x["upper"].fill_(1.0)
        x["valid"].fill_(True)
        x["lo"].zero_()
        x["hi"].fill_(c)
        wrapper, plain, args, kw = sim_faces(x, c, k, 1.0)[name]
        label = f"{name} wildcard bank ({how}) C={c}"
        with design(how):
            got = wrapper(*args, **kw)
        compare(label, got, plain(*args, **kw))
        full = float(np.float32(n) * np.float32(inv_n(n)))
        check(bool((got[0] == 0).all()) and bool((got[1] == full).all()),
              f"{label}: every class ties at N inv_n, pred 0")
        if len(got) > 2:
            check(bool((got[2] == 0).all()), f"{label}: margins not 0")
        cases += 1
    return cases


def real_window_times(device) -> dict:
    """B5 and B6 at predict's and the serving tick's shapes, and B6 on the
    big bank (one thresholds row), on real windows (as
    `generate_templates(binary_windows=False)` builds them: no row is
    binary, so every valid row takes the tiled kernel's float sum of D):
    within tolerance of the plain version, then call time (CUDA events),
    device time and host time. Bound: the bytes `sim_bound` counts against
    SIM_INSTR_PER_CELL FP32 / int instructions per (query, valid row,
    feature) cell over INSTR_PER_S, the float work each cell then needs.
    Uses only the wrappers' Python interface, so it times any checkout's
    port alike (tools/sim_real_windows.py runs it on two in turns)."""
    runs = {"acam_similarity_classify": (256, 10, 1, N, 8),
            "acam_similarity_serve": (64, 128, 2, N, 8),
            "acam_similarity_serve big bank": (64, 1100, 2, N, 1)}
    out = {}
    for seed, (run, (b, c, k, n, t_rows)) in enumerate(runs.items()):
        name = run.split()[0]
        x = sim_case(410 + seed, b, c, k, n, device, "real", t_rows=t_rows)
        wrapper, plain, args, kw = sim_faces(x, c, k, 1.0)[name]
        err = compare_close(f"{name} real windows", wrapper(*args, **kw),
                            plain(*args, **kw),
                            args[8] if len(args) > 8 else None)
        rows = int(x["valid"].sum())
        nbytes = sim_bound(name, b, c, k, n, rows, t_rows)[2]
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = b * rows * n * SIM_INSTR_PER_CELL / INSTR_PER_S

        def call():
            return wrapper(*args, **kw)

        out[run] = dict(
            shape=dict(B=b, C=c, K=k, N=n, valid_rows=rows), max_abs_err=err,
            ms=time_ms(call), device_ms=profile(call, reps=20)["device_ms"],
            host_us=host_us(call), bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="bytes" if t_bytes >= t_ops else "operations")
    return out


#: B7b probe shapes (B, M, N), one either side of the tiles and slices of
#: both tilings of csrc/acam_similarity.cu (narrow: 2 queries x 12 rows,
#: 128-feature slices; wide: 8 x 16, 64 features, taken where it gives two
#: blocks an SM: the last five shapes), B, M or N of 1, and N = 1000
B7B_PROBES = [(1, 1, 1), (1, 12, 128), (2, 11, 127), (3, 13, 129),
              (1, 1, 1000), (2, 24, 255), (3, 25, 257), (5, 2, 100),
              (37, 30, 1000), (256, 10, 784), (65, 529, 100),
              (63, 543, 64), (64, 1056, 65), (72, 480, 129),
              (64, 2200, 784)]


def nan_compare(name: str, got, want) -> None:
    """Every output equal to the plain version's, NaN in the same places
    and bit-identical elsewhere."""
    import torch

    for i, (g, w) in enumerate(zip(got, want)):
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"{name} output {i}: {g.shape}/{g.dtype} vs {w.shape}/{w.dtype}")
        if g.dtype.is_floating_point:
            check(torch.equal(torch.isnan(g), torch.isnan(w)),
                  f"{name} output {i}: NaN at other positions than the "
                  "plain version's")
            g, w = g[~torch.isnan(g)], w[~torch.isnan(w)]
        check(torch.equal(g, w), f"{name} output {i} differs from its "
              "plain version away from the NaNs")


def b7b_probes(device) -> dict:
    """B7b against its plain version at `B7B_PROBES`: bit-identical on
    binary and dyadic windows at alpha 1.0 and 0.37, within rtol 1e-5 /
    atol 1e-6 on real windows; with misaligned operands (bases one float
    off, so the kernel stages with 4-byte copies) where N is small; and
    the NaN probes: a NaN lower bound, a NaN upper bound and a NaN query,
    NaN in the same cells as the plain version's. Returns case counts."""
    import torch

    from repro_torch.kernels.acam_similarity import acam_similarity as asim

    def misaligned(x):
        buf = torch.empty(x.numel() + 1, device=device)
        out = buf[1:].view(x.shape)
        out.copy_(x)
        return out

    counts = {"exact": 0, "real": 0, "misaligned": 0, "nan": 0}
    for seed, (b, m, n) in enumerate(B7B_PROBES):
        rng = np.random.default_rng(600 + seed)
        q = torch_tensor((rng.integers(-8, 9, (b, n)) / 4).astype(np.float32),
                         device)
        label = f"acam_similarity probe {b}x{m}x{n}"
        for kind in ("binary", "dyadic"):
            lo, hi = (torch_tensor(w[:, 0], device)
                      for w in windows(rng, m, 1, n, kind))
            for alpha in (1.0, 0.37):
                want = (asim.similarity_plain(q, lo, hi, alpha=alpha),)
                compare(f"{label} {kind} a={alpha}",
                        (asim.acam_similarity(q, lo, hi, alpha=alpha),), want)
                counts["exact"] += 1
                if b * m * n <= 1 << 20:
                    compare(f"{label} {kind} a={alpha} misaligned",
                            (asim.acam_similarity(
                                misaligned(q), misaligned(lo),
                                misaligned(hi), alpha=alpha),), want)
                    counts["misaligned"] += 1
            lo_n, hi_n, q_n = lo.clone(), hi.clone(), q.clone()
            lo_n[m // 2, n // 3] = float("nan")
            hi_n[m - 1, n - 1] = float("nan")
            q_n[b - 1, 0] = float("nan")
            nan_compare(f"{label} {kind} NaN", (asim.acam_similarity(
                q_n, lo_n, hi_n),), (asim.similarity_plain(q_n, lo_n, hi_n),))
            counts["nan"] += 1
        lo, hi = (torch_tensor(w[:, 0], device)
                  for w in windows(rng, m, 1, n, "real"))
        qr = torch_tensor(rng.standard_normal((b, n), dtype=np.float32),
                          device)
        compare_close(f"{label} real", (asim.acam_similarity(
            qr, lo, hi, alpha=0.37),), (asim.similarity_plain(
                qr, lo, hi, alpha=0.37),))
        counts["real"] += 1
    return counts


def nan_bank_probes(device) -> int:
    """B5 and B6 under both designs (B6 also on the 1,100-class bank) on
    binary and dyadic banks with a NaN lower bound in class 1 (slice 0) and
    a NaN upper bound in class 5 (slice 1), every row valid, and windows
    that hold class 1, skip it, or hold class 0 alone: equal to the plain
    versions with NaN in the same places (per_class NaN at classes 1 and
    5, pred the lowest NaN class of the window, margin 0 there). Returns
    the number of cases."""
    import torch

    runs = [(face, c, how) for face in SIM_DESIGN_FACES for c in (10, 130)
            for how in DESIGNS] + [("acam_similarity_serve", 1100, "default")]
    cases = 0
    for name, c, how in runs:
        for kind in ("binary", "dyadic"):
            x = sim_case(970 + c, 21, c, 2, N, device, kind)
            x["valid"].fill_(True)
            x["lower"][1, 0, 7] = float("nan")
            x["upper"][5, 1, 40] = float("nan")
            x["lo"][:6] = torch.tensor([0, 0, 2, 6, 0, 1], device=device)
            x["hi"][:6] = torch.tensor([c, 3, 5, c, 1, 2], device=device)
            wrapper, plain, args, kw = sim_faces(x, c, 2, 1.0)[name]
            want = plain(*args, **kw)
            label = f"{name} NaN bank ({how}) C={c} {kind}"
            with design(how):
                got = wrapper(*args, **kw)
            nan_compare(label, got, want)
            check(bool(torch.isnan(got[1][:, [1, 5]]).all()),
                  f"{label}: per_class not NaN at the NaN classes")
            cases += 1
    return cases


def redesign_times(device) -> dict:
    """B7b at (256, 10, 784) on binary windows and on the big bank as raw
    scores (64, 2,200, 784) on real ones, and B8 in f32 at the trainer's
    (128, 10), the bench (64, 32000) and the Qwen vocabulary (8, 152064):
    checked against the plain version, then call time (CUDA events),
    device time and the bound of each. Uses only the wrappers' Python
    interface, so it times any checkout's port alike
    (tools/sim_real_windows.py --what redesign_times runs it on two in
    turns)."""
    import torch

    from repro_torch.kernels.acam_similarity import acam_similarity as asim
    from repro_torch.kernels.kd_loss import kd_loss as kd

    out = {}
    for seed, (b, m, kind) in enumerate([(256, 10, "binary"),
                                         (64, 2200, "real")]):
        rng = np.random.default_rng(420 + seed)
        lo, hi = (torch_tensor(w[:, 0], device)
                  for w in windows(rng, m, 1, N, kind))
        q = torch_tensor(rng.standard_normal((b, N), dtype=np.float32),
                         device)
        compare_close(f"acam_similarity {b}x{m}", (asim.acam_similarity(
            q, lo, hi),), (asim.similarity_plain(q, lo, hi),))

        def call():
            return asim.acam_similarity(q, lo, hi)

        ms, by, _ = sim_bound("acam_similarity", b, m, 1, N, m, 1)
        out[f"acam_similarity {b}x{m}x{N}"] = dict(
            ms=time_ms(call), device_ms=profile(call, reps=20)["device_ms"],
            bound_ms=ms, bound_by=by)
    for seed, (b, v) in enumerate([(128, 10), (64, 32000), (8, 152064)]):
        zs, zt, y = kd_case(430 + seed, b, v, device)
        kd_compare(f"kd_loss {b}x{v}", kd.kd_loss(zs, zt, y),
                   kd.kd_loss_plain(zs, zt, y))

        def call():
            return kd.kd_loss(zs, zt, y)

        ms, by, _ = kd_bound(b, v, 4)
        out[f"kd_loss {b}x{v}"] = dict(
            ms=time_ms(call), device_ms=profile(call, reps=20)["device_ms"],
            bound_ms=ms, bound_by=by)
    return out


def similarity_phase(device) -> dict:
    from repro_torch.kernels import layout
    from repro_torch.kernels.acam_match import acam_match as am
    from repro_torch.kernels.acam_similarity import acam_similarity as asim

    # (b, c, k, n): the main paths' shapes (timed; binary windows, alpha 1)
    main_shapes = {
        "acam_similarity_classify": (256, 10, 1, N),  # predict, similarity
        "acam_similarity_serve": (64, 128, 2, N),  # serving tick
        "acam_similarity": (256, 10, 1, N),  # ACAMHead.scores, similarity
    }
    out = {}
    for seed, (name, (b, c, k, n)) in enumerate(main_shapes.items()):
        x = sim_case(200 + seed, b, c, k, n, device, "binary")
        wrapper, plain, args, kw = sim_faces(x, c, k, 1.0)[name]
        err = compare(name, wrapper(*args, **kw), plain(*args, **kw))
        rows = c * k if name == "acam_similarity" else int(x["valid"].sum())
        ms, by, nbytes = sim_bound(name, b, c, k, n, rows, 8)
        out[name] = dict(
            shape=dict(B=b, C=c, K=k, N=n, valid_rows=rows),
            max_abs_err=err, ms=time_ms(lambda: wrapper(*args, **kw)),
            plain_ms=time_ms(lambda: plain(*args, **kw)), library_ms=None,
            library_call="none: no PyTorch call computes Eq. 9-11",
            bound_ms=ms, bound_by=by, bound_bytes=nbytes,
            host_us=host_us(lambda: wrapper(*args, **kw)),
            profile=profile(lambda: wrapper(*args, **kw), reps=20))
        kernels_seen = out[name]["profile"]["by_kernel"]
        check(len(kernels_seen) == 1, f"{name}: one kernel per call, "
              f"the profile shows {list(kernels_seen)}")
        if name in SIM_DESIGN_FACES:
            out[name]["design"] = ("local" if k * c <= am.LOCAL_ROWS
                                   else "cooperative")
            out[name]["designs"] = design_times(wrapper, plain, args, kw,
                                                name)
    # B6 on the big bank, as the similarity `classify_features_margin` path
    # calls it past `MAX_FUSED_ROWS` (one thresholds row)
    b, c, k, n = 64, 1100, 2, N
    x = sim_case(203, b, c, k, n, device, "binary", t_rows=1)
    wrapper, plain, args, kw = sim_faces(x, c, k, 1.0)[
        "acam_similarity_serve"]
    err = compare("acam_similarity_serve big bank", wrapper(*args, **kw),
                  plain(*args, **kw))
    rows = int(x["valid"].sum())
    ms, by, nbytes = sim_bound("acam_similarity_serve", b, c, k, n, rows, 1)
    big = out["acam_similarity_serve"]["big_bank"] = dict(
        shape=dict(B=b, C=c, K=k, N=n, valid_rows=rows), max_abs_err=err,
        ms=time_ms(lambda: wrapper(*args, **kw)),
        plain_ms=time_ms(lambda: plain(*args, **kw), 10), library_ms=None,
        bound_ms=ms, bound_by=by, bound_bytes=nbytes,
        host_us=host_us(lambda: wrapper(*args, **kw)),
        profile=profile(lambda: wrapper(*args, **kw), reps=20))
    check(len(big["profile"]["by_kernel"]) == 1, "acam_similarity_serve big "
          f"bank: one kernel per call, the profile shows "
          f"{list(big['profile']['by_kernel'])}")
    # B7b on the same bank as raw scores (M = C K = 2,200 window rows, real
    # queries): the wide tiling
    m = c * k
    x = sim_case(204, b, c, k, n, device, "real")
    wrapper, plain, args, kw = sim_faces(x, c, k, 1.0)["acam_similarity"]
    err = compare_close("acam_similarity big bank", wrapper(*args, **kw),
                        plain(*args, **kw))
    ms, by, nbytes = sim_bound("acam_similarity", b, c, k, n, m, 1)
    raw = out["acam_similarity"]["big_bank"] = dict(
        shape=dict(B=b, M=m, N=n, windows="real"), max_abs_err=err,
        ms=time_ms(lambda: wrapper(*args, **kw)),
        plain_ms=time_ms(lambda: plain(*args, **kw), 10), library_ms=None,
        bound_ms=ms, bound_by=by, bound_bytes=nbytes,
        host_us=host_us(lambda: wrapper(*args, **kw)),
        profile=profile(lambda: wrapper(*args, **kw), reps=20))
    check(len(raw["profile"]["by_kernel"]) == 1, "acam_similarity big bank: "
          f"one kernel per call, the profile shows "
          f"{list(raw['profile']['by_kernel'])}")
    out["acam_similarity"]["probes"] = b7b_probes(device)
    out["acam_similarity_serve"]["nan_probes"] = nan_bank_probes(device)
    # bit-identity: binary and dyadic windows, both alphas, main shapes,
    # ragged shapes and the edge cases; B6 at two chunks; B5 and B6 under
    # both designs
    shapes = [(64, 128, 2, N), (256, 10, 1, N), (37, 30, 2, 300), (1, 1, 1, 1),
              (16, 12, 4, 64), (16, 1100, 2, 64)]
    for seed, (b, c, k, n) in enumerate(shapes):
        cp = layout.padded_classes(c)
        for kind in ("binary", "dyadic"):
            x = sim_case(300 + seed, b, c, k, n, device, kind, edges=True)
            for alpha in (1.0, 0.37):
                for chunk in (None, cp // 2):
                    for name, (wrapper, plain, args, kw) in sim_faces(
                            x, c, k, alpha, chunk).items():
                        if chunk and name != "acam_similarity_serve":
                            continue
                        want = plain(*args, **kw)
                        for how in sim_designs(name):
                            with design(how):
                                got = wrapper(*args, **kw)
                            out[name]["max_abs_err"] = max(
                                out[name]["max_abs_err"], compare(
                                    f"{name} {b}x{c}x{k}x{n} {kind} "
                                    f"a={alpha} chunk={chunk} ({how})", got,
                                    want))
    # non-dyadic real windows: within tolerance (B5 and B6 through the
    # kernel's float loop for rows that are not binary)
    for seed, (b, c, k, n) in enumerate([(64, 128, 2, N), (256, 10, 1, N)]):
        x = sim_case(400 + seed, b, c, k, n, device, "real", edges=True)
        for name, (wrapper, plain, args, kw) in sim_faces(
                x, c, k, 0.37).items():
            want = plain(*args, **kw)
            for how in sim_designs(name):
                with design(how):
                    got = wrapper(*args, **kw)
                out[name]["real_window_max_abs_err"] = max(
                    out[name].get("real_window_max_abs_err", 0.0),
                    compare_close(f"{name} {b}x{c}x{k}x{n} real ({how})",
                                  got, want,
                                  args[8] if len(args) > 8 else None))
    # flush-to-zero probe (B6 binarises with (f - thr) > 0): f one ulp above
    # thr at thr ~ 1 and at the smallest normal; every window is [1, 1], so
    # an unflushed row hits every feature and scores N * inv_n / 1
    for thr_val in (1.0, float(np.finfo(np.float32).tiny)):
        c, k, n = 10, 1, 64
        x = sim_case(9, 8, c, k, n, device, "binary", t_rows=1)
        thr = np.full(n, thr_val, np.float32)
        x["f"] = torch_tensor(np.tile(np.nextafter(thr, np.float32(np.inf)),
                                      (8, 1)), device)
        x["table"] = torch_tensor(thr[None, :], device)
        x["slot"].zero_()
        x["lower"].fill_(1.0)
        x["upper"].fill_(1.0)
        wrapper, plain, args, kw = sim_faces(x, c, k, 1.0)[
            "acam_similarity_serve"]
        full = float(np.float32(n) * (np.float32(1) / np.float32(n)))
        for how in DESIGNS:
            with design(how):
                got = wrapper(*args, **kw)
            compare(f"acam_similarity_serve ftz probe thr={thr_val} ({how})",
                    got, plain(*args, **kw))
            check(bool((got[1].max(dim=1).values == full).all()),
                  f"acam_similarity_serve flushed a subnormal difference at "
                  f"thr={thr_val} ({how})")
    for name, count in tile_probes(device, similarity=True).items():
        out[name]["tile_probes"] = count
    out["acam_similarity_serve"]["bank_probes"] = sim_bank_probes(device)
    real = real_window_times(device)
    big["real_windows"] = real.pop("acam_similarity_serve big bank")
    for name, times in real.items():
        out[name]["real_windows"] = times
    asim.reset_launches()
    return out


def torch_tensor(a: np.ndarray, device):
    import torch

    return torch.as_tensor(a, device=device)


# ---------------------------------------------------------------------------
# 1c. B8 (kd_loss) and B9 (flash_attention) against their plain versions
# ---------------------------------------------------------------------------

def kd_case(seed: int, b: int, v: int, device, dtype=None):
    """Student and teacher logits (scale 3) and in-range int32 labels."""
    import torch

    rng = np.random.default_rng(seed)
    dtype = dtype or torch.float32
    zs, zt = (torch.as_tensor(rng.standard_normal((b, v)) * 3,
                              dtype=torch.float32, device=device).to(dtype)
              for _ in range(2))
    y = torch.as_tensor(rng.integers(0, v, b), dtype=torch.int32,
                        device=device)
    return zs, zt, y


def kd_compare(name: str, got, want) -> float:
    """Per-sample losses within rel 1e-4, abs 1e-5; returns max |diff|."""
    import torch

    check(got.shape == want.shape and got.dtype == torch.float32,
          f"{name}: {got.shape}/{got.dtype} vs {want.shape}")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite loss")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    check(bool(torch.allclose(got, want, rtol=KD_RTOL, atol=KD_ATOL)),
          f"{name}: outside rel {KD_RTOL}, abs {KD_ATOL} of the plain version "
          f"(max |diff| {err})")
    return err


def kd_bound(b: int, v: int, itemsize: int):
    """Least time on an H100 SXM: both logits read once, labels in, losses
    out, over 3.35 TB/s, against three exponentials per column over the
    special-function rate. Returns (ms, bound_by, bytes)."""
    nbytes = 2 * b * v * itemsize + b * 4 + b * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 3 * b * v / SFU_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes)


def kd_split_probes(device) -> int:
    """B8's split design at its edges, f32, bf16 and f16 at V 1, 17, 1025,
    4999 (rows not 16-byte aligned: scalar heads and tails), 32000 and
    152064 (B 8 and 1) and the trainer's (128, 10): row i's label on the
    first (even i) or last (odd i) column of split i mod S, and its maximum
    in split (i + 1) mod S (both logits), so the label and the maximum visit
    every split; then a student buffer one element off the teacher's
    alignment (every column scalar). Within rel 1e-4 / abs 1e-5 of the
    plain version and two calls bitwise equal. Returns the number of
    cases."""
    import torch

    from repro_torch.kernels.kd_loss import kd_loss as kd

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    cases = 0
    for seed, (b, v) in enumerate([(2, 1), (3, 17), (4, 1025), (5, 4999),
                                   (128, 10), (64, 32000), (8, 152064),
                                   (1, 152064)]):
        splits, cols = ((1, v) if v <= kd.WARP_ROW_COLS
                        else kd.split_plan(b, v, sms))
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            zs, zt, y = kd_case(540 + seed, b, v, device, dtype)
            for i in range(b):
                sp, hot = i % splits, (i + 1) % splits
                c0, c1 = sp * cols, min(sp * cols + cols, v)
                y[i] = c0 if i % 2 == 0 else c1 - 1
                col = min(hot * cols + (i * 7) % cols, v - 1)
                zs[i, col] = 30.0
                zt[i, col] = 30.0
            label = f"kd_loss split probe {b}x{v} {dtype} ({splits} splits)"
            got = kd.kd_loss(zs, zt, y)
            kd_compare(label, got, kd.kd_loss_plain(zs, zt, y))
            check(torch.equal(got, kd.kd_loss(zs, zt, y)),
                  f"{label}: two calls differ")
            cases += 1
            if v > 1:
                buf = torch.empty(b * v + 1, dtype=dtype, device=device)
                zs_off = buf[1:].view(b, v)
                zs_off.copy_(zs)
                kd_compare(f"{label} misaligned", kd.kd_loss(zs_off, zt, y),
                           kd.kd_loss_plain(zs, zt, y))
                cases += 1
    return cases


def kd_phase(device) -> dict:
    """B8 at the trainer's shape (128 x 10, T 4, alpha 0.5: the timed main
    path), the bench shape 64 x 32000 (timed too), (13, 5000), (3, 17) and
    (8, 152064), bf16 logits, a T/alpha sweep and out-of-range labels."""
    import torch

    from repro_torch.kernels.kd_loss import kd_loss as kd

    out, err = {}, 0.0
    timed = {"main": (128, 10), "bench": (64, 32000), "vocab": (8, 152064)}
    for seed, (b, v) in enumerate([*timed.values(), (13, 5000), (3, 17)]):
        zs, zt, y = kd_case(500 + seed, b, v, device)
        err = max(err, kd_compare(f"kd_loss {b}x{v}", kd.kd_loss(zs, zt, y),
                                  kd.kd_loss_plain(zs, zt, y)))
    for b, v in [(64, 32000), (13, 5000)]:
        zs, zt, y = kd_case(510, b, v, device, torch.bfloat16)
        err = max(err, kd_compare(f"kd_loss {b}x{v} bf16",
                                  kd.kd_loss(zs, zt, y),
                                  kd.kd_loss_plain(zs, zt, y)))
    for temperature, alpha in [(1.0, 0.0), (1.0, 1.0), (2.0, 0.25),
                               (6.5, 0.9), (8.0, 0.7)]:
        zs, zt, y = kd_case(520, 6, 400, device)
        kw = dict(temperature=temperature, alpha=alpha)
        err = max(err, kd_compare(f"kd_loss T={temperature} a={alpha}",
                                  kd.kd_loss(zs, zt, y, **kw),
                                  kd.kd_loss_plain(zs, zt, y, **kw)))
    zs, zt, y = kd_case(530, 6, 2100, device)
    y[1], y[3], y[5] = -1, 2100, 4096  # picked as 0: CE = lse
    got = kd.kd_loss(zs, zt, y, alpha=0.0)
    err = max(err, kd_compare("kd_loss out-of-range labels", got,
                              kd.kd_loss_plain(zs, zt, y, alpha=0.0)))
    lse = torch.logsumexp(zs, dim=-1)
    check(bool(torch.allclose(got[[1, 3, 5]], lse[[1, 3, 5]], rtol=1e-6)),
          "kd_loss: an out-of-range label must pick 0")
    for key, (b, v) in timed.items():
        zs, zt, y = kd_case(500 + list(timed).index(key), b, v, device)
        ms, by, nbytes = kd_bound(b, v, 4)
        row = dict(
            shape=dict(B=b, V=v, T=4.0, alpha=0.5, dtype="float32"),
            ms=time_ms(lambda: kd.kd_loss(zs, zt, y)),
            plain_ms=time_ms(lambda: kd.kd_loss_plain(zs, zt, y)),
            library_ms=None,
            library_call="none: no single PyTorch call computes Eq. 1",
            partial_library_ms=time_ms(lambda: torch.logsumexp(zs, dim=-1)),
            partial_library_call="torch.logsumexp of the student logits "
                                 "(the CE normaliser alone, partial)",
            bound_ms=ms, bound_by=by, bound_bytes=nbytes,
            profile=profile(lambda: kd.kd_loss(zs, zt, y), reps=20))
        if key == "main":
            out["kd_loss"] = dict(row, max_abs_err=err)
        else:
            out["kd_loss"][key] = row
    out["kd_loss"]["split_probes"] = kd_split_probes(device)
    kd.reset_launches()
    return out


def fa_bound(b: int, s: int, h: int, kv: int, d: int, causal: bool, dtype):
    """Least time on an H100 SXM: 4 * D flops per live (query, key) pair
    (QK^T and P.V; the causal half where causal) over the dense rate of the
    dtype, against q, k, v read once and o written once over 3.35 TB/s.
    Returns (ms, bound_by, flops, bytes)."""
    import torch

    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4 * d * pairs * b * h
    item = torch.empty((), dtype=dtype).element_size()
    nbytes = (2 * b * s * h * d + 2 * b * s * kv * d) * item
    t_ops = flops / FLOPS_PER_S[str(dtype)]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def fa_case(seed: int, b: int, s: int, h: int, kv: int, d: int, device,
            dtype, sk: int | None = None):
    """q (B, S, H, D), k and v (B, Sk, KV, D) standard normal (Sk = S
    unless given)."""
    import torch

    rng = np.random.default_rng(seed)
    sk = sk or s
    return tuple(torch.as_tensor(rng.standard_normal(shape),
                                 dtype=torch.float32, device=device).to(dtype)
                 for shape in ((b, s, h, d), (b, sk, kv, d), (b, sk, kv, d)))


def fa_compare(name: str, got, want, tol: float) -> float:
    """|got - want| <= tol * max(1, |want|) everywhere (tol at unit scale,
    relative above it); returns the max |diff|."""
    import torch

    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{name}: {got.shape}/{got.dtype} vs {want.shape}/{want.dtype}")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    diff = (got.float() - want.float()).abs()
    scaled = float((diff / want.float().abs().clamp(min=1.0)).max())
    check(scaled <= tol, f"{name}: |diff| / max(1, |want|) reaches {scaled}, "
          f"above {tol}")
    return float(diff.max())


# (1, 4096, 16 heads, 8 kv heads, 128): the attention geometry of
# src/repro/configs/qwen3_1_7b.py, bf16 causal, timed beside the bench shape
FA_MODEL_SHAPE = (1, 4096, 16, 8, 128)


def fa_sdpa(q, k, v):
    """The yardstick: SDPA on (B, H, S, D) views with the kv heads expanded
    beforehand (outside the timed call). Returns the timed call."""
    import torch
    import torch.nn.functional as F

    g = q.shape[2] // k.shape[2]
    qh, kh, vh = (x.permute(0, 2, 1, 3) for x in (
        q, torch.repeat_interleave(k, g, dim=2),
        torch.repeat_interleave(v, g, dim=2)))
    return lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)


def fa_timed(seed: int, shape: tuple, device, dtype) -> dict:
    """One causal shape through `ops.attention`: held against the plain
    version and SDPA, timed in turns with SDPA, traced, and its bound."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ops as fa_ops

    b, s, h, kv, d = shape
    q, k, v = fa_case(seed, b, s, h, kv, d, device, dtype)
    ms, by, flops, nbytes = fa_bound(b, s, h, kv, d, True, dtype)
    sdpa = fa_sdpa(q, k, v)

    def kernel():
        return fa_ops.attention(q, k, v, causal=True)

    err = fa_compare(f"flash_attention {shape} causal", kernel(),
                     fa.flash_attention_gqa_plain(q, k, v, causal=True),
                     FA_TOL_BF16)
    lib_diff = fa_compare(f"SDPA yardstick at {shape}",
                          sdpa().permute(0, 2, 1, 3), kernel(), FA_TOL_BF16)
    return dict(
        shape=dict(B=b, S=s, H=h, KV=kv, D=d, causal=True,
                   dtype=str(dtype).split(".")[1]),
        route=fa.route(dtype, d), max_abs_err=err,
        **interleaved(kernel, sdpa),
        plain_ms=time_ms(lambda: fa.flash_attention_gqa_plain(
            q, k, v, causal=True), 10),
        library_call="torch.nn.functional.scaled_dot_product_attention, "
                     "kv heads expanded outside the timed call",
        library_max_abs_diff=lib_diff,
        bound_ms=ms, bound_by=by, bound_flops=flops, bound_bytes=nbytes,
        profile=profile(kernel, reps=20))


def fa_phase(device) -> dict:
    """B9 in f32 at the JAX test shapes, D = 96 and the (BH, S, D) face
    (2e-3, the FP32 route); in bf16 and f16 (2^-6 at unit scale, relative
    above it; the tensor cores) at every head dim 32-128, GQA groups 1, 2
    and 8, causal and not, Sq and Sk not multiples of the 64-row tile and
    unequal, small grids (the key-split kernel) and grids of more than two
    blocks per SM; `ops.attention` against `layers.chunked_attention` on
    the card; then the bench shape (1, 1024, 8, 2, 64) and the model shape
    `FA_MODEL_SHAPE`, bf16 causal, timed in turns with SDPA."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models.layers import chunked_attention

    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    err = {"float32": 0.0, "bfloat16": 0.0, "float16": 0.0}
    # (b, sq, sk, h, kv, causal)
    sweep = [(1, 130, 130, 8, 8, True), (2, 200, 200, 8, 4, False),
             (1, 333, 333, 8, 1, True), (1, 190, 190, 4, 4, False),
             (2, 257, 257, 8, 4, True), (1, 77, 77, 16, 2, False),
             (1, 100, 333, 4, 2, False), (2, 333, 100, 16, 2, True),
             (1, 70, 190, 8, 1, True),
             (4, 600, 600, 8, 2, True), (3, 700, 500, 16, 8, False)]
    cases = [(2, 200, 200, 8, 2, 64, True, f32),
             (1, 128, 128, 4, 4, 128, True, f32),
             (2, 333, 333, 6, 2, 64, False, f32),
             (1, 512, 512, 2, 1, 32, True, f32),
             (1, 70, 70, 4, 2, 96, False, f32)]
    cases += [(b, sq, sk, h, kv, d, causal, dt) for dt in (bf16, f16)
              for d in fa.HEAD_DIMS for b, sq, sk, h, kv, causal in sweep]
    for seed, (b, sq, sk, h, kv, d, causal, dt) in enumerate(cases):
        q, k, v = fa_case(600 + seed, b, sq, h, kv, d, device, dt, sk)
        tol = FA_TOL_F32 if dt == f32 else FA_TOL_BF16
        key = str(dt).split(".")[1]
        err[key] = max(err[key], fa_compare(
            f"flash_attention {(b, sq, sk, h, kv, d, causal, key)}",
            fa.flash_attention_gqa(q, k, v, causal=causal),
            fa.flash_attention_gqa_plain(q, k, v, causal=causal), tol))
    # the (BH, S, D) face of the TPU kernel's signature
    for dt in (f32, bf16):
        q, k, v = (x[:, :, 0].contiguous()
                   for x in fa_case(610, 3, 150, 1, 1, 64, device, dt))
        key = str(dt).split(".")[1]
        err[key] = max(err[key], fa_compare(
            f"flash_attention (BH, S, D) {key}", fa.flash_attention(q, k, v),
            fa.flash_attention_plain(q, k, v),
            FA_TOL_F32 if dt == f32 else FA_TOL_BF16))
    # the entry point against the model's chunked attention, on the card
    for seed, (b, s, h, kv, d, dt) in enumerate(
            [(2, 160, 4, 2, 32, f32), (1, 1024, 8, 2, 64, bf16)]):
        q, k, v = fa_case(620 + seed, b, s, h, kv, d, device, dt)
        fa_compare(f"ops.attention vs chunked_attention {(b, s, h, kv, d)}",
                   fa_ops.attention(q, k, v, causal=True),
                   chunked_attention(q, k, v, causal=True, q_chunk=256),
                   FA_TOL_F32 if dt == f32 else FA_TOL_BF16)
    bench = fa_timed(606, (1, 1024, 8, 2, 64), device, bf16)
    bench["max_abs_err"] = max(bench["max_abs_err"], err["bfloat16"])
    out = {"flash_attention": dict(
        bench, max_abs_err_f32=err["float32"],
        max_abs_err_f16=err["float16"], cases=len(cases) + 4,
        model_shape=fa_timed(607, FA_MODEL_SHAPE, device, bf16))}
    fa.reset_launches()
    return out


# ---------------------------------------------------------------------------
# 2. the main paths, through the entry points
# ---------------------------------------------------------------------------

def class_images(rng, protos: np.ndarray, labels: np.ndarray,
                 noise: float) -> np.ndarray:
    return (protos[labels] + noise * rng.standard_normal(
        (len(labels),) + protos.shape[1:])).astype(np.float32)


def launch_modules() -> list:
    """Every kernel wrapper module (each has LAUNCHES, reset_launches)."""
    from repro_torch.kernels.acam_match import acam_match as am
    from repro_torch.kernels.acam_similarity import acam_similarity as asim
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.kd_loss import kd_loss as kd

    return [am, asim, kd, fa]


def drive(name: str, fn, kernels: list[str]):
    """Run one path with the launch counts zeroed just before and read just
    after; every kernel of the path must have launched."""
    import torch

    for mod in launch_modules():
        mod.reset_launches()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    for k in kernels:
        check(counts[k] > 0, f"path {name}: kernel {k} never launched")
    return result, counts, wall


def paths(device, cfg=None, per_class: int = 64) -> dict:
    import torch

    from repro_torch import match
    from repro_torch.core.hybrid import HybridClassifier, fit_acam_head
    from repro_torch.kernels import layout
    from repro_torch.kernels.acam_match import acam_match as am
    from repro_torch.match import EngineConfig
    from repro_torch.models.cnn import StudentConfig, init_student, \
        student_features
    from repro_torch.serve.acam_service import ClassifyRequest
    from repro_torch.serve.control import HybridService
    from repro_torch.serve.spec import (CascadeSpec, RegistrySpec,
                                        SchedulerSpec, ServiceSpec)

    report = {}
    cfg = cfg or StudentConfig()
    n = cfg.num_features
    model = init_student(torch.Generator().manual_seed(0), cfg, device=device)
    rng = np.random.default_rng(0)

    # -- HybridClassifier.predict (B1) --------------------------------------
    protos = rng.standard_normal((10, 32, 32, 1)).astype(np.float32)
    cal_y = np.repeat(np.arange(10), per_class)
    cal_x = class_images(rng, protos, cal_y, 0.5)
    head = fit_acam_head(student_features, model, cal_x, cal_y, 10,
                         device=device)
    clf = HybridClassifier(model, student_features, head, device=device)
    test_y = rng.integers(0, 10, 256)
    test_x = class_images(rng, protos, test_y, 0.5)
    pred, counts, wall = drive("predict", lambda: clf.predict(test_x),
                               ["acam_match_classify"])
    check(pred.shape == (256,) and pred.dtype == torch.int32,
          "predict: 256 int32 class ids")
    feats = student_features(model, test_x)
    check(bool(torch.isfinite(feats).all()) and feats.shape == (256, n),
          f"predict: finite (256, {n}) features")
    bank = head.bank
    want, _ = am.classify_plain(feats, bank.thresholds,
                                layout.flatten_kmajor(bank.templates, 10),
                                layout.valid_kmajor(bank.valid, 10), 10)
    check(torch.equal(pred, want), "predict: kernel preds differ from the "
          "plain path on the same features")
    acc = float((pred.cpu().numpy() == test_y).mean())
    report["predict"] = dict(launches=counts, wall_s=wall, features=n,
                             accuracy_vs_labels=acc,
                             profile=profile(lambda: clf.predict(test_x)))

    # -- HybridService ticks: mega (B3) and compose (B4) ---------------------
    tenants = []
    for t in range(8):
        tp = rng.standard_normal((10, 32, 32, 1)).astype(np.float32)
        x = class_images(rng, tp, cal_y, 0.5)
        th = fit_acam_head(student_features, model, x, cal_y, 10,
                           device=device)
        cents = student_features(model, tp).cpu().numpy()  # (10, n)
        head_wb = (cents.T.copy(), (-0.5 * (cents**2).sum(1)).astype(
            np.float32))
        tenants.append((f"tenant{t}", th.bank, head_wb, tp))
    requests = []
    for i in range(256):
        tid, _, _, tp = tenants[i % 8]
        a, b = rng.integers(0, 10, 2)
        # one request in four blends two classes: a low-margin query
        img = tp[a] if i % 4 else 0.5 * (tp[a] + tp[b])
        img = img + 0.3 * rng.standard_normal(img.shape).astype(np.float32)
        requests.append((tid, img))
    req_feats = student_features(
        model, np.stack([img for _, img in requests])).cpu().numpy()

    def service(fusion: str, on=device):
        spec = ServiceSpec(
            registry=RegistrySpec(num_features=n),
            engine=EngineConfig(backend="kernel", margin=True,
                                serve_fusion=fusion),
            scheduler=SchedulerSpec(slots=64),
            cascade=CascadeSpec(tau=8.0, tau_units="count"))
        svc = HybridService.from_spec(spec, device=on)
        for tid, bnk, hwb, _ in tenants:
            svc.register_tenant(tid, bnk, head=hwb)
        return svc

    served = {}
    for fusion, kernel in (("mega", "acam_match_serve"),
                           ("compose", "acam_match_classify_margins")):
        svc = service(fusion)
        reqs = [ClassifyRequest(tid, f)
                for (tid, _), f in zip(requests, req_feats)]
        resp, counts, wall = drive(f"serve_{fusion}",
                                   lambda: svc.serve(reqs), [kernel])
        m = svc.metrics()
        check(all(r.error is None for r in resp) and len(resp) == 256,
              f"serve_{fusion}: every request answered without error")
        check(counts[kernel] == m["classify_dispatches"],
              f"serve_{fusion}: {counts[kernel]} launches vs "
              f"{m['classify_dispatches']} dispatches")
        check(0.0 < m["escalation_rate"] < 1.0,
              f"serve_{fusion}: escalation rate {m['escalation_rate']}")
        served[fusion] = resp
        # one tick's matching call alone, on device-resident operands
        entries = [svc.registry.get(tid) for tid, _ in requests[:64]]
        tick_in = [torch.as_tensor(v, device=device) for v in (
            req_feats[:64], [e.slot for e in entries],
            [e.window[0] for e in entries], [e.window[1] for e in entries],
            [8.0] * 64)]
        eng = match.engine_from_config(svc.spec.engine)
        call_ms = time_ms(lambda: eng.classify_serve(
            tick_in[0], svc.registry.thresholds_table(), tick_in[1],
            svc.registry.device_bank(), tick_in[2], tick_in[3], tick_in[4]))
        report[f"serve_{fusion}"] = dict(
            launches=counts, wall_s=wall, metrics=m,
            energy=svc.obs.ledger.fleet(),
            tick_ms=m["tick_time_s"] / m["ticks"] * 1e3,
            engine_call_ms=call_ms,
            # the same 256 requests again, traced (after the metrics read)
            profile=profile(lambda: svc.serve(reqs)))
    # the reference: the same service on the CPU, where every kernel runs
    # its plain version (held bit-identical to the JAX package by the tests)
    cpu = service("mega", torch.device("cpu")).serve(
        [ClassifyRequest(tid, f) for (tid, _), f in zip(requests, req_feats)])
    for name, other in (("compose", served["compose"]), ("cpu", cpu)):
        for a, b in zip(served["mega"], other):
            check((a.pred, a.margin, a.escalated, a.energy_j) ==
                  (b.pred, b.margin, b.escalated, b.energy_j),
                  f"the mega tick on the card and the {name} path disagree")

    # -- big bank past MAX_FUSED_ROWS (B2) ----------------------------------
    x = case(11, 64, 1100, 2, n, device)
    from repro_torch.core.templates import TemplateBank

    big = TemplateBank(x["t"], x["t"], x["t"], x["valid"], x["thr"])
    check(2 * layout.padded_classes(1100) > match.MAX_FUSED_ROWS,
          "big bank exceeds the fused-row budget")
    eng = match.engine_for(backend="kernel")
    (pred, per_class), counts, wall = drive(
        "big_bank", lambda: eng.classify_features(x["f"], big),
        ["acam_match_classify_margins_chunked"])
    want = am.classify_margins_chunked_plain(
        x["f"], x["thr"], layout.stack_kcp(x["t"], 1100),
        layout.valid_kcp(x["valid"], 1100),
        torch.zeros(64, dtype=torch.int32, device=device),
        torch.full((64,), 1100, dtype=torch.int32, device=device), 1100,
        chunk=layout.class_chunk(1152, 2, match.MAX_FUSED_ROWS))
    check(torch.equal(pred, want[0]) and torch.equal(per_class, want[1]),
          "big bank: kernel differs from the plain path")
    check(counts["acam_match_classify_margins_chunked"] == 1,
          f"big bank: {counts['acam_match_classify_margins_chunked']} B2 "
          "launches for one classify_features call")
    cpu_big = TemplateBank(*(v.cpu() for v in (x["t"], x["t"], x["t"],
                                               x["valid"], x["thr"])))
    cpu_pred, cpu_per_class = match.engine_for(
        backend="kernel").classify_features(x["f"].cpu(), cpu_big)
    check(torch.equal(pred.cpu(), cpu_pred) and
          torch.equal(per_class.cpu(), cpu_per_class),
          "big bank: the card and the CPU answer differently")
    report["big_bank"] = dict(
        launches=counts, wall_s=wall,
        profile=profile(lambda: eng.classify_features(x["f"], big), reps=20))
    report.update(similarity_paths(device, model, head, test_x, test_y,
                                   feats))
    return report


def similarity_paths(device, model, head, test_x, test_y, feats) -> dict:
    """The similarity method's paths (B5, B6, B7a, B7b) at paper width."""
    import tempfile

    import torch

    from repro_torch import match
    from repro_torch.core.hybrid import HybridClassifier
    from repro_torch.core.templates import TemplateBank
    from repro_torch.kernels import layout
    from repro_torch.kernels.acam_similarity import acam_similarity as asim
    from repro_torch.launch import serve as launcher
    from repro_torch.match import EngineConfig
    from repro_torch.models.cnn import student_features
    from repro_torch.serve import acam_service as svc_lib
    from repro_torch.serve.control import HybridService
    from repro_torch.serve.spec import (CascadeSpec, RegistrySpec,
                                        SchedulerSpec, ServiceSpec)

    report = {}
    n = feats.shape[1]
    bank = head.bank

    # -- HybridClassifier.predict with a similarity head (B5) ---------------
    sim_clf = HybridClassifier(model, student_features,
                               head._replace(method="similarity"),
                               device=device)
    pred, counts, wall = drive("predict_similarity",
                               lambda: sim_clf.predict(test_x),
                               ["acam_similarity_classify"])
    want, _ = asim.classify_plain(
        feats, bank.thresholds, layout.flatten_kmajor(bank.lower, 10),
        layout.flatten_kmajor(bank.upper, 10),
        layout.valid_kmajor(bank.valid, 10), 10)
    check(pred.shape == (256,) and torch.equal(pred, want),
          "predict (similarity): kernel preds differ from the plain path")
    check(counts["acam_similarity_classify"] == 1,
          f"predict (similarity): {counts['acam_similarity_classify']} B5 "
          "launches, expected one")
    report["predict_similarity"] = dict(
        launches=counts, wall_s=wall,
        accuracy_vs_labels=float((pred.cpu().numpy() == test_y).mean()),
        profile=profile(lambda: sim_clf.predict(test_x)))

    # -- ACAMHead.scores, both methods (B7a, B7b) ----------------------------
    for method, kernel in (("feature_count", "acam_match"),
                           ("similarity", "acam_similarity")):
        h = head._replace(method=method)
        got, counts, wall = drive(f"scores_{method}",
                                  lambda: h.scores(feats), [kernel])
        want = h._replace(backend="reference").scores(feats)
        check(got.shape == (256, 10) and bool(torch.isfinite(got).all())
              and torch.equal(got, want),
              f"ACAMHead.scores ({method}): kernel differs from the "
              "reference backend")
        report[f"scores_{method}"] = dict(launches=counts, wall_s=wall)

    # -- the similarity service, booted from a spec file by the launcher ----
    spec = ServiceSpec(
        registry=RegistrySpec(num_features=n),
        engine=EngineConfig(method="similarity", backend="kernel",
                            margin=True),
        scheduler=SchedulerSpec(slots=64),
        cascade=CascadeSpec(tau=SIM_TAU, tau_units="count"))
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "similarity_service.json"
        path.write_text(spec.to_json())
        argv = ["--workload", "acam", "--spec", str(path), "--tenants",
                str(TENANTS), "--classes", "10", "--requests", "256"]
        out, counts, wall = drive(
            "serve_similarity", lambda: launcher.main(argv, device=device),
            ["acam_similarity_serve"])
        cpu = launcher.main(argv, device="cpu")
    resp = out.pop("responses")
    check(counts["acam_similarity_serve"] == out["classify_dispatches"],
          f"serve_similarity: {counts['acam_similarity_serve']} launches vs "
          f"{out['classify_dispatches']} dispatches")
    check(len(resp) == 256 and all(r.error is None for r in resp),
          "serve_similarity: every request answered without error")
    check(0.0 < out["escalation_rate"] < 1.0,
          f"serve_similarity: escalation rate {out['escalation_rate']}")
    for a, b in zip(resp, cpu.pop("responses")):
        check((a.pred, a.margin, a.escalated, a.energy_j) ==
              (b.pred, b.margin, b.escalated, b.energy_j),
              "serve_similarity: the card and the CPU answer differently")
    # the same service again, for its traced run and one tick's engine call
    svc = HybridService.from_spec(spec, device=device)
    reqs = []
    for t in range(TENANTS):
        bnk, hwb, protos = svc_lib.make_synthetic_tenant(
            t, num_classes=10, num_features=n)
        svc.register_tenant(f"tenant-{t}", bnk, head=hwb)
        f, _ = svc_lib.sample_tenant_queries(7 * t, protos, 256 // TENANTS)
        reqs += [svc_lib.ClassifyRequest(f"tenant-{t}", row) for row in f]
    entries = [svc.registry.get(r.tenant_id) for r in reqs[:64]]
    tick_in = [torch.as_tensor(np.asarray(v), device=device) for v in (
        np.stack([r.features for r in reqs[:64]]), [e.slot for e in entries],
        [e.window[0] for e in entries], [e.window[1] for e in entries],
        [SIM_TAU / n] * 64)]
    eng = match.engine_from_config(svc.spec.engine)
    report["serve_similarity"] = dict(
        launches=counts, wall_s=wall, metrics=out,
        tick_ms=out["tick_time_s"] / out["ticks"] * 1e3,
        engine_call_ms=time_ms(lambda: eng.classify_serve(
            tick_in[0], svc.registry.thresholds_table(), tick_in[1],
            svc.registry.device_bank(), tick_in[2], tick_in[3],
            tick_in[4].to(torch.float32))),
        profile=profile(lambda: svc.serve(reqs)))

    # -- a similarity bank past MAX_FUSED_ROWS (B6, margins face) -----------
    x = sim_case(13, 64, 1100, 2, n, device, "binary")
    big = TemplateBank(x["t"], x["lower"], x["upper"], x["valid"], x["thr"])
    check(2 * layout.padded_classes(1100) > match.MAX_FUSED_ROWS,
          "big bank exceeds the fused-row budget")
    eng = match.engine_for(method="similarity", backend="kernel")
    got, counts, wall = drive(
        "big_bank_similarity",
        lambda: eng.classify_features_margin(x["f"], big),
        ["acam_similarity_serve"])
    want = asim.serve_plain(
        x["f"], x["thr"][None, :], torch.zeros(64, dtype=torch.int32,
                                               device=device),
        layout.stack_kcp(x["lower"], 1100), layout.stack_kcp(x["upper"], 1100),
        layout.valid_kcp(x["valid"], 1100),
        torch.zeros(64, dtype=torch.int32, device=device),
        torch.full((64,), 1100, dtype=torch.int32, device=device),
        torch.full((64,), float("-inf"), device=device), 1100,
        chunk=layout.class_chunk(1152, 2, match.MAX_FUSED_ROWS))
    compare("big bank (similarity)", got, want[:3])
    check(counts["acam_similarity_serve"] == 1,
          f"big bank (similarity): {counts['acam_similarity_serve']} B6 "
          "launches, expected one")
    rows = int(x["valid"].sum())
    ms, by, nbytes = sim_bound("acam_similarity_serve", 64, 1100, 2, n, rows,
                               1)
    report["big_bank_similarity"] = dict(
        launches=counts, wall_s=wall, valid_rows=rows, bound_ms=ms,
        bound_by=by, bound_bytes=nbytes,
        profile=profile(lambda: eng.classify_features_margin(x["f"], big),
                        reps=20))
    return report


def replay_student(model, x, qat: bool, branches=None):
    """`Student.forward(x, train=True, quantize=qat)` with its branch
    decisions exposed: the four ReLU masks and the two max-pool argmaxes are
    recorded (``branches=None``) or imposed (the given ones, e.g. another
    device's). Returns (logits, branches). The same arithmetic as the
    model's forward, so the same gradients wherever the branches agree."""
    import torch.nn.functional as F

    from repro_torch.core import quant
    from repro_torch.models import cnn

    given = iter(branches) if branches is not None else None
    taken = []

    def decide(make):
        taken.append(next(given).to(x.device) if given else make())
        return taken[-1]

    def conv_relu(m, h):
        w = quant.fake_quant_int8(m.weight) if qat else m.weight
        pre = F.conv2d(h, w, m.bias, padding=m.padding)
        return pre * decide(lambda: (pre > 0).to(pre.dtype))

    def pool(h):
        idx = decide(lambda: F.max_pool2d(h, 2, return_indices=True)[1])
        return h.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)

    h = x.permute(0, 3, 1, 2)
    h = pool(cnn.batchnorm(model.bn1, conv_relu(model.conv1, h), train=True))
    h = pool(cnn.batchnorm(model.bn2, conv_relu(model.conv2, h), train=True))
    h = conv_relu(model.conv4, conv_relu(model.conv3, h))
    return model.head(h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)), taken


def rel_l2(a, b) -> float:
    """||a - b|| / ||b|| in float64 on the CPU."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def training_paths(device) -> dict:
    """The paper's training path (§II) at full width, no depth cut: the
    ResNet teacher (width 16, 3 blocks per stage; 1 epoch at batch 128), then
    the Fig. 5 student with KD from its logits, curriculum, the prune ramp
    and fine-tune, and QAT; then `fit_acam_head` and `predict` (B1) on the
    trained front end, all on the card. Also the fused loss (B8) on the
    trained student's logits against the trainer's Eq. 1, the first step's
    gradients on the card against the CPU's, and one traced train step.
    Returns (the driven paths, the training measurements, the trained
    front end: its feature function, the student and the data)."""
    import copy

    import torch

    from repro_torch.core import distill, prune, quant
    from repro_torch.core.hybrid import HybridClassifier, fit_acam_head
    from repro_torch.data import synthetic
    from repro_torch.kernels import layout
    from repro_torch.kernels.acam_match import acam_match as am
    from repro_torch.kernels.kd_loss import ops as kd_ops
    from repro_torch.models import cnn
    from repro_torch.optim import optimizers as optim
    from repro_torch.train import cnn_trainer as tr

    report = {}
    train = synthetic.load("train", n_per_class=64, seed=0)
    x = synthetic.normalize(synthetic.to_grayscale(train.images))
    y = train.labels
    test = synthetic.load("test", n_per_class=26, seed=0)
    test_x = synthetic.normalize(synthetic.to_grayscale(test.images))[:256]
    test_y = test.labels[:256]

    # -- the teacher ---------------------------------------------------------
    tcfg = cnn.TeacherConfig(in_channels=1)
    t_losses = []
    t0 = time.perf_counter()
    teacher = tr.train_teacher(x, y, tcfg, epochs=1, batch_size=128,
                               device=device, losses=t_losses)
    torch.cuda.synchronize()
    t_wall = time.perf_counter() - t0
    zt = cnn.teacher_logits(teacher, x).cpu().numpy()
    check(all(bool(torch.isfinite(v)) for v in t_losses) and
          len(t_losses) == len(y) // 128, f"teacher: {len(t_losses)} steps, "
          "every loss finite")
    teacher_report = dict(
        steps=len(t_losses), wall_s=t_wall, params=cnn.count_params(teacher),
        macs=cnn.teacher_macs(tcfg),
        losses=[float(v) for v in t_losses],
        accuracy_train=tr.evaluate(cnn.teacher_logits, teacher, x, y))

    # -- the student: KD + curriculum, prune ramp + fine-tune, QAT ----------
    cfg = tr.TrainConfig(epochs=2, batch_size=128, prune_epochs=2,
                         finetune_epochs=1, qat=True, seed=0)
    s_losses = []
    t0 = time.perf_counter()
    student, masks = tr.train_student(
        x, y, student_cfg=cnn.StudentConfig(), teacher_logits_all=zt,
        cfg=cfg, do_prune=True, device=device, losses=s_losses)
    torch.cuda.synchronize()
    s_wall = time.perf_counter() - t0
    check(len(s_losses) > 0 and all(bool(torch.isfinite(v))
                                    for v in s_losses),
          "student: every loss finite")
    params = tr.params_of(student)
    prunable = [v for v in params.values() if v.ndim >= 2]
    total = sum(v.numel() for v in prunable)
    sparsity = prune.sparsity_of(params)
    target = float(prune.polynomial_sparsity(cfg.prune_epochs,
                                             cfg.prune_epochs))
    # each tensor's quantile threshold keeps all but ceil-or-floor of its
    # elements: one element per tensor of slack
    check(abs(sparsity - target) <= len(prunable) / total,
          f"student sparsity {sparsity} vs the final {target}")
    check(all(not bool(params[k][~m].any()) for k, m in masks.items()),
          "pruned weights stay zero")

    # -- the first step's gradients, card vs CPU (TF32 off in the backward) -
    # Through the trainer's `value_and_grad` on both devices, with the
    # student's forward replayed on the branches the card took: a
    # pre-activation within rounding of 0 may fall on the other side of a
    # ReLU kink on the other device, and one such flip moves the gradients
    # of the layers below it far more than rounding does, while TF32 moves
    # every gradient.
    loss_fn = tr.student_loss(cfg, kd=True)
    order = distill.curriculum_order(torch.as_tensor(zt),
                                     torch.as_tensor(y)).numpy()
    limit = distill.CurriculumSchedule(cfg.curriculum_start_frac,
                                       cfg.epochs - 1).available(0, len(y))
    sel = np.random.RandomState(cfg.seed * 9973).permutation(
        order[:limit])[:cfg.batch_size]
    batch = (x[sel], y[sel], zt[sel])
    fresh = cnn.init_student(torch.Generator().manual_seed(cfg.seed),
                             device="cpu")
    dev_batch = tr.to_device(batch, device)
    cpu_batch = tr.to_device(batch, "cpu")

    def replayed_loss(branches):
        def loss(model, xb, yb, ztb):
            logits = replay_student(model, xb, cfg.qat, branches)[0]
            return distill.distillation_loss(
                logits, ztb, yb, alpha=cfg.distill_alpha,
                temperature=cfg.distill_temperature)
        return loss

    with torch.no_grad(), cnn.fp32(device):
        on_card = copy.deepcopy(fresh).to(device)
        logits_dev, branches = replay_student(on_card, dev_batch[0], cfg.qat)
        replay_err = rel_l2(logits_dev, on_card(dev_batch[0], train=True,
                                                quantize=cfg.qat))
        check(replay_err <= 1e-5, f"the replayed student's logits are "
              f"{replay_err} (relative L2) from Student.forward's")
    loss_dev, g_dev = tr.value_and_grad(replayed_loss(branches),
                                        copy.deepcopy(fresh).to(device),
                                        dev_batch)
    card_branches = [b.cpu() for b in branches]
    loss_cpu, g_cpu = tr.value_and_grad(replayed_loss(card_branches),
                                        copy.deepcopy(fresh), cpu_batch)
    grad_err = {k: rel_l2(g_dev[k], g_cpu[k]) for k in g_cpu}
    check(max(grad_err.values()) <= GRAD_RTOL,
          f"first-step gradients, card vs CPU on the card's branches: "
          f"{grad_err}")
    check(rel_l2(loss_dev, loss_cpu) <= 1e-5, "first-step loss, card vs CPU")
    # the trainer's own loss on each device: the loss agrees; the gradients
    # are reported with the number of branches the two devices took apart
    own_dev, g_own_dev = tr.value_and_grad(loss_fn, on_card, dev_batch)
    own_cpu, g_own_cpu = tr.value_and_grad(loss_fn, copy.deepcopy(fresh),
                                           cpu_batch)
    check(rel_l2(own_dev, own_cpu) <= 1e-5, "the trainer's first-step loss, "
          "card vs CPU")
    own_err = {k: rel_l2(g_own_dev[k], g_own_cpu[k]) for k in g_own_cpu}
    with torch.no_grad():
        cpu_branches = replay_student(copy.deepcopy(fresh), cpu_batch[0],
                                      cfg.qat)[1]
    flips = sum(int((a != b).sum())
                for a, b in zip(card_branches, cpu_branches))
    # QAT's int8 grid: the same on the card as on the CPU, bit for bit
    for model in (fresh, student):
        for name, w in model.named_parameters():
            if w.ndim >= 2:
                check(torch.equal(quant.fake_quant_int8(w.detach().cpu()),
                                  quant.fake_quant_int8(
                                      w.detach().to(device)).cpu()),
                      f"fake_quant_int8({name}): card and CPU differ")
    # the same forward and backward under cuDNN's TF32 default (no `fp32`
    # around them), to show what the check would catch
    tf32_model = copy.deepcopy(fresh).to(device)
    with torch.enable_grad():
        tf32_g = torch.autograd.grad(
            replayed_loss(branches)(tf32_model, *dev_batch),
            list(tf32_model.parameters()))
    tf32_err = {k: rel_l2(g, g_cpu[k]) for (k, _), g in
                zip(tf32_model.named_parameters(), tf32_g)}

    # -- B8 on the trained student's logits vs the trainer's Eq. 1 ----------
    xb, yb, ztb = tr.to_device((x[:128], y[:128], zt[:128]), device)
    zs = cnn.student_logits(student, xb, quantize=True)
    fused, counts, wall = drive(
        "kd_loss", lambda: kd_ops.distillation_loss(
            zs, ztb, yb, temperature=cfg.distill_temperature,
            alpha=cfg.distill_alpha), ["kd_loss"])
    want = distill.distillation_loss(zs, ztb, yb, alpha=cfg.distill_alpha,
                                     temperature=cfg.distill_temperature)
    check(abs(float(fused) - float(want)) <= 1e-4 * abs(float(want)),
          f"B8 distillation_loss {float(fused)} vs core.distill "
          f"{float(want)}")
    report["kd_loss"] = dict(launches=counts, wall_s=wall,
                             fused=float(fused), trainer_loss=float(want))
    training = {}

    # -- the trained front end served: fit_acam_head, predict (B1) ----------
    def features(p, a):
        return cnn.student_features(p, a, quantize=True)

    head = fit_acam_head(features, student, x, y, 10, device=device)
    clf = HybridClassifier(student, features, head, device=device)
    pred, counts, wall = drive("predict_trained",
                               lambda: clf.predict(test_x),
                               ["acam_match_classify"])
    feats = features(student, test_x)
    check(feats.shape == (256, 784) and bool(torch.isfinite(feats).all()),
          "trained student: finite (256, 784) features")
    bank = head.bank
    want_pred, _ = am.classify_plain(
        feats, bank.thresholds, layout.flatten_kmajor(bank.templates, 10),
        layout.valid_kmajor(bank.valid, 10), 10)
    check(torch.equal(pred, want_pred), "predict (trained): kernel preds "
          "differ from the plain path")

    # -- one traced train step (a copy, so the trained student stays) -------
    prof_model = copy.deepcopy(student)
    opt = optim.adamw(cfg.lr, weight_decay=cfg.weight_decay)
    state = opt.init(tr.params_of(prof_model))
    step = tr._make_step(loss_fn, opt, masks)
    training["train_teacher"] = teacher_report
    training["train_student"] = dict(
        steps=len(s_losses), wall_s=s_wall, losses=[float(v)
                                                    for v in s_losses],
        sparsity=sparsity, sparsity_target=target,
        params=cnn.count_params(student),
        grad_rel_l2_card_vs_cpu=grad_err,
        grad_rel_l2_card_vs_cpu_own_branches=own_err,
        replay_logits_rel_l2=replay_err,
        branch_flips_card_vs_cpu=flips,
        grad_rel_l2_tf32_vs_cpu=tf32_err,
        metrics_test=tr.metrics(
            lambda p, a: cnn.student_logits(p, a, quantize=True), student,
            test_x, test_y),
        step_ms=time_ms(lambda: step(prof_model, state, dev_batch), 20),
        step_profile=profile(lambda: step(prof_model, state, dev_batch),
                             reps=10))
    report["predict_trained"] = dict(
        launches=counts, wall_s=wall,
        accuracy_vs_labels=float((pred.cpu().numpy() == test_y).mean()),
        profile=profile(lambda: clf.predict(test_x)))
    trained = dict(features=features, student=student, train=(x, y),
                   test=(test_x, test_y))
    return report, training, trained


@contextlib.contextmanager
def nondeterministic_training():
    """The trainer as it was before its deterministic mode: cuDNN's flags
    passed through unchanged (free to pick non-deterministic backward
    algorithms) and no `torch.use_deterministic_algorithms`. Only for
    showing where two runs part and what the mode costs."""
    import torch

    from repro_torch.models import cnn
    from repro_torch.train import cnn_trainer as tr

    @contextlib.contextmanager
    def passthrough_fp32(dev):
        if dev.type != "cuda":
            yield
            return
        cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
        prev = matmul.allow_tf32
        matmul.allow_tf32 = False
        try:
            with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                             deterministic=cudnn.deterministic,
                             allow_tf32=False):
                yield
        finally:
            matmul.allow_tf32 = prev

    saved = cnn.fp32, tr.deterministic
    cnn.fp32 = passthrough_fp32
    tr.deterministic = lambda dev: contextlib.nullcontext()
    try:
        yield
    finally:
        cnn.fp32, tr.deterministic = saved


def recorded_training(fn):
    """``fn()`` with the trainer's step wrapped to keep a copy of the
    model's parameters and BatchNorm buffers after every step; returns
    (fn's result, the copies in step order)."""
    from repro_torch.train import cnn_trainer as tr

    states, make_step = [], tr._make_step

    def recording(*args, **kw):
        step = make_step(*args, **kw)

        def recorded(model, opt_state, batch):
            out = step(model, opt_state, batch)
            states.append({k: v.detach().clone()
                           for k, v in model.state_dict().items()})
            return out
        return recorded

    tr._make_step = recording
    try:
        return fn(), states
    finally:
        tr._make_step = make_step


def first_divergence(a: list, b: list):
    """The first step after which two runs' states differ, and the tensors
    that differ there (None when every step is bitwise equal)."""
    import torch

    check(len(a) == len(b), f"two runs took {len(a)} and {len(b)} steps")
    for i, (sa, sb) in enumerate(zip(a, b)):
        apart = [k for k in sa if not torch.equal(sa[k], sb[k])]
        if apart:
            return dict(step=i + 1, tensors=apart)
    return None


def training_repeatability(device) -> dict:
    """Training as a function of its seed, on the card: the teacher (1
    epoch, 5 steps) and the KD + curriculum + prune + QAT student of
    `training_paths` (22 steps), each trained twice from one seed under the
    trainer's deterministic mode, every parameter and BatchNorm buffer
    bitwise equal after every step. The same two runs without the mode
    (`nondeterministic_training`) name the first step and tensors at which
    they part, and the device time of the student's 22 steps with the mode
    is set against its time without it (profiled in turns: without, with,
    with, without)."""
    import torch

    from repro_torch.data import synthetic
    from repro_torch.models import cnn
    from repro_torch.train import cnn_trainer as tr

    train = synthetic.load("train", n_per_class=64, seed=0)
    x = synthetic.normalize(synthetic.to_grayscale(train.images))
    y = train.labels
    tcfg = cnn.TeacherConfig(in_channels=1)
    cfg = tr.TrainConfig(epochs=2, batch_size=128, prune_epochs=2,
                         finetune_epochs=1, qat=True, seed=0)

    def teacher():
        return tr.train_teacher(x, y, tcfg, epochs=1, batch_size=128,
                                device=device)

    def student(zt):
        return tr.train_student(x, y, student_cfg=cnn.StudentConfig(),
                                teacher_logits_all=zt, cfg=cfg,
                                do_prune=True, device=device)

    report = {}
    for mode, ctx in (("without", nondeterministic_training),
                      ("with", contextlib.nullcontext)):
        with ctx():
            t1, t_states1 = recorded_training(teacher)
            t2, t_states2 = recorded_training(teacher)
            zt = cnn.teacher_logits(t1, x).cpu().numpy()
            _, s_states1 = recorded_training(lambda: student(zt))
            _, s_states2 = recorded_training(lambda: student(zt))
        report[mode] = dict(
            teacher_steps=len(t_states1), student_steps=len(s_states1),
            teacher_divergence=first_divergence(t_states1, t_states2),
            student_divergence=first_divergence(s_states1, s_states2))
        del t_states1, t_states2, s_states1, s_states2
    with_ = report["with"]
    check(with_["teacher_divergence"] is None
          and with_["student_divergence"] is None,
          f"deterministic training: two runs from one seed differ: {with_}")
    check(with_["student_steps"] == 22 and with_["teacher_steps"] == 5,
          f"training_repeatability: {with_['teacher_steps']} teacher and "
          f"{with_['student_steps']} student steps, not 5 and 22")
    zt = cnn.teacher_logits(t1, x).cpu().numpy()
    times = {"without": [], "with": []}
    for mode in ("without", "with", "with", "without"):
        ctx = (nondeterministic_training if mode == "without"
               else contextlib.nullcontext)
        with ctx():
            times[mode].append(profile(lambda: student(zt)))
    for mode, runs in times.items():
        report[mode]["student_device_ms"] = [r["device_ms"] for r in runs]
        report[mode]["student_wall_ms"] = [r["wall_ms"] for r in runs]
    torch.cuda.synchronize()
    return report


def attention_path(device) -> dict:
    """B9 through its entry point, `ops.attention`, at the bench shape
    (1, 1024, 8 heads, 2 kv heads, 64) bf16 causal, held against the model's
    `chunked_attention` on the card."""
    import torch

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models.layers import chunked_attention

    q, k, v = fa_case(630, 1, 1024, 8, 2, 64, device, torch.bfloat16)
    out, counts, wall = drive(
        "attention", lambda: fa_ops.attention(q, k, v, causal=True),
        ["flash_attention"])
    fa_compare("attention path vs chunked_attention", out,
               chunked_attention(q, k, v, causal=True), FA_TOL_BF16)
    return {"attention": dict(launches=counts, wall_s=wall)}


# ---------------------------------------------------------------------------
# 3. the §III device physics (plain PyTorch on the card, no kernel)
# ---------------------------------------------------------------------------

DEVICE_CELLS = ("6T4R", "3T1R")
DEVICE_SIGMAS = (0.0, 0.05)
DEVICE_DRAWS = 8
DEVICE_MARGIN_ATOL = 1e-6  # served margins card vs CPU at sigma > 0
# the device service's cascade threshold in match-count units (tau / N in
# matchline fractions): inside the ideal array's served margins (about 170
# to 256 counts on these tenants), so some requests escalate at sigma 0
DEVICE_TAU = 200.0
CALIBRATION_STEPS = 20


def sense_bound(b: int, rows: int, n: int) -> dict:
    """The least time of one `acam.sense` pass over a programmed array:
    each input read once (the binarised queries (B, N) f32, the programmed
    lower and upper edges (rows, N) f32 each, valid (rows,) bool) and each
    output written once (the (B, rows) f32 scores), over HBM_BYTES_PER_S;
    against two compares, an AND and an add per (query, row, cell) at
    INSTR_PER_S."""
    nbytes = 4 * b * n + 8 * rows * n + rows + 4 * b * rows
    ops = 4 * b * rows * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INSTR_PER_S * 1e3
    return dict(bytes=nbytes, bytes_ms=t_bytes, operations=ops,
                operations_ms=t_ops, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def device_physics(device) -> dict:
    """The device-physics backend (`repro_torch.core.acam`, RRAM-CMOS §III)
    through its entry points at full width, held against the same calls on
    the CPU: the served path (the launcher with a ``backend="device"`` spec,
    both cells at sigma_program 0 and 0.05), the big bank's
    `classify_features_margin` and `sweep_program_noise` (8 draws, "global"
    and "per_shard" over 2 arrays), and `to_acam` + `calibrate_windows` on
    the predict shape (the head and features of `paths`' predict, rebuilt
    from the same seeds)."""
    import tempfile

    import torch

    from repro_torch import match
    from repro_torch.core import acam, quant
    from repro_torch.core.hybrid import fit_acam_head
    from repro_torch.core.templates import TemplateBank
    from repro_torch.launch import serve as launcher
    from repro_torch.match import EngineConfig
    from repro_torch.models.cnn import StudentConfig, init_student, \
        student_features
    from repro_torch.serve import acam_service as svc_lib
    from repro_torch.serve.control import HybridService
    from repro_torch.serve.spec import (CascadeSpec, RegistrySpec,
                                        SchedulerSpec, ServiceSpec)

    model = init_student(torch.Generator().manual_seed(0), StudentConfig(),
                         device=device)
    rng = np.random.default_rng(0)
    protos = rng.standard_normal((10, 32, 32, 1)).astype(np.float32)
    cal_y = np.repeat(np.arange(10), 64)
    head = fit_acam_head(student_features, model,
                         class_images(rng, protos, cal_y, 0.5), cal_y, 10,
                         device=device)
    test_y = rng.integers(0, 10, 256)
    with torch.no_grad():
        feats = student_features(model, class_images(rng, protos, test_y,
                                                     0.5))
    n = feats.shape[1]
    cpu = torch.device("cpu")
    out = dict(served={}, sweep={})
    for mod in launch_modules():
        mod.reset_launches()
    t_phase = time.perf_counter()

    # -- the served path: launch.serve.main with a "device" spec ------------
    reqs = []
    for t in range(TENANTS):
        _, _, protos = svc_lib.make_synthetic_tenant(
            t, num_classes=10, num_features=n)
        f, _ = svc_lib.sample_tenant_queries(7 * t, protos, 256 // TENANTS)
        reqs += [svc_lib.ClassifyRequest(f"tenant-{t}", row) for row in f]
    for cell in DEVICE_CELLS:
        for sigma in DEVICE_SIGMAS:
            spec = ServiceSpec(
                registry=RegistrySpec(num_features=n),
                engine=EngineConfig(backend="device", margin=True,
                                    device=acam.ACAMConfig(
                                        cell=cell, sigma_program=sigma)),
                scheduler=SchedulerSpec(slots=64),
                cascade=CascadeSpec(tau=DEVICE_TAU, tau_units="count"))
            with tempfile.TemporaryDirectory() as tmp:
                path = Path(tmp) / "device_service.json"
                path.write_text(spec.to_json())
                argv = ["--workload", "acam", "--spec", str(path),
                        "--tenants", str(TENANTS), "--classes", "10",
                        "--requests", "256"]
                t0 = time.perf_counter()
                got = launcher.main(argv, device=device)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                want = launcher.main(argv, device="cpu")
            resp, cpu_resp = got.pop("responses"), want.pop("responses")
            name = f"{cell} sigma {sigma}"
            check(len(resp) == 256 and all(r.error is None for r in resp),
                  f"device serve ({name}): every request answered")
            check(all(np.isfinite(r.margin) and 0.0 <= r.margin <= 1.0
                      for r in resp),
                  f"device serve ({name}): margins in [0, 1] fractions")
            same = all((a.pred, a.margin, a.escalated, a.energy_j) ==
                       (b.pred, b.margin, b.escalated, b.energy_j)
                       for a, b in zip(resp, cpu_resp))
            if sigma == 0.0:
                check(same, f"device serve ({name}): the card and the CPU "
                      "answer differently")
                check(0.0 < got["escalation_rate"] < 1.0,
                      f"device serve ({name}): escalation rate "
                      f"{got['escalation_rate']}")
            check(all((a.pred, a.escalated) == (b.pred, b.escalated)
                      and abs(a.margin - b.margin) <= DEVICE_MARGIN_ATOL
                      for a, b in zip(resp, cpu_resp)),
                  f"device serve ({name}): card and CPU decisions differ")
            svc = HybridService.from_spec(spec, device=device)
            for t in range(TENANTS):
                bnk, hwb, _ = svc_lib.make_synthetic_tenant(
                    t, num_classes=10, num_features=n)
                svc.register_tenant(f"tenant-{t}", bnk, head=hwb)
            out["served"][name] = dict(
                wall_s=wall, bit_identical_to_cpu=same,
                tick_ms=got["tick_time_s"] / got["ticks"] * 1e3,
                ticks=got["ticks"],
                escalation_rate=got["escalation_rate"],
                accuracy=got["accuracy"], metrics=got,
                profile=profile(lambda: svc.serve(reqs)))

    # -- the big bank: classify_features_margin, then the sweep -------------
    x = case(17, 64, 1100, 2, n, device)
    big = TemplateBank(x["t"], x["t"], x["t"], x["valid"], x["thr"])
    big_cpu = TemplateBank(*(v.cpu() for v in big))
    eng = match.engine_for(backend="device")
    t0 = time.perf_counter()
    got = eng.classify_features_margin(x["f"], big)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    want = eng.classify_features_margin(x["f"].cpu(), big_cpu)
    check(all(torch.equal(g.cpu(), w) for g, w in zip(got, want)),
          "device big bank: the card and the CPU answer differently")
    check(got[1].shape == (64, 1100) and bool(torch.isfinite(got[2]).all()),
          "device big bank: (64, 1100) scores, finite margins")
    ideal = got[0]
    out["big_bank"] = dict(
        wall_s=wall, shape=dict(B=64, C=1100, K=2, N=n),
        sense_bound=sense_bound(64, 2200, n),
        profile=profile(lambda: eng.classify_features_margin(x["f"], big),
                        reps=5))
    noisy = acam.ACAMConfig(sigma_program=0.05)
    fields = {}
    for mode, shards in (("global", None), ("per_shard", 2)):
        eng = match.engine_for(backend="device", device=noisy,
                               device_noise=mode)

        def sweep(on, eng=eng, shards=shards):
            return eng.sweep_program_noise(
                x["f"].to(on), big if on == device else big_cpu,
                DEVICE_DRAWS, bank_shards=shards, device=on)

        t0 = time.perf_counter()
        pred, per_class = sweep(device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        cpu_pred, cpu_pc = sweep(cpu)
        check(pred.shape == (DEVICE_DRAWS, 64),
              f"sweep ({mode}): (draws, B) preds")
        for m in range(DEVICE_DRAWS):
            check(torch.equal(pred[m].cpu(), cpu_pred[m]),
                  f"sweep ({mode}): draw {m} predicts differently on the "
                  "card and the CPU")
        check(not torch.equal(per_class[0], per_class[1]),
              f"sweep ({mode}): draws 0 and 1 programmed the same array")
        fields[mode] = per_class
        agree = (pred == ideal[None]).float().mean(1)
        out["sweep"][mode] = dict(
            wall_s=wall, draws=DEVICE_DRAWS, bank_shards=shards or 1,
            per_class_bit_identical_to_cpu=torch.equal(per_class.cpu(),
                                                       cpu_pc),
            agreement_with_ideal=agree.cpu().tolist(),
            profile=profile(lambda: sweep(device)))
    check(not torch.equal(fields["global"], fields["per_shard"]),
          'sweep: "global" and "per_shard" programmed the same arrays')

    # -- to_acam + calibrate_windows on the predict shape -------------------
    q = quant.binarize(feats, head.bank.thresholds)
    labels = torch.as_tensor(test_y, device=device)
    prog = head.to_acam(device=device)
    losses = [float(acam.calibration_loss(prog, q, labels))]
    stepped = prog
    for _ in range(CALIBRATION_STEPS):
        stepped = acam.calibrate_windows(stepped, q, labels, steps=1)
        losses.append(float(acam.calibration_loss(stepped, q, labels)))
    t0 = time.perf_counter()
    cal = acam.calibrate_windows(prog, q, labels, steps=CALIBRATION_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    final = float(acam.calibration_loss(cal, q, labels))
    check(all(np.isfinite(v) for v in losses + [final]),
          "calibration: finite losses")
    check(final < losses[0] and losses[-1] < losses[0],
          f"calibration: loss {losses[0]} -> {final} is not falling")
    check(bool((cal.upper >= cal.lower).all()),
          "calibration: inverted windows")
    out["calibration"] = dict(
        wall_s=wall, steps=CALIBRATION_STEPS, rows=int(prog.lower.shape[0]),
        features=n, losses=losses, final_loss=final)
    for mod in launch_modules():
        check(not any(mod.LAUNCHES.values()),
              "device physics: a kernel launched on the device path")
    return dict(launches=launch_counts(),
                wall_s=time.perf_counter() - t_phase, **out)


def print_device_physics(dp: dict, mega: dict) -> None:
    """The device-physics phase's numbers, beside the kernel backend's
    serve ticks (``mega``) of the same run."""
    print(f"kernel backend serve ticks (mega, this run): tick "
          f"{mega['tick_ms']:.4f} ms, profile {json.dumps(mega['profile'])}")
    for name, r in dp["served"].items():
        print(f"device_physics serve ({name}): tick {r['tick_ms']:.4f} ms "
              f"over {r['ticks']} ticks, escalation rate "
              f"{r['escalation_rate']:.4f}, card == CPU bitwise "
              f"{r['bit_identical_to_cpu']}, profile "
              f"{json.dumps(r['profile'])}")
    bb = dp["big_bank"]
    print(f"device_physics big bank {json.dumps(bb['shape'])}: "
          f"classify_features_margin wall {bb['wall_s'] * 1e3:.3f} ms, "
          f"profile {json.dumps(bb['profile'])}, one sense pass "
          f"{json.dumps(bb['sense_bound'])}")
    for mode, r in dp["sweep"].items():
        print(f"device_physics sweep ({mode}, {r['draws']} draws, "
              f"{r['bank_shards']} arrays): wall {r['wall_s'] * 1e3:.3f} ms, "
              "per_class card == CPU bitwise "
              f"{r['per_class_bit_identical_to_cpu']}, profile "
              f"{json.dumps(r['profile'])}")
    cal = dp["calibration"]
    print(f"device_physics calibration ({cal['rows']} rows x "
          f"{cal['features']}): {cal['steps']} steps in "
          f"{cal['wall_s'] * 1e3:.3f} ms, loss {cal['losses'][0]:.6f} -> "
          f"{cal['final_loss']:.6f}")


# ---------------------------------------------------------------------------
# 4. the paper's evaluation: k-means templates, tables, tuning, quickstart
# ---------------------------------------------------------------------------

CENTROID_RTOL, CENTROID_ATOL = 1e-5, 1e-6  # card vs CPU k-means centroids
SILHOUETTE_ATOL = 1e-5  # card vs CPU silhouette scores
TIE_RTOL = 1e-5  # an assignment may flip only where two distances tie
BANK_FIELDS = ("templates", "lower", "upper", "valid")
#: the designs the raw-score kernels took before the tuning table, at the
#: earlier phases' shapes: (kernel, (B, M, N)) -> design
TODAYS_DESIGNS = {("acam_match", (256, 10, N)): "local",
                  ("acam_similarity", (256, 10, N)): "narrow",
                  ("acam_similarity", (64, 2200, N)): "wide"}
TUNE_SHAPES = ((1, 10, N), (256, 10, N))


@contextlib.contextmanager
def kmeans_calls(replay=None):
    """Record every `templates.kmeans` call's (centroids, assignment) in
    the yielded list; with ``replay`` (such a list), return its results in
    turn instead, moved to the caller's device (the card's clustering
    replayed on the CPU)."""
    from repro_torch.core import templates

    own = templates.kmeans
    calls = []
    it = iter(replay or ())

    def kmeans(x, k, **kw):
        if replay is None:
            out = own(x, k, **kw)
        else:
            out = tuple(v.to(x.device) for v in next(it))
        calls.append(out)
        return out

    templates.kmeans = kmeans
    try:
        yield calls
    finally:
        templates.kmeans = own


def assignment_flips(name: str, xs, card_calls, cpu_calls) -> list:
    """Points whose k-means assignment differs between the card and the
    CPU, each with its distances to both clusters on both devices. A flip
    is allowed only at a tie (the card's two distances within TIE_RTOL):
    anything else is a fault."""
    import torch

    flips = []
    for c, (x, (cc, ac), (cp, ap)) in enumerate(zip(xs, card_calls,
                                                  cpu_calls)):
        for i in torch.nonzero(ac.cpu() != ap).flatten().tolist():
            a, b = int(ac[i]), int(ap[i])
            d_card = ((x[i] - cc[[a, b]]) ** 2).sum(-1).tolist()
            d_cpu = ((x[i].cpu() - cp[[a, b]]) ** 2).sum(-1).tolist()
            flips.append(dict(class_=c, point=i, card=a, cpu=b,
                              card_distances=d_card, cpu_distances=d_cpu))
            print(f"{name}: class {c} point {i} assigned {a} on the card, "
                  f"{b} on the CPU; distances card {d_card}, CPU {d_cpu}")
            check(abs(d_card[0] - d_card[1]) <= TIE_RTOL * max(d_card),
                  f"{name}: class {c} point {i} flips without a tie")
    return flips


def same_bank(name: str, got, want) -> None:
    """The banks' templates, lower, upper and valid bit for bit; on a
    difference, the first entries with each device's value."""
    import torch

    for field in BANK_FIELDS:
        g, w = getattr(got, field).cpu(), getattr(want, field)
        if not torch.equal(g, w):
            where = torch.nonzero(g != w)[:4].tolist()
            raise AssertionError(
                f"{name}: {field} differs at {where} (card "
                f"{[g[tuple(i)].item() for i in where]}, CPU "
                f"{[w[tuple(i)].item() for i in where]}; thresholds card "
                f"{[got.thresholds[i[-1]].item() for i in where]})")


def templates_card_vs_cpu(device, feats, labels: np.ndarray) -> dict:
    """`kmeans`, `generate_templates` (k 2 and 3) and
    `select_k_by_silhouette` on the card and on the CPU with the same
    features: assignments equal (a flip only at a tie, printed, and then
    the CPU's pipeline replayed from the card's clustering), centroids
    within rtol 1e-5 / atol 1e-6, banks bit for bit, silhouette scores
    within 1e-5 and the same best k. Times each on the card."""
    import torch

    from repro_torch.core import templates

    y_card = torch.as_tensor(labels, device=device)
    cpu_feats, y_cpu = feats.cpu(), torch.as_tensor(labels)
    out = {}
    for k in (2, 3):
        t0 = time.perf_counter()
        with kmeans_calls() as card_calls:
            bank = templates.generate_templates(feats, y_card, 10, k=k)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        with kmeans_calls() as cpu_calls:
            cpu_bank = templates.generate_templates(cpu_feats, y_cpu, 10, k=k)
        xs = [feats[y_card == c] for c in range(10)
              if int((y_card == c).sum()) >= k]
        check(len(card_calls) == len(cpu_calls) == len(xs),
              f"k={k}: one k-means call per class with at least k samples")
        flips = assignment_flips(f"k-means k={k}", xs, card_calls,
                                 cpu_calls)
        if flips:
            with kmeans_calls(replay=card_calls):
                cpu_bank = templates.generate_templates(cpu_feats, y_cpu,
                                                        10, k=k)
        else:
            for (cc, _), (cp, _) in zip(card_calls, cpu_calls):
                check(torch.allclose(cc.cpu(), cp, rtol=CENTROID_RTOL,
                                     atol=CENTROID_ATOL),
                      f"k={k}: centroids differ past rtol 1e-5")
        same_bank(f"generate_templates k={k}", bank, cpu_bank)
        t0 = time.perf_counter()
        for x in xs:
            templates.kmeans(x, k)
        torch.cuda.synchronize()
        out[f"k{k}"] = dict(bank=bank, generate_s=card_s, flips=flips,
                            kmeans_s=time.perf_counter() - t0,
                            valid_rows=int(bank.valid.sum()))
    t0 = time.perf_counter()
    with kmeans_calls() as card_calls:
        best, scores = templates.select_k_by_silhouette(feats, y_card, 10)
    select_s = time.perf_counter() - t0
    replay = card_calls if any(out[f"k{k}"]["flips"] for k in (2, 3)) \
        else None
    with kmeans_calls(replay=replay):
        cpu_best, cpu_scores = templates.select_k_by_silhouette(
            cpu_feats, y_cpu, 10)
    check(best == cpu_best, f"silhouette best k {best} on the card, "
          f"{cpu_best} on the CPU")
    for k, v in scores.items():
        check(abs(v - cpu_scores[k]) <= SILHOUETTE_ATOL,
              f"silhouette k={k}: {v} on the card, {cpu_scores[k]} CPU")
    x = feats[y_card == 0]
    _, assign = templates.kmeans(x, 3)
    t0 = time.perf_counter()
    templates.silhouette_score(x, assign, 3)
    torch.cuda.synchronize()
    out["silhouette"] = dict(best_k=best, scores=scores,
                             cpu_scores=cpu_scores, select_s=select_s,
                             one_score_s=time.perf_counter() - t0,
                             replayed=replay is not None)
    return out


def paper_tables(device, out_dir: Path) -> tuple[dict, list]:
    """`repro_torch.benchmarks.run` at the REPRO_BENCH_FAST scale (120
    images a class, 2 epochs) with its kernel bench at B 1 and 256, into
    ``out_dir``: every number finite, the energy rows the analytic ones,
    Table I's parameters and MACs those of `cnn`."""
    import math

    from repro_torch.benchmarks import common
    from repro_torch.benchmarks import run as bench_run
    from repro_torch.core import energy
    from repro_torch.models import cnn

    os.environ["REPRO_BENCH_FAST"] = "1"
    os.environ.pop("REPRO_BENCH_SCALE", None)
    rows = bench_run.main(["--out", str(out_dir)], device=device)
    details = json.loads((out_dir / "bench_details.json").read_text())
    bench = json.loads((out_dir / "BENCH_torch_kernels.json").read_text())

    def finite(v):
        if isinstance(v, dict):
            return all(finite(u) for u in v.values())
        if isinstance(v, list):
            return all(finite(u) for u in v)
        return not isinstance(v, float) or math.isfinite(v)

    check(all(math.isfinite(us) for _, us, _ in rows),
          "paper tables: every row's time finite")
    check(finite(details) and finite(bench["entries"]),
          "paper tables: every number finite")
    check(bench["kernels"] == "cuda" and bench["card"],
          "kernel bench: the CUDA kernels on the card")
    want = {f"paper_{k}": round(v, 4)
            for k, v in energy.paper_numbers().items()}
    check(all(details["energy_model"][k] == v for k, v in want.items()),
          f"energy rows {details['energy_model']} vs analytic {want}")
    m = common.models(device)
    t1 = {r["model"]: r for r in details["table1_compression"]}
    s_macs = cnn.student_macs()["total"]
    for model, params, macs in (
            ("teacher_colour", cnn.count_params(m["teacher_color"]),
             cnn.teacher_macs(common.TEACHER_CFG_COLOR)),
            ("teacher_greyscale", cnn.count_params(m["teacher_gray"]),
             cnn.teacher_macs(common.TEACHER_CFG_GRAY)),
            ("student_base", cnn.count_params(m["student_base"]), s_macs),
            ("student_optimised", cnn.count_params(m["student_opt"]),
             int(s_macs * 0.2))):
        check((t1[model]["params"], t1[model]["macs"]) == (params, macs),
              f"table I {model}: params / MACs {t1[model]['params']} / "
              f"{t1[model]['macs']}, analytic {params} / {macs}")
    return dict(details, kernel_bench=bench), rows


def tuning_phase(device, cache_dir: Path) -> dict:
    """`tuning.autotune_acam` at (1, 10, 784) and (256, 10, 784) into a
    cache of its own (each candidate bit-identical to the plain version,
    or it raises), `get_block` returning each winner, every candidate's
    device time; then, with the empty cache back, the designs of the
    earlier phases' shapes those of the rule they took before the table."""
    import torch

    from repro_torch.kernels import tuning
    from repro_torch.kernels.acam_match import acam_match as am
    from repro_torch.kernels.acam_similarity import acam_similarity as asim

    empty = os.environ["REPRO_TORCH_TUNING_CACHE"]
    os.environ["REPRO_TORCH_TUNING_CACHE"] = str(cache_dir / "tuned.json")
    tuning.clear_cache_for_tests()
    try:
        times: dict = {}
        won = tuning.autotune_acam(TUNE_SHAPES, device=device, times=times)
        tuning.clear_cache_for_tests()
        device_ms = {}
        for key, design in won.items():
            kernel, _, shape, _ = key.split("|")
            b, m, n = (int(v[1:]) for v in shape.split("_"))
            check(tuning.get_block(kernel, (b, m, n), torch.float32,
                                   device) == design,
                  f"get_block {key}: not the winner {design}")
            f = torch_tensor((np.random.default_rng(b).integers(
                -8, 9, (b, n)) / 4).astype(np.float32), device)
            bank = torch_tensor((np.random.default_rng(m).random((m, n))
                                 > 0.5).astype(np.float32), device)
            zero = torch_tensor(np.zeros((m, n), np.float32), device)
            for blk in times[key]:
                fn = (lambda: am.acam_match(f, zero[0], bank, block=blk)) \
                    if kernel == "acam_match" else \
                    (lambda: asim.acam_similarity(f, zero, bank, block=blk))
                device_ms.setdefault(key, {})[blk] = profile(
                    fn, reps=20)["device_ms"]
    finally:
        os.environ["REPRO_TORCH_TUNING_CACHE"] = empty
        tuning.clear_cache_for_tests()
    for (kernel, shape), design in TODAYS_DESIGNS.items():
        got = tuning.get_block(kernel, shape, torch.float32, device)
        check(got == design, f"empty cache: {kernel} at {shape} takes {got}, "
              f"before the table {design}")
    return dict(winners=won, device_us=times, device_ms=device_ms,
                empty_cache=dict((f"{k}|{s}", d) for (k, s), d in
                                 TODAYS_DESIGNS.items()))


def paper_eval(device, trained: dict, out_dir: Path) -> tuple[dict, dict]:
    """Phase 4: templates card vs CPU on the trained student's features,
    K = 2 and 3 heads through B1, the paper's tables and the kernel bench,
    the tuning table, and the quickstart. Returns (driven paths, the
    phase's measurements)."""
    import torch

    from repro_torch.core.hybrid import ACAMHead, HybridClassifier
    from repro_torch.examples import quickstart
    from repro_torch.kernels import layout
    from repro_torch.kernels.acam_match import acam_match as am

    fn, student = trained["features"], trained["student"]
    (x, y), (test_x, test_y) = trained["train"], trained["test"]
    with torch.no_grad():
        feats = fn(student, x)
    t0 = time.perf_counter()
    found = templates_card_vs_cpu(device, feats, y)
    templates_s = time.perf_counter() - t0
    report = {}
    test_feats = fn(student, test_x)
    for k in (2, 3):
        bank = found[f"k{k}"]["bank"]
        clf = HybridClassifier(student, fn, ACAMHead(bank), device=device)
        pred, counts, wall = drive(f"predict_k{k}",
                                   lambda: clf.predict(test_x),
                                   ["acam_match_classify"])
        want, _ = am.classify_plain(
            test_feats, bank.thresholds,
            layout.flatten_kmajor(bank.templates, 10),
            layout.valid_kmajor(bank.valid, 10), 10)
        check(torch.equal(pred, want), f"predict K={k}: B1 differs from "
              "its plain version")
        report[f"predict_k{k}"] = dict(
            launches=counts, wall_s=wall, design=am.tiled_design(10 * k),
            accuracy_vs_labels=float((pred.cpu().numpy() == test_y).mean()))
    t0 = time.perf_counter()
    tables, rows = paper_tables(device, out_dir)
    tables_s = time.perf_counter() - t0
    tuned = tuning_phase(device, out_dir)
    got, counts, wall = drive(
        "quickstart", lambda: quickstart.main(["--fast", "--mc", "4"],
                                              device=device),
        ["acam_match_classify", "acam_match_serve"])
    numbers = [got["softmax_accuracy"], got["acam_accuracy"],
               *got["device_accuracy"].values(), got["service"]["accuracy"],
               got["ledger_total_nj"], *got["energy"].values()]
    numbers += [a for accs in got["mc"].values() for a in accs]
    check(all(np.isfinite(numbers)), "quickstart: every number finite")
    report["quickstart"] = dict(launches=counts, wall_s=wall)
    measured = dict(templates={k: {f: v for f, v in r.items() if f != "bank"}
                               for k, r in found.items()},
                    templates_s=templates_s, tables_s=tables_s,
                    tables=tables, rows=rows, tuning=tuned, quickstart=got)
    return report, measured


def print_paper_eval(pe: dict) -> None:
    print(f"paper_eval: {pe['wall_s']:.1f} s (templates card vs CPU "
          f"{pe['templates_s']:.1f} s, tables {pe['tables_s']:.1f} s)")
    t = pe["templates"]
    for k in ("k2", "k3"):
        print(f"templates {k}: card == CPU bit for bit, generate "
              f"{t[k]['generate_s']:.3f} s, k-means {t[k]['kmeans_s']:.3f} "
              f"s, {t[k]['valid_rows']} valid rows, "
              f"{len(t[k]['flips'])} assignment flips at ties")
    sil = t["silhouette"]
    print(f"silhouette: best k {sil['best_k']}, scores {sil['scores']} "
          f"(CPU {sil['cpu_scores']}), select {sil['select_s']:.3f} s, one "
          f"score {sil['one_score_s']:.4f} s")
    print(f"paper tables at REPRO_BENCH_FAST: {pe['tables_s']:.1f} s")
    print("name,us_per_call,derived")
    for name, us, derived in pe["rows"]:
        print(f"{name},{us:.1f},{derived}")
    for r in pe["tables"]["table1_compression"]:
        print(f"table I: {json.dumps(r)}")
    for r in pe["tables"]["table2_templates"]:
        print(f"table II: {json.dumps(r)}")
    print(f"fig 1: {json.dumps(pe['tables']['fig1_thresholds'])}")
    print(f"fig 6/7 accuracy: {pe['tables']['fig6_7_confusion']['accuracy']}")
    print(f"energy: {json.dumps(pe['tables']['energy_model'])}")
    tu = pe["tuning"]
    print(f"tuning winners: {json.dumps(tu['winners'])}")
    print(f"tuning device us (queued calls): {json.dumps(tu['device_us'])}")
    print(f"tuning device ms: {json.dumps(tu['device_ms'])}")
    print(f"empty cache designs: {json.dumps(tu['empty_cache'])}")
    q = pe["quickstart"]
    print(f"quickstart: softmax {q['softmax_accuracy']:.4f}, ACAM "
          f"{q['acam_accuracy']:.4f}, service {json.dumps(q['service'])}")


# ---------------------------------------------------------------------------
# 5. the control plane: manifests, reconfigure, snapshots, compaction, the
#    autopilot and the serving bench
# ---------------------------------------------------------------------------

CP_TENANTS = 8
CP_TAU = 8.0  # match counts; the similarity and device specs convert it
CP_SEEDS = tuple(500 + t for t in range(CP_TENANTS))
# query noise around the prototypes: at N 784 it puts about a fifth of the
# margins under 8 counts, so the cascade escalates some requests
CP_NOISE = 6.0
# the similarity steps' tau in counts (tau / N in Eq. 11 units): the median
# of their served margins, so about half escalate
CP_SIM_TAU = 0.35


def cp_manifest(tenants=range(CP_TENANTS)):
    """The phase's tenants as one manifest: seeded synthetic banks at the
    paper's width, k 1 and 2 alternating (k_max 2), 10 classes each."""
    from repro_torch.fleet import FleetManifest, TenantSpec

    return FleetManifest(tenants=tuple(
        TenantSpec(f"t{t}", seed=CP_SEEDS[t], num_classes=10, k=1 + t % 2)
        for t in tenants))


def cp_requests(n: int, seed: int, tenants=range(CP_TENANTS)):
    """``n`` requests over ``tenants``, round robin, from each tenant's
    prototypes (`sample_tenant_queries`)."""
    from repro_torch.serve import acam_service as svc_lib

    tenants = list(tenants)
    protos = {t: svc_lib.make_synthetic_tenant(
        CP_SEEDS[t], num_classes=10, k=1 + t % 2, num_features=N)[2]
        for t in tenants}
    out = []
    for i in range(n):
        t = tenants[i % len(tenants)]
        f, _ = svc_lib.sample_tenant_queries(seed + i, protos[t], 1,
                                             noise=CP_NOISE)
        out.append(svc_lib.ClassifyRequest(f"t{t}", f[0]))
    return out


def answers(responses) -> list:
    return [(r.tenant_id, r.pred, r.margin, r.escalated, r.energy_j,
             r.error) for r in responses]


def control_plane(device, out_dir: Path) -> tuple[dict, dict]:
    """The single-card control plane at the paper's width (N 784, 8 tenants
    x 10 classes in the 128-class bank, k_max 2, 64 slots):

    1. `apply_manifest` against imperative registration: the same registry
       state and answers;
    2. `reconfigure` through slots 64 -> 32 -> 64, mega -> compose, feature
       count -> similarity (compose, then mega; with its own tau), the
       kernel -> the device backend at sigma 0, and a tau change: the
       drained requests answered as a fresh build of the OLD spec answers
       them, the next ones as a fresh build of the new spec; B3, B4 and
       B6 launched (the similarity tick runs B6 under either fusion: its
       margins face serves "compose" in both packages, so B5, the predict
       classify, is not on this path);
    3. a blocking and an async snapshot, the service dropped, restored:
       answers bit-identical to a twin never killed;
    4. the card's snapshot restored on the CPU: the same feature-count
       answers;
    5. half the tenants evicted, then `compact`: every `bank_of` and every
       answer unchanged;
    6. the `Autopilot` over a saturating trace widens the slots (its shard
       escalation blocked on one card) and hands back its drained
       responses, every request answered once;
    7. `serving_bench` at smoke size into ``out_dir``;
    8. training as a function of its seed (`training_repeatability`).

    Returns (the driven paths, the phase's measurements)."""
    import torch

    from repro_torch.benchmarks import serving_bench
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.core.acam import ACAMConfig
    from repro_torch.fleet import Autopilot, PolicySpec, view_of
    from repro_torch.fleet.manifest import materialize
    from repro_torch.match import EngineConfig
    from repro_torch.serve.control import HybridService
    from repro_torch.serve.spec import (CascadeSpec, RegistrySpec,
                                        SchedulerSpec, ServiceSpec)

    report, out = {}, {}
    base = ServiceSpec(
        registry=RegistrySpec(num_features=N, k_max=2, initial_classes=128),
        engine=EngineConfig(backend="kernel", margin=True),
        scheduler=SchedulerSpec(slots=64),
        cascade=CascadeSpec(tau=CP_TAU, tau_units="count"))
    manifest = cp_manifest()

    def fresh(spec, on=device):
        svc = HybridService.from_spec(spec, device=on)
        svc.apply_manifest(manifest)
        return svc

    # -- 1. manifest against imperative registration ------------------------
    svc = HybridService.from_spec(base, device=device)
    rep = svc.apply_manifest(manifest)
    check(len(rep.added) == CP_TENANTS and len(svc.registry) == CP_TENANTS,
          f"apply_manifest added {rep.added}")
    imperative = HybridService.from_spec(base, device=device)
    for t in manifest.tenants:
        bank, head = materialize(t, N)
        imperative.register_tenant(t.tenant_id, bank, head=head)
    (a_arrays, a_meta), (b_arrays, b_meta) = (
        svc.registry.snapshot_state(), imperative.registry.snapshot_state())
    check(a_meta == b_meta and all(np.array_equal(a_arrays[k], b_arrays[k])
                                   for k in a_arrays),
          "apply_manifest and imperative registration differ in state")
    probe = cp_requests(128, 7)
    check(answers(svc.serve(probe)) == answers(imperative.serve(probe)),
          "apply_manifest and imperative registration answer differently")
    noop = svc.apply_manifest(manifest)
    check(noop.empty, "re-applying the manifest in force changed tenants")
    out["apply_manifest_ms"] = rep.duration_s * 1e3
    out["apply_manifest_noop_ms"] = noop.duration_s * 1e3

    # -- 2. reconfigure transitions ----------------------------------------
    sim = base.engine._replace(method="similarity")
    sim_cascade = base.cascade._replace(tau=CP_SIM_TAU)
    steps = [
        ("slots 64 -> 32", base._replace(scheduler=SchedulerSpec(slots=32))),
        ("slots 32 -> 64", base),
        ("mega -> compose", base._replace(engine=base.engine._replace(
            serve_fusion="compose"))),
        ("feature count -> similarity (compose)", base._replace(
            engine=sim._replace(serve_fusion="compose"),
            cascade=sim_cascade)),
        ("compose -> mega (similarity)", base._replace(
            engine=sim, cascade=sim_cascade)),
        ("kernel -> device backend, sigma 0", base._replace(
            engine=base.engine._replace(
                backend="device", device=ACAMConfig(sigma_program=0.0)))),
    ]
    steps.append(("tau 8 -> 16 counts", steps[-1][1]._replace(
        cascade=base.cascade._replace(tau=2 * CP_TAU))))

    def transitions():
        rows, old = [], svc.spec
        for i, (name, spec) in enumerate(steps):
            pending = cp_requests(96, 1000 + 100 * i)
            for r in pending:
                svc.submit(r)
            report_ = svc.reconfigure(spec)
            after = svc.serve(cp_requests(128, 5000 + 100 * i))
            rows.append(dict(name=name, old=old, spec=spec, pending=pending,
                             report=report_, after=after))
            old = spec
        return rows

    rows, counts, wall = drive(
        "control_plane_reconfigure", transitions,
        ["acam_match_serve", "acam_match_classify_margins",
         "acam_similarity_serve"])
    downtime = {}
    escalation = {}
    for i, row in enumerate(rows):
        check(len(row["report"].drained) == len(row["pending"]),
              f"{row['name']}: {len(row['report'].drained)} drained of "
              f"{len(row['pending'])}")
        check(answers(row["report"].drained) ==
              answers(fresh(row["old"]).serve(row["pending"])),
              f"{row['name']}: drained requests not answered under the old "
              "spec")
        check(answers(row["after"]) == answers(fresh(row["spec"]).serve(
            cp_requests(128, 5000 + 100 * i))),
              f"{row['name']}: answers differ from a fresh build of the new "
              "spec")
        downtime[row["name"]] = row["report"].downtime_s * 1e3
        escalation[row["name"]] = float(np.mean([r.escalated
                                                 for r in row["after"]]))
    check(escalation["tau 8 -> 16 counts"] >
          escalation["kernel -> device backend, sigma 0"],
          f"raising tau did not raise the escalation rate: {escalation}")
    check(svc.reconfigure(svc.spec).actions == (),
          "a no-op reconfigure acted")
    out["reconfigure_downtime_ms"] = downtime
    out["reconfigure_escalation_rate"] = escalation
    report["control_plane_reconfigure"] = dict(launches=counts, wall_s=wall)

    # -- 3. snapshot (blocking, async), kill, restore -----------------------
    ckpt_dir = out_dir / "control_plane_ckpt"
    ckpt = Checkpointer(ckpt_dir)
    killed, twin = fresh(base), fresh(base)
    warm = cp_requests(256, 11)
    check(answers(killed.serve(warm)) == answers(twin.serve(warm)),
          "two fresh builds answer differently")
    t0 = time.perf_counter()
    step0 = killed.snapshot(ckpt)
    blocking_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    step1 = killed.snapshot(ckpt, blocking=False)
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    ckpt.wait()
    async_ms = (time.perf_counter() - t0) * 1e3
    check((step0, step1) == (0, 1) and ckpt.latest_step() == 1,
          f"snapshot steps {step0}, {step1}, latest {ckpt.latest_step()}")
    del killed

    def restored():
        svc_, rep_ = HybridService.restore(Checkpointer(ckpt_dir),
                                           device=device)
        return svc_, rep_, svc_.serve(probe)

    (back, restore_rep, got), counts, wall = drive(
        "control_plane_restore", restored, ["acam_match_serve"])
    want = twin.serve(probe)
    check([a[1:] for a in answers(got)] == [a[1:] for a in answers(want)],
          "the restored service answers differently from the twin never "
          "killed")
    check(back.registry.capacity_classes == twin.registry.capacity_classes
          and len(back.registry) == CP_TENANTS,
          "restore: registry shape or tenants differ")
    report["control_plane_restore"] = dict(launches=counts, wall_s=wall)
    out["snapshot"] = dict(blocking_ms=blocking_ms,
                           async_enqueue_ms=enqueue_ms,
                           async_durable_ms=async_ms,
                           recovery_ms=restore_rep.restore_s * 1e3,
                           tenants=restore_rep.tenants,
                           bytes=sum(f.stat().st_size
                                     for f in ckpt_dir.rglob("*.npy")))

    # -- 4. the card's snapshot on the CPU ---------------------------------
    on_cpu, _ = HybridService.restore(Checkpointer(ckpt_dir), device="cpu")
    cpu_got = on_cpu.serve(probe)
    card_got = back.serve(probe)
    check([a[1:] for a in answers(cpu_got)] ==
          [a[1:] for a in answers(card_got)],
          "the card's snapshot restored on the CPU answers differently")

    # -- 5. evict half, compact --------------------------------------------
    keep = [t for t in range(CP_TENANTS) if t % 2]
    for t in range(CP_TENANTS):
        if t not in keep:
            back.evict_tenant(f"t{t}")
    kept_probe = cp_requests(128, 13, keep)
    before = answers(back.serve(kept_probe))
    banks = {t: back.registry.bank_of(f"t{t}") for t in keep}
    cap = back.registry.capacity_classes
    t0 = time.perf_counter()
    freed = back.compact_registry()
    compact_ms = (time.perf_counter() - t0) * 1e3
    check(freed > 0 and back.registry.capacity_classes == cap - freed,
          f"compact freed {freed} rows of {cap}")
    for t, bank in banks.items():
        again = back.registry.bank_of(f"t{t}")
        check(all(np.array_equal(getattr(bank, f), getattr(again, f))
                  for f in bank._fields), f"compact changed t{t}'s bank")
    after = answers(back.serve(kept_probe))
    check([a[1:] for a in after] == [a[1:] for a in before],
          "compact changed the answers")
    out["compact"] = dict(ms=compact_ms, freed_rows=freed,
                          capacity_before=cap,
                          capacity_after=back.registry.capacity_classes)

    # -- 6. the autopilot widens the slots ----------------------------------
    pilot_svc = fresh(base._replace(scheduler=SchedulerSpec(slots=32)))
    pilot = Autopilot(pilot_svc, policy=PolicySpec(interval=2, hysteresis=2,
                                                   cooldown=64))
    view = view_of(pilot_svc)
    stream = cp_requests(1024, 17)
    responses, drained, i = [], 0, 0
    t0 = time.perf_counter()
    while i < len(stream) or pilot_svc.scheduler.qsize:
        for r in stream[i:i + 4 * pilot_svc.scheduler.slots]:
            pilot_svc.submit(r)
        i += 4 * pilot_svc.scheduler.slots
        responses.extend(pilot_svc.step())
        pilot.observe_tick()
        got = pilot.take_drained()
        drained += len(got)
        responses.extend(got)
    torch.cuda.synchronize()
    pilot_s = time.perf_counter() - t0
    acts = [a["action"] for a in pilot.actions]
    check("widen_slots" in acts and "escalate_shards" not in acts
          and pilot_svc.spec.scheduler.slots > 32,
          f"autopilot actions {pilot.actions}")
    check(max(view.shard_rows_used) / view.rows_per_shard >= 0.75,
          "the autopilot's bank was not full enough to propose a shard "
          "escalation")
    check(drained > 0, "the widening drained no requests")
    check(sorted(r.request_id for r in responses) ==
          list(range(1, len(stream) + 1)),
          "autopilot: not every request answered exactly once")
    out["autopilot"] = dict(actions=pilot.actions, drained=drained,
                            slots=pilot_svc.spec.scheduler.slots,
                            wall_s=pilot_s,
                            metrics=pilot_svc.metrics())

    # -- 7. the serving bench at smoke size ---------------------------------
    t0 = time.perf_counter()
    bench_rows = serving_bench.run(
        device=device, out=str(out_dir / "BENCH_torch_serving.json"),
        smoke=True)
    bench_s = time.perf_counter() - t0
    for r in bench_rows:
        e = r["entry"]
        check(all(np.isfinite(v) for v in e.values()
                  if isinstance(v, float)) and e["requests_per_s"] > 0,
              f"serving bench row {r['name']}: {e}")
    out["serving_bench"] = dict(wall_s=bench_s,
                                rows=[r["entry"] for r in bench_rows],
                                names=[r["name"] for r in bench_rows])

    # -- 8. training as a function of its seed ------------------------------
    t0 = time.perf_counter()
    out["training_repeatability"] = training_repeatability(device)
    out["training_repeatability"]["wall_s"] = time.perf_counter() - t0
    return report, out


def print_control_plane(cp: dict, card: str) -> None:
    print(f"control plane ({card}): apply_manifest "
          f"{cp['apply_manifest_ms']:.3f} ms (no-op "
          f"{cp['apply_manifest_noop_ms']:.3f} ms)")
    for name, ms in cp["reconfigure_downtime_ms"].items():
        print(f"reconfigure {name}: downtime {ms:.3f} ms, escalation "
              f"{cp['reconfigure_escalation_rate'][name]:.4f}")
    snap = cp["snapshot"]
    print(f"snapshot ({snap['bytes']} bytes of leaves): blocking "
          f"{snap['blocking_ms']:.3f} ms, async {snap['async_enqueue_ms']:.3f}"
          f" ms to enqueue / {snap['async_durable_ms']:.3f} ms to durable; "
          f"restore (recovery_ms) {snap['recovery_ms']:.3f} ms, "
          f"{snap['tenants']} tenants")
    c = cp["compact"]
    print(f"compact: {c['ms']:.3f} ms, {c['capacity_before']} -> "
          f"{c['capacity_after']} class rows")
    ap = cp["autopilot"]
    print(f"autopilot: {[(a['tick'], a['action']) for a in ap['actions']]}, "
          f"slots -> {ap['slots']}, {ap['drained']} drained, "
          f"{ap['wall_s']:.3f} s")
    for name, e in zip(cp["serving_bench"]["names"],
                       cp["serving_bench"]["rows"]):
        print(f"serving bench {name} ({card}): {json.dumps(e)}")
    tr = cp["training_repeatability"]
    for mode in ("without", "with"):
        r = tr[mode]
        print(f"training {mode} the deterministic mode: teacher first "
              f"divergence {r['teacher_divergence']}, student "
              f"{r['student_divergence']}; 22 student steps: device "
              f"{r['student_device_ms']} ms, wall {r['student_wall_ms']} ms")


def main(argv: list[str]) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--report", type=Path, default=None,
                        help="also write every measurement as JSON here")
    report_path = parser.parse_args(argv).report
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs one",
              file=sys.stderr)
        return 2
    for source in (MATCH_SRC, SIM_SRC, KD_SRC, FA_SRC):
        if not (ROOT / source).is_file():
            print(f"chip_smoke: {source} not found beside this script",
                  file=sys.stderr)
            return 2
    sys.path.insert(0, str(ROOT / "src"))
    scratch = tempfile.TemporaryDirectory()
    # an empty tuning cache: every launch takes its default design
    os.environ["REPRO_TORCH_TUNING_CACHE"] = str(Path(scratch.name)
                                                 / "empty.json")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    device = torch.device("cuda", 0)

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build(list(SOURCES))
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s")
    for name, log in logs.items():
        print(f"nvcc {name}:\n{log.strip()}")

    kernels = kernel_phase(device)
    kernels.update(similarity_phase(device))
    kernels.update(kd_phase(device))
    kernels.update(fa_phase(device))
    report = paths(device)
    check(report["predict"]["features"] == N, "paper width: 784 features")
    trained, training, student = training_paths(device)
    report.update(trained)
    report.update(attention_path(device))
    report["device_physics"] = device_physics(device)
    out_dir = (report_path.parent / "paper_eval" if report_path
               else Path(scratch.name) / "paper_eval")
    t0 = time.perf_counter()
    evaluated, paper = paper_eval(device, student, out_dir)
    paper["wall_s"] = time.perf_counter() - t0
    report.update(evaluated)
    cp_dir = (report_path.parent / "control_plane" if report_path
              else Path(scratch.name) / "control_plane")
    cp_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    driven, control = control_plane(device, cp_dir)
    control["wall_s"] = time.perf_counter() - t0
    report.update(driven)
    launches = {}
    for path in report.values():
        for k, v in path["launches"].items():
            launches[k] = max(launches.get(k, 0), v)
    for name, r in report.items():
        print(f"{name}: wall {r['wall_s'] * 1e3:.3f} ms, launches "
              f"{r['launches']}")
        if "metrics" in r:
            print(f"{name}: tick {r['tick_ms']:.4f} ms, engine call "
                  f"{r['engine_call_ms']:.4f} ms")
            print(f"{name} metrics: {json.dumps(r['metrics'])}")
            if "energy" in r:
                print(f"{name} energy: {json.dumps(r['energy'])}")
    for name, k in kernels.items():
        print(f"{name} profile (per call): {json.dumps(k['profile'])}")
    for name, r in report.items():
        if "profile" in r:
            print(f"{name} profile: {json.dumps(r['profile'])}")
    for name in ("predict", "predict_similarity", "predict_trained"):
        print(f"{name} accuracy vs labels: "
              f"{report[name]['accuracy_vs_labels']}")
    for name, r in training.items():
        print(f"{name}: {r['steps']} steps in {r['wall_s']:.3f} s, losses "
              f"{r['losses'][0]:.4f} -> {r['losses'][-1]:.4f}")
    st = training["train_student"]
    print(f"train_student: sparsity {st['sparsity']} (target "
          f"{st['sparsity_target']}), test metrics "
          f"{json.dumps(st['metrics_test'])}")
    print(f"train step (batch 128, KD + QAT + masks): {st['step_ms']:.4f} ms "
          f"per call, profile {json.dumps(st['step_profile'])}")
    print("first-step gradients, card vs CPU on the card's branches, max "
          f"rel L2: {max(st['grad_rel_l2_card_vs_cpu'].values()):.3e} (TF32 "
          f"backward: {max(st['grad_rel_l2_tf32_vs_cpu'].values()):.3e}); "
          "each device on its own branches: "
          f"{max(st['grad_rel_l2_card_vs_cpu_own_branches'].values()):.3e} "
          f"with {st['branch_flips_card_vs_cpu']} branch flips")
    print(f"kd_loss bench 64x32000 (per call): "
          f"{json.dumps(kernels['kd_loss']['bench'])}")
    print(f"kd_loss vocab 8x152064 (per call): "
          f"{json.dumps(kernels['kd_loss']['vocab'])}")
    print(f"kd_loss split probes: {kernels['kd_loss']['split_probes']} cases "
          "within tolerance, two calls equal")
    print("acam_similarity big bank 64x2200x784 (per call): "
          f"{json.dumps(kernels['acam_similarity']['big_bank'])}")
    print("acam_similarity probes (bit-identical / real windows / "
          "misaligned / NaN): "
          f"{json.dumps(kernels['acam_similarity']['probes'])}")
    print("B5 / B6 NaN bank probes: "
          f"{kernels['acam_similarity_serve']['nan_probes']} cases equal "
          "(NaN in the same places)")
    print(f"flash_attention at {FA_MODEL_SHAPE} (per call): "
          f"{json.dumps(kernels['flash_attention']['model_shape'])}")
    for name in ("acam_match_classify_margins_chunked", *DESIGN_FACES):
        print(f"{name} tile probes: {kernels[name]['tile_probes']} cases "
              "bit-identical")
    print(f"acam_match_serve slot probes: "
          f"{kernels['acam_match_serve']['slot_probes']} cases bit-identical")
    for name in SIM_DESIGN_FACES:
        print(f"{name} tile probes: {kernels[name]['tile_probes']} cases "
              "bit-identical")
    print("acam_similarity_serve mixed and wildcard bank probes: "
          f"{kernels['acam_similarity_serve']['bank_probes']} cases "
          "bit-identical")
    for name in (*DESIGN_FACES, *SIM_DESIGN_FACES):
        print(f"{name} designs ({kernels[name]['design']} taken): "
              f"{json.dumps(kernels[name]['designs'])}")
    print("acam_match_classify designs by bank (K x C): "
          f"{json.dumps(kernels['acam_match_classify']['crossover'])}")
    print("acam_match_serve host us per step: "
          f"{json.dumps(kernels['acam_match_serve']['host_steps'])}")
    print("acam_similarity_serve big bank (per call): "
          f"{json.dumps(kernels['acam_similarity_serve']['big_bank'])}")
    for name in SIM_DESIGN_FACES:
        print(f"{name} on real windows (per call): "
              f"{json.dumps(kernels[name]['real_windows'])}")
    print("acam_similarity_serve big bank on real windows (per call): "
          + json.dumps(kernels["acam_similarity_serve"]["big_bank"]
                       ["real_windows"]))
    print(f"profile sessions retried: {json.dumps(PROFILE_RETRIES)}")
    print_device_physics(report["device_physics"], report["serve_mega"])
    print_paper_eval(paper)
    print_control_plane(control, smi)
    check(set(kernels) == set(KERNELS), "every ported kernel measured")

    line = {"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1],
         "launches": launches[name], "max_abs_err": k["max_abs_err"],
         "ms": k["ms"], "kernel_ms": k["ms"], "plain_ms": k["plain_ms"],
         "bound_ms": k["bound_ms"],
         "bound_by": k["bound_by"], "library_ms": k["library_ms"],
         "library_call": k["library_call"],
         "device_ms": k["profile"]["device_ms"],
         "library_device_ms": k.get("library_device_ms"),
         "host_us": k.get("host_us"),
         "library_host_us": k.get("library_host_us"), "shape": k["shape"]}
        for name, k in kernels.items()]}
    if report_path:
        report_path.parent.mkdir(parents=True, exist_ok=True)
        report_path.write_text(json.dumps(
            dict(card=smi, build_s=build_s, nvcc=logs,
                 kernels=line["kernels"], kernel_phases=kernels,
                 profile_retries=PROFILE_RETRIES,
                 paths=report, training=training, paper_eval=paper,
                 control_plane=control),
            indent=1, default=str))
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    scratch.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
