#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`).

    python3 chip_smoke.py [--report PATH]   # on a machine with a CUDA card

Builds the CUDA kernels from `src/repro_torch/csrc/` (all six sources,
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
              per 32 window cells. The student's fused epilogue
              (`student_epilogue.cu`, no `pallas_call` site: XLA fused
              these ops) against its plain version at the frames cell's
              batch 4,096 and at 1, 3 and 97, seeded weights with about
              half the BatchNorm scales negative: each of the four blocks
              `torch.equal` with the plain strides, the eval features
              equal to the plain chain's with four launches a call, a NaN
              pixel propagated; the four launches at 4,096 timed (CUDA
              events; device time traced) beside their bytes bound
              (`epi_bound`, 0.478 ms) and the plain tails on the same
              convolution outputs. The MLA prefill kernel
              (`mla_prefill.cu`, no `pallas_call` site: the JAX package's
              MLA path runs plain `chunked_attention`) against its plain
              version within 2^-6 (at unit scale, relative above it) in
              bf16 at S 1, 127, 128, 129, 300, 1,000 and 4,096 on views of
              q_b's and kv_b's outputs, and against `chunked_attention` on
              the concatenated q and k; one launch a layer in
              `lm.features` at DeepSeek-V3's head widths, none in
              `lm.forward` under grad, each layer's attention against
              `chunked_attention`'s; one layer of the LM cell
              (4, 4,096, 128 heads) timed in turns with SDPA, traced,
              beside its operations bound (`mla_bound`, 2.78 ms), the
              plain version and the replaced path.
 2. paths     each main path driven through the entry points a user calls,
              with the launch counts set to 0 just before and read just
              after: `HybridClassifier.predict` (B1, and the fused
              epilogue's four launches) at paper width (the
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
 6. lm       the LM decode path and the ACAM semantic cache (plain
              PyTorch: the JAX LM calls no Pallas kernel): tinyllama-1.1b
              (22 layers) and qwen3-1.7b (28 layers) at full width in bf16
              with seeded random weights drawn on the card, each through
              `launch.serve.run_lm` (`Engine.generate`: 8 requests, prompts
              of 4-31 tokens, max_new 16, batch 4, max_len 256,
              temperature 0), again warm, every logit finite, prefill +
              decode_step against forward within 2^-5 of the logits'
              scale; a 4 x 32 prefill and one decode step timed (call and
              device time, idle share, peak memory) against the step's
              bytes bound. The zoo's other families the same way, one
              at a time and each freed before the next, at full width
              with the depth cut (`LM_FAMILIES`): phi3.5-moe (8 of 32
              layers), deepseek-v3 (2 of 61: MLA, 256 sigmoid-routed
              experts), mamba2-2.7b (16 of 64) and hymba-1.5b (8 of 32),
              against forward within 2^-5 (phi3.5-moe) or the JAX
              package's 0.08 of the scale, the step's bound counting the
              experts it reads and the MLA / SSM caches. All six cut to 2
              layers in f32 (TF32 off; phi3.5-moe and deepseek-v3 to 1,
              deepseek-v3 with 16 experts: `cpu_cut`), weights drawn on
              the card and copied to the CPU: prefill, every cache field and 8
              teacher-forced greedy steps card against CPU within rtol /
              atol 1e-5, routing ids identical (smallest k / k+1 gap
              printed), tokens identical but at a near tie (printed).
              `launch.serve.main(["--workload", "lm-cached"])`, and with
              `--arch phi3.5-moe-42b-a6.6b`, on the card against the CPU
              (hits, served, matching calls, ticks, nJ/request equal; B3
              launched once a tick), the full-width tinyllama engine
              behind the same service (hit and miss latency), and
              `serving_bench.lm_cache_bench` at smoke size.
 7. lm_train the LM trainer: tinyllama-1.1b at full width (all 22
              layers, bf16, remat on, batch 8 x seq 64) through
              `launch.train.main` for 8 steps, every loss finite and the
              last below the first, peak memory, then one more step timed
              (call and device time, idle share, events) against its bound
              (`train_bound`: bytes against products). One config a family
              (`TRAIN_FAMILIES`: tinyllama-1.1b, qwen2-vl-72b,
              hubert-xlarge, phi3.5-moe, deepseek-v3 with 16 experts,
              mamba2-2.7b, hymba-1.5b) cut to 2 layers in f32 (1 for
              qwen2-vl-72b, phi3.5-moe and deepseek-v3: `cpu_cut`), TF32
              off, weights drawn on the card from a seed and copied to the
              CPU, card against CPU: the loss within 1e-5, every gradient
              within relative L2 1e-4 per JAX leaf, the MoE routing ids
              identical in the forward and the recompute, one AdamW step
              from the
              same gradients within 1e-5 of each tensor's scale, the int8
              compression of each JAX leaf (the layers' tensors stacked,
              as the trainer compresses) bit-identical (batch 8 x 64, or
              2 x 32 for
              qwen2-vl-72b, phi3.5-moe and deepseek-v3, printed). SMOKE
              tinyllama: two seeded runs with equal losses and
              checkpoints, and a run checkpointed every 3 steps and
              resumed from step 6 to 8 equal to the uninterrupted one, bit
              for bit; a run with ``--compress``, its first loss equal to
              the uncompressed run's and every loss finite. The HuBERT
              ACAM-head example (`examples.acam_head_for_hubert`) at its
              SMOKE size and on hubert-xlarge at full width (48 layers, d
              1280, vocab 504; 4 training steps): B1 launched once for the
              head's one call, its answers bit-identical to the plain
              reference engine's; dense and ACAM accuracy and nJ per frame
              printed.
 9. sharded  the bank-sharded ACAM service (after `control_plane`) on
              forced meshes of the one card (`forcemesh.install(shape,
              device="cuda:0")`: every mesh virtual, its shards launched in
              turn): `torch.argmax`'s NaN and tie order on the card; the
              engine's four entry points at B 256, C 512, K 2, N 784 under
              1x2, 1x4, 2x2 and 1x8 and both merges (all-gather, tree),
              bit-identical to the replicated call and to the CPU's
              sharded call, D*M B1 launches a call and two B3 on a 2x1
              serve tick; the 2,304-class K 2 bank at 1x2 (B2 a shard) and
              similarity at 1x4 (B5 a shard), against replicated and CPU;
              the serve call timed against the replicated one (call and
              device time, idle share) and its cross-shard merge alone;
              the control-plane service at 2 shards (1x2) and 4 (2x2)
              answering as the replicated service and the CPU, one engine
              call a tick; `reconfigure` 1 -> 2, `rolling_reshard` 2 -> 4
              against the drained path (flip against drained downtime),
              `handle_device_loss([3])` and `restore_devices`, a 2-shard
              snapshot restored at 4 on the card and the CPU, the autopilot
              escalating over the JAX autopilot bench's trace (every
              request answered once), the launcher with ``--bank-shards
              2`` under ``REPRO_FORCE_MESH=1x2`` against the CPU; the
              serving bench's bank-scaling, reshard and autopilot rows and
              the kernel bench's sharded rows (B 1, 256).
10. lm_mesh  the LM zoo on a mesh (after lm_train; plain PyTorch, no
              kernel of the port): forced meshes of the one card
              (virtual: the data coordinates run in turn). tinyllama-1.1b
              at full width (22 layers, bf16) through
              `launch.steps.build_train_step` (fsdp_tp) on 2x2 and on 1x1
              from one seed, 4 steps on one batch of 8 x 64: losses
              finite and falling, 2x2 within 2^-5 of 1x1; one more step
              timed (CUDA events; the 2x2 step profiled: device time, idle
              share, events), peak memory, each coordinate's resident
              bytes equal to what the specs give it; `build_prefill_step`
              (4 x 32, cache 64) and `build_decode_step` on 2x2 within
              2^-5 of the unsharded `prefill` / `decode_step`'s scale.
              tinyllama, phi3.5-moe with `moe_shardmap` (4 of its 16
              experts) and qwen2.5-14b padded to 16 heads a group, each
              at 2 layers in f32 (TF32 off): the 2x2 mesh step on the card
              against the unsharded step on the CPU (loss 1e-5, gradients
              rel L2 1e-4 a JAX leaf, the MoE routing ids identical), the
              card's mesh AdamW from the CPU's gradients within 1e-5 of
              the scale. qwen2.5-14b at 8 of 48 layers padded (48, 16)
              against unpadded within 2^-5; `ft.elastic.remesh_restore`
              of a SMOKE 2x2 checkpoint onto 1x2, bit for bit, and a step
              there.
11. dryrun   the dry run (after lm_mesh; plain PyTorch on the meta device,
              no kernel of the port). `launch.dryrun` on qwen3-1.7b
              train_4k on the two-pod mesh (512 meta coordinates),
              tinyllama-1.1b at its three applicable shapes (long_500k
              skipped with JAX's reason), mamba2-2.7b long_500k,
              phi3.5-moe train_4k (the meta MoE) and deepseek-v3
              decode_32k (MLA) on one pod: "all dry-run cells passed",
              each cell's trace seconds and the report's table (analysis,
              not measurements). The census against the card:
              tinyllama-1.1b's layer probe (train with grad, 1 x 4096;
              decode at decode_32k's coordinate shapes, 8 x 32768) and
              its embed-and-head probe (train with grad, 1 x 4096) on a
              1x1 mesh of the card under `FlopCounterMode` and on meta
              under the census: product FLOPs equal, the card's peak
              memory over the call within 10% or 64 MiB of the census's
              peak live bytes, each probe's time (CUDA events) against its
              roofline bound. The memory record against the card:
              tinyllama-1.1b train at 8 x 1024 on forced 1x1 and 2x2
              meshes, `argument_bytes` equal to each coordinate's resident
              blocks plus its batch rows, `temp_bytes` (times the data
              coordinates the one card runs) within 15% of the card's
              peak less its resident bytes over a step.
 8. report    the card's name and power limit, metrics and the energy
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
import io
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
sys.path.insert(0, str(ROOT / "src"))
try:  # the card's rates; alone in a directory, main() says what is missing
    from repro_torch.analysis.roofline import FLOPS_BY_DTYPE, HBM_BW
except ImportError:
    FLOPS_BY_DTYPE = HBM_BW = None
CSRC = "src/repro_torch/csrc"
MATCH_SRC = f"{CSRC}/acam_match.cu"
SIM_SRC = f"{CSRC}/acam_similarity.cu"
KD_SRC = f"{CSRC}/kd_loss.cu"
FA_SRC = f"{CSRC}/flash_attention.cu"
EPI_SRC = f"{CSRC}/student_epilogue.cu"
MLA_SRC = f"{CSRC}/mla_prefill.cu"
SOURCES = ("acam_match", "acam_similarity", "kd_loss", "flash_attention",
           "student_epilogue", "mla_prefill")
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
HBM_BYTES_PER_S = HBM_BW  # H100 SXM (repro_torch.analysis.roofline)
INT8_OPS_PER_S = 1.979e15  # H100 SXM dense int8 tensor rate
# FP32 / int instructions per second outside the tensor cores: 132 SMs x
# 128 lanes x 1.98 GHz, the 67 TFLOP/s FP32 peak with an FMA counted once
INSTR_PER_S = 33.5e12
SIM_INSTR_PER_CELL = 10  # Eq. 9-11 per (query, template row, feature)
# popc per second: 132 SMs x 16 per clock x 1.98 GHz (B5 and B6 on binary
# windows count hits with two popc per 32 (query, row, feature) cells)
POPC_PER_S = 4.18e12
# dense tensor-core rates for 16-bit operands, and FP32 outside them
FLOPS_PER_S = FLOPS_BY_DTYPE
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


def profile(fn, reps: int = 1, retries: int = 2, cpu: bool = True) -> dict:
    """`torch.profiler` over ``reps`` calls of ``fn`` (after one warm-up),
    per call: wall time, summed device time of every kernel and copy, the
    number of those device events, the device's idle share of the wall
    time, and the device time per kernel name (top 8). Device times are None when the profiler recorded none.
    A session that recorded no device event at all while a kernel of the
    port launched (its wrapper's count rose) is taken again, up to
    ``retries`` times (two empty sessions in a row have happened on the
    card): each time the calling function and the kernels that launched
    go to `PROFILE_RETRIES` (the report lists them) and the result is
    marked ``retried``. ``cpu=False`` traces the device alone: every
    number above comes from device events, and a step of thousands of
    launches takes 7-30 s to analyse with its host events (phase 6's
    decode profiles took 66 s of its 173 s so)."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    before = launch_counts()
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu
                                            else [])
    with torch_profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    launched = sorted(k for k, v in launch_counts().items()
                      if v > before.get(k, 0))
    by_name, events = {}, 0
    for evt in prof.key_averages():
        dt = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
        if dt > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.key] = by_name.get(evt.key, 0.0) + dt / 1e3 / reps
            events += evt.count
    busy = sum(by_name.values())
    if not busy and retries and launched:
        caller = sys._getframe(1)
        while caller.f_code.co_name == "profile":
            caller = caller.f_back
        PROFILE_RETRIES.append(dict(caller=caller.f_code.co_name,
                                    launched=launched))
        return dict(profile(fn, reps, retries - 1, cpu), retried=True)
    return dict(wall_ms=wall_ms, device_ms=busy or None,
                device_events=events / reps,
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

# ---------------------------------------------------------------------------
# 1d. the student's fused epilogue (`student_epilogue.cu`; no pallas_call
#     site: the JAX package left these ops to XLA)
# ---------------------------------------------------------------------------

EPI_BATCH = 4096  # the frames cell's (`bench/workloads/fig5-hybrid.*`)


def epi_student(device):
    """The Fig. 5 student with small conv biases and BatchNorm statistics
    standing for a trained front end, about half its BatchNorm scales
    negative (BN does not commute with the pool), in eval mode."""
    import torch

    from repro_torch.models import cnn

    model = cnn.init_student(torch.Generator().manual_seed(40),
                             device="cpu")
    g = torch.Generator().manual_seed(41)
    with torch.no_grad():
        for conv in (model.conv1, model.conv2, model.conv3, model.conv4):
            conv.bias.copy_(0.05 * torch.randn(conv.bias.shape, generator=g))
        for bn in (model.bn1, model.bn2):
            c = bn.num_features
            bn.weight.copy_(0.8 * torch.randn(c, generator=g))
            bn.bias.copy_(0.1 * torch.randn(c, generator=g))
            bn.running_mean.copy_(0.1 * torch.randn(c, generator=g))
            bn.running_var.copy_(0.5 + 1.5 * torch.rand(c, generator=g))
    return model.to(device)


def epi_bound(b: int, filters=(32, 128, 256, 16)):
    """Least time on an H100 SXM of the four fused launches of a batch of
    ``b``: each conv output read once and each result written once (30x30
    -> 15x15, 15x15 -> 7x7, 7x7 -> 7x7 twice), float32, over 3.35 TB/s.
    Returns (ms, bytes): 1,601,175,552 B at 4,096."""
    f1, f2, f3, f4 = filters
    words = (30 * 30 * f1 + 15 * 15 * f1 + 15 * 15 * f2 + 7 * 7 * f2
             + 2 * 7 * 7 * f3 + 2 * 7 * 7 * f4)
    nbytes = 4 * b * words
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


def epi_same(name: str, got, want) -> None:
    import torch

    check(got.shape == want.shape and got.stride() == want.stride(),
          f"{name}: {tuple(got.shape)} {got.stride()} against the plain "
          f"{tuple(want.shape)} {want.stride()}")
    check(torch.equal(torch.isnan(got), torch.isnan(want))
          and torch.equal(torch.nan_to_num(got), torch.nan_to_num(want)),
          f"{name}: not bit-identical to the plain version")


def epilogue_phase(device) -> dict:
    """The fused epilogue against its plain version (each block and the
    eval features, bit for bit, four launches a features call) at the
    frames cell's batch and ragged ones; a NaN pixel; the four launches
    timed at 4,096 beside their bound and the plain tails."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.student_epilogue import student_epilogue as epi
    from repro_torch.models import cnn

    model = epi_student(device)
    convs = (model.conv1, model.conv2, model.conv3, model.conv4)
    bns = (model.bn1, model.bn2, None, None)
    g = torch.Generator(device=device).manual_seed(42)
    cases = 0
    with torch.no_grad(), cnn.fp32(device):
        for b in (1, 3, 97, EPI_BATCH):
            x = torch.randn((b, 32, 32, 1), generator=g, device=device)
            if b == 97:
                x[5, 11, 13, 0] = float("nan")
            h, raws = x.permute(0, 3, 1, 2), []
            for i, (conv, bn) in enumerate(zip(convs, bns)):
                args = (h, conv.weight, conv.bias, conv.padding, bn)
                got = epi.conv_epilogue(*args, flatten=i == 3)
                want = epi.conv_epilogue_plain(*args, flatten=i == 3)
                epi_same(f"student_epilogue block {i + 1} at B={b}", got,
                         want)
                raws.append(F.conv2d(h, conv.weight, None,
                                     padding=conv.padding))
                h, cases = want, cases + 1
            epi.reset_launches()
            feats = model.features(x)
            check(epi.LAUNCHES["student_epilogue"] == 4,
                  f"student_epilogue: {epi.LAUNCHES} launches for one "
                  "features call, expected 4")
            epi_same(f"student_epilogue features at B={b}", feats, h)
            if b == 97:
                check(bool(torch.isnan(feats[5]).any())
                      and not bool(torch.isnan(feats[4]).any()),
                      "student_epilogue: a NaN pixel must reach its "
                      "image's features alone")
        calls = [(raw, conv.bias, bn, i == 3)
                 for i, (raw, conv, bn) in enumerate(zip(raws, convs, bns))]

        def fused():
            for raw, bias, bn, flatten in calls:
                epi.epilogue(raw, bias, bn, flatten=flatten)

        def plain_tails():  # the passes the kernel replaces
            for raw, bias, bn, _ in calls:
                v = F.relu(raw + bias[:, None, None])
                if bn is not None:
                    F.max_pool2d(cnn.batchnorm(bn, v, train=False), 2)

        ms, nbytes = epi_bound(EPI_BATCH)
        row = dict(shape=dict(B=EPI_BATCH, filters=[32, 128, 256, 16]),
                   cases=cases, ms=time_ms(fused),
                   plain_ms=time_ms(plain_tails), bound_ms=ms,
                   bound_by="bytes", bound_bytes=nbytes,
                   host_us=host_us(fused), profile=profile(fused, reps=20))
    device_ms = row["profile"]["device_ms"]
    row["roofline"] = ms / device_ms if device_ms else None
    epi.reset_launches()
    return row


def print_epilogue(row: dict) -> None:
    print(f"student_epilogue (not a pallas_call site): {row['cases']} "
          f"blocks bit-identical; four launches at B={row['shape']['B']}: "
          f"{row['ms']:.4f} ms a call, device "
          f"{row['profile']['device_ms']} ms against the bytes bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_bytes']} B), plain tails "
          f"{row['plain_ms']:.4f} ms, host {row['host_us']:.1f} us; "
          f"profile {json.dumps(row['profile'])}")


# ---------------------------------------------------------------------------
# 1e. MLA prefill attention (`mla_prefill.cu`; no pallas_call site: the JAX
#     package's MLA path runs plain `chunked_attention`)
# ---------------------------------------------------------------------------

#: (B, S, H) of one layer's attention in the LM cell, at qk 128 + 64 and
#: v 128 (`bench/workloads/deepseek-v3-ep32.doc-chunks-b4x4096.json`)
MLA_SHAPE = (4, 4096, 128)
#: the kernel against its plain version in bf16: p is rounded to bf16 at
#: each tile's running max in one and at the row's in the other, and the
#: output is rounded to bf16: B9's tolerance
MLA_TOL = FA_TOL_BF16


def mla_scale() -> float:
    """DeepSeek-V3's softmax scale: 192 ** -0.5 times YaRN's mscale(40, 1)
    squared (`lm.ArchConfig.softmax_scale`)."""
    from repro_torch.models import layers as L

    return 192 ** -0.5 * L.yarn_mscale(40.0, 1.0) ** 2


def mla_case(seed: int, b: int, s: int, h: int, device) -> tuple:
    """The kernel's operands as the model hands them over: views of q_b's
    (B, S, H, 192) and kv_b's (B, S, H, 256) outputs, a contiguous rotated
    q_rope and k_rope as a (B, S, 1, 64) slice; bf16 standard normal."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)

    def draw(*shape):
        return torch.randn(shape, generator=g, device=device).to(
            torch.bfloat16)

    q, kv = draw(b, s, h, 192), draw(b, s, h, 256)
    return (q[..., :128], draw(b, s, h, 64), kv[..., :128],
            draw(b, s, 1, 64)[:, :, 0], kv[..., 128:])


def mla_bound(b: int, s: int, h: int):
    """Least time on an H100 SXM: 2 (192 + 128) flops per live (query,
    key) pair and head over the dense bf16 rate, against q, k and v read
    once and the output written once over 3.35 TB/s. Returns (ms,
    bound_by, flops, bytes)."""
    pairs = s * (s + 1) // 2
    flops = 2 * (192 + 128) * pairs * b * h
    nbytes = 2 * (b * s * h * (192 + 256 + 128) + b * s * 64)
    t_ops = flops / FLOPS_PER_S["torch.bfloat16"]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def mla_features_launches(device) -> dict:
    """`lm.features` on DeepSeek-V3's published-smoke config at the
    published head widths in bf16: one launch a layer, none in `lm.forward`
    under grad; each layer's attention on one input against the same call
    with the route closed (`chunked_attention`). The features are not
    compared: the router after the attention turns a rounding into another
    expert."""
    import dataclasses

    import torch

    from repro_torch.configs import deepseek_v3
    from repro_torch.kernels.mla_prefill import mla_prefill as mp
    from repro_torch.models import lm

    cfg = dataclasses.replace(deepseek_v3.PUBLISHED_SMOKE, qk_nope_dim=128,
                              qk_rope_dim=64, v_head_dim=128)
    params = lm.init_params(0, cfg, device=device)
    x = torch.as_tensor(np.random.RandomState(3).randint(
        0, cfg.vocab, (2, 300)), device=device)
    mp.reset_launches()
    check(bool(torch.isfinite(lm.features(params, cfg, x)).all()),
          "mla_prefill: non-finite features")
    launches = mp.LAUNCHES["mla_prefill"]
    check(launches == cfg.n_layers, f"mla_prefill: {launches} launches in "
          f"one features call of {cfg.n_layers} layers")
    with torch.enable_grad():
        lm.forward(params, cfg, x)
    check(mp.LAUNCHES["mla_prefill"] == launches,
          "mla_prefill: launched under grad")
    g = torch.Generator(device=device).manual_seed(5)
    h = torch.randn((2, 300, cfg.d_model), generator=g,
                    device=device).to(cfg.dtype)
    pos = lm._default_positions(cfg, 2, 300, device=device)
    route, gap = lm._mla_prefill_kernel, 0.0
    with torch.no_grad():
        for layer in params.layers:
            got = lm._mla_train_attention(layer.attn, cfg, h, pos)[0]
            lm._mla_prefill_kernel = lambda *args: False
            try:
                want = lm._mla_train_attention(layer.attn, cfg, h, pos)[0]
            finally:
                lm._mla_prefill_kernel = route
            gap = max(gap, float((got.float() - want.float()).norm()
                                 / want.float().norm()))
    check(gap <= MLA_TOL, f"mla_prefill: a layer's attention {gap} from "
          "the chunked_attention path's")
    return dict(layers=cfg.n_layers, launches=launches, attention_gap=gap)


def mla_phase(device) -> dict:
    """The MLA prefill kernel against its plain version in bf16 (`MLA_TOL`)
    at S of 1, one either side of a 128-row tile, ragged and 4,096, heads 1
    to 8, and at `MLA_SHAPE`, every output finite; against `chunked_attention` on the
    concatenated q and k; one launch a layer in `lm.features`; then one
    layer of the LM cell (`MLA_SHAPE`) timed in turns with SDPA on copies
    of q, k and v laid out for it, traced, the plain version and the
    replaced path (the concatenation and `chunked_attention`) timed beside
    its bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.mla_prefill import mla_prefill as mp
    from repro_torch.models.layers import chunked_attention

    scale = mla_scale()
    err, cases = 0.0, 0
    for seed, (b, s, h) in enumerate([(1, 1, 1), (1, 127, 2), (1, 128, 1),
                                      (1, 129, 2), (3, 300, 5), (1, 1000, 4),
                                      (2, 4096, 8)]):
        ops = mla_case(700 + seed, b, s, h, device)
        got = mp.mla_prefill(*ops, scale=scale)
        err = max(err, fa_compare(f"mla_prefill {(b, s, h)}", got,
                                  mp.mla_prefill_plain(*ops, scale=scale),
                                  MLA_TOL))
        cases += 1
    qn, qr, kn, kr, v = mla_case(720, 1, 1000, 4, device)
    q = torch.cat([qn, qr], dim=-1)
    k = torch.cat([kn, kr[:, :, None].expand(-1, -1, 4, -1)], dim=-1)
    fa_compare("mla_prefill vs chunked_attention (1, 1000, 4)",
               mp.mla_prefill(qn, qr, kn, kr, v, scale=scale),
               chunked_attention(q, k, v, causal=True, scale=scale), MLA_TOL)
    features = mla_features_launches(device)

    b, s, h = MLA_SHAPE
    ops = mla_case(730, b, s, h, device)
    qn, qr, kn, kr, v = ops

    def kernel():
        return mp.mla_prefill(*ops, scale=scale)

    def replaced():  # the path before the kernel
        q = torch.cat([qn, qr], dim=-1)
        k = torch.cat([kn, kr[:, :, None].expand(b, s, h, 64)], dim=-1)
        return chunked_attention(q, k, v, causal=True, scale=scale)

    out = kernel()
    check(bool(torch.isfinite(out).all()), "mla_prefill: non-finite output")
    err = max(err, fa_compare(f"mla_prefill {MLA_SHAPE}", out,
                              mp.mla_prefill_plain(*ops, scale=scale),
                              MLA_TOL))
    cases += 1
    qh = torch.cat([qn, qr], dim=-1).permute(0, 2, 1, 3).contiguous()
    kh = torch.cat([kn, kr[:, :, None].expand(b, s, h, 64)],
                   dim=-1).permute(0, 2, 1, 3).contiguous()
    vh = v.permute(0, 2, 1, 3).contiguous()

    def sdpa():
        return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                              scale=scale)

    lib_diff = fa_compare(f"SDPA yardstick at {MLA_SHAPE}",
                          sdpa().permute(0, 2, 1, 3), out, MLA_TOL)
    ms, by, flops, nbytes = mla_bound(b, s, h)
    row = dict(shape=dict(B=b, S=s, H=h, qk=192, v=128, causal=True,
                          dtype="bfloat16"),
               cases=cases, max_abs_err=err, features=features,
               **interleaved(kernel, sdpa, iters=20),
               library_call="torch.nn.functional.scaled_dot_product_attention"
                            " on (B, H, S, D) copies, k_rope expanded",
               library_max_abs_diff=lib_diff,
               plain_ms=time_ms(lambda: mp.mla_prefill_plain(
                   *ops, scale=scale), 3),
               replaced_ms=time_ms(replaced, 3),
               bound_ms=ms, bound_by=by, bound_flops=flops,
               bound_bytes=nbytes, profile=profile(kernel, reps=10))
    device_ms = row["profile"]["device_ms"]
    row["roofline"] = ms / device_ms if device_ms else None
    mp.reset_launches()
    return row


def print_mla(row: dict) -> None:
    print(f"mla_prefill (not a pallas_call site): {row['cases']} cases "
          f"within {MLA_TOL} (max |diff| {row['max_abs_err']:.3g}); "
          f"features {json.dumps(row['features'])}; at {MLA_SHAPE}: "
          f"{row['ms']:.4f} ms a call, device {row['profile']['device_ms']} "
          f"ms against the {row['bound_by']} bound {row['bound_ms']:.4f} ms "
          f"({row['roofline']}), SDPA {row['library_ms']:.4f} ms (device "
          f"{row['library_device_ms']}), plain {row['plain_ms']:.1f} ms, "
          f"the replaced path {row['replaced_ms']:.1f} ms, host "
          f"{row['host_us']:.1f} us; profile {json.dumps(row['profile'])}")


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
    from repro_torch.kernels.mla_prefill import mla_prefill as mp
    from repro_torch.kernels.student_epilogue import student_epilogue as epi

    return [am, asim, kd, fa, epi, mp]


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
                               ["acam_match_classify", "student_epilogue"])
    check(pred.shape == (256,) and pred.dtype == torch.int32,
          "predict: 256 int32 class ids")
    check(counts["student_epilogue"] == 4,
          "predict: four fused epilogue launches a call")
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
            times[mode].append(profile(lambda: student(zt), cpu=False))
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


# ---------------------------------------------------------------------------
# 9. the sharded super-bank (forced meshes on the one card)
# ---------------------------------------------------------------------------

SH_MESHES = ((1, 2), (1, 4), (2, 2), (1, 8))
SH_STRATEGIES = ("allgather", "tree")
SH_B, SH_C, SH_K = 256, 512, 2
SH_BIG_C = 2304  # K 2: 1,152 rows a shard at 1x2, past MAX_FUSED_ROWS
SH_ITERS = 20
#: the autopilot bench's trace (JAX `autopilot_bench`): 6 tenants x 64
#: classes at 16 slots, 160 requests
SH_PILOT = dict(tenants=6, classes=64, requests=160, burst=48, calm=8,
                phase_ticks=2, churn_every=3)


@contextlib.contextmanager
def forced(shape, device, strategy: str | None = None,
           env: str | None = None):
    """A forced (data, model) mesh of ``device`` repeated, installed for
    the block (``strategy``: `REPRO_REDUCE_STRATEGY`; ``env``: also
    `REPRO_FORCE_MESH`, for code that reads the request from there), then
    cleared."""
    from repro_torch.distributed import context, forcemesh

    saved = {k: os.environ.get(k) for k in ("REPRO_REDUCE_STRATEGY",
                                            "REPRO_FORCE_MESH")}
    if strategy:
        os.environ["REPRO_REDUCE_STRATEGY"] = strategy
    if env:
        os.environ["REPRO_FORCE_MESH"] = env
    try:
        yield forcemesh.install(shape, device=device) if shape else None
    finally:
        context.clear()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def sh_problem(device, c: int = SH_C, k: int = SH_K, b: int = SH_B,
               method: str = "feature_count"):
    """One engine call's operands on ``device``: a (C, K, 784) bank (binary
    templates; dyadic windows for the similarity method), features,
    windows edging and straddling the 1x2 / 1x4 / 1x8 shard edges and an
    empty one, tenant slots and thresholds, taus."""
    import torch

    from repro_torch.core.templates import TemplateBank

    rng = np.random.default_rng(c + b)
    tm = (rng.random((c, k, N)) > 0.5).astype(np.float32)
    lower = (rng.integers(-8, 1, (c, k, N)) / 4).astype(np.float32)
    upper = lower + (rng.integers(0, 9, (c, k, N)) / 4).astype(np.float32)
    valid = rng.random((c, k)) < 0.9
    feats = rng.standard_normal((b, N)).astype(np.float32)
    if method == "similarity":
        feats = (rng.integers(-8, 9, (b, N)) / 4).astype(np.float32)
    lo = rng.integers(0, c - 8, b)
    hi = np.minimum(lo + rng.integers(1, 96, b), c)
    lo[:6] = (c // 2 - 8, c // 2, c // 4 - 3, 0, c // 8 - 1, 7)
    hi[:6] = (c // 2, c // 2 + 40, 3 * c // 4 + 3, c, c // 8 + 1, 7)

    def t(x):
        return torch.as_tensor(x, device=device)

    return dict(bank=TemplateBank(t(tm), t(lower), t(upper), t(valid),
                                  torch.zeros(N, device=device)),
                feats=t(feats), queries=t((feats > 0).astype(np.float32)),
                lo=t(lo.astype(np.int32)), hi=t(hi.astype(np.int32)),
                thr=t((rng.standard_normal((8, N)) * 0.1).astype(
                    np.float32)),
                slot=t(rng.integers(0, 8, b).astype(np.int32)),
                tau=t(rng.uniform(0, 12, b).astype(np.float32)))


def sh_calls(eng, x) -> dict:
    """The engine's four entry points on one problem."""
    return {
        "classify": eng.classify(x["queries"], x["bank"]),
        "classify_features": eng.classify_features(x["feats"], x["bank"]),
        "classify_features_margin": eng.classify_features_margin(
            x["feats"], x["bank"], x["lo"], x["hi"]),
        "classify_serve": eng.classify_serve(
            x["feats"], x["thr"], x["slot"], x["bank"], x["lo"], x["hi"],
            x["tau"]),
    }


def sh_same(name: str, got: dict, want: dict) -> None:
    for call in want:
        compare(f"{name} {call}", [g.cpu() for g in got[call]],
                [w.cpu() for w in want[call]])


def sh_serve_timed(eng, x, shape, strategy) -> dict:
    """One sharded serve call against the replicated one on the card: call
    time (CUDA events), device time and idle share (profiler), and the
    cross-shard merge alone on this call's partials (its share of the
    call)."""
    from repro_torch.match import engine as eng_lib
    from repro_torch.match import plan as plan_lib

    def call():
        return eng.classify_serve(x["feats"], x["thr"], x["slot"],
                                  x["bank"], x["lo"], x["hi"], x["tau"])

    out = {}
    with forced(shape, x["feats"].device, strategy):
        out["ms"] = time_ms(call, SH_ITERS)
        out["profile"] = profile(call, reps=5)
        plan, _ = plan_lib.plan_for(batch=SH_B, num_classes=SH_C)
        be = eng.backend(x["feats"], x["bank"])
        rows = SH_B // plan.dp_devices
        parts = []
        for s in range(plan.bank_shards):
            sl = plan.class_slice(s)
            bank = x["bank"]._replace(templates=x["bank"].templates[sl],
                                      lower=x["bank"].lower[sl],
                                      upper=x["bank"].upper[sl],
                                      valid=x["bank"].valid[sl])
            _, t1, gi, t2 = be.classify_serve_shard(
                x["feats"][:rows], x["thr"], x["slot"][:rows], bank,
                x["lo"][:rows], x["hi"][:rows], s * plan.rows_per_shard)
            parts.append((t1, gi, t2))
        merge_ms = time_ms(lambda: eng_lib._reduce_margin(
            parts, float(N), plan.reduce), SH_ITERS)
    # one merge per dp slice in each call
    out["merge_ms"] = merge_ms * plan.dp_devices
    out["merge_share"] = out["merge_ms"] / out["ms"]
    out["reduce"] = plan.reduce
    return out


def sh_service_spec(shards: int, slots: int = 64):
    from repro_torch.match import EngineConfig
    from repro_torch.serve.spec import (CascadeSpec, MeshSpec, RegistrySpec,
                                        SchedulerSpec, ServiceSpec)

    return ServiceSpec(
        registry=RegistrySpec(num_features=N, k_max=2, initial_classes=128),
        engine=EngineConfig(backend="kernel", margin=True),
        mesh=MeshSpec(bank_shards=shards, install=True),
        scheduler=SchedulerSpec(slots=slots),
        cascade=CascadeSpec(tau=CP_TAU, tau_units="count"))


def sh_fresh(spec, device):
    from repro_torch.serve.control import HybridService

    svc = HybridService.from_spec(spec, device=device)
    svc.apply_manifest(cp_manifest())
    return svc


def sh_argmax_probe(device) -> None:
    """`torch.argmax` on the card as the merges assume and `jnp.argmax`
    does: the first NaN wins, ties go to the first index, all -inf -> 0
    (each row repeated 300 times: a reduction over several blocks)."""
    import torch

    nan, inf = float("nan"), float("inf")
    for row, want in (([1.0, nan, 3.0, nan], 1), ([2.0, 5.0, 5.0, 1.0], 1),
                      ([-inf] * 4, 0), ([nan] * 4, 0),
                      ([-inf, 0.0, 0.0, -inf], 1)):
        x = torch.tensor(row * 300, device=device)[None]
        got = int(torch.argmax(x, dim=-1)[0])
        on_cpu = int(torch.argmax(x.cpu(), dim=-1)[0])
        check(got == on_cpu == want,
              f"torch.argmax of {row}: {got} on the card, {on_cpu} on the "
              f"CPU, {want} expected")


def sharded_phase(device) -> tuple[dict, dict]:
    """The bank-sharded ACAM service on forced meshes of the one card
    (every mesh virtual: its shards run in turn on the card):

    1. `MatchEngine`'s four entry points at B 256, C 512, K 2, N 784 under
       1x2, 1x4, 2x2 and 1x8 and both merges, bit-identical to the
       replicated call on the card and to the CPU's sharded call; D*M B1
       launches a call, D B3 launches on a 2x1 serve tick; the 2,304-class
       bank at 1x2 (B2 a shard); similarity at 1x4 (B5 a shard); the
       serve call timed against the replicated one, and its merge alone;
    2. the control-plane service (8 tenants x 10 classes, 128-class bank,
       K 2, 64 slots) at 2 shards (1x2) and 4 (2x2), answering as the
       replicated service on the card and the CPU, one engine call a tick;
    3. `reconfigure` 1 -> 2 (drained), `rolling_reshard` 2 -> 4 against
       the drained path, `handle_device_loss([3])` on 1x4 and
       `restore_devices`, a 2-shard snapshot restored at 4 on the card and
       on the CPU, the autopilot escalating over the JAX autopilot bench's
       trace (every request answered once), `launch.serve.main(
       ["--workload", "acam", "--bank-shards", "2"])` under 1x2 against
       the CPU;
    4. the serving bench's sharded rows and the kernel bench's.

    Returns (the driven paths, the phase's measurements)."""
    import torch

    from repro_torch import match
    from repro_torch.benchmarks import kernel_bench, serving_bench, traces
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.fleet import Autopilot, PolicySpec
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serve.control import HybridService
    from repro_torch.serve.spec import MeshSpec

    report, out = {}, {"virtual_mesh": True}
    cpu = torch.device("cpu")
    sh_argmax_probe(device)

    # -- 1. the engine ------------------------------------------------------
    eng = match.engine_for(backend="kernel")
    x, xc = sh_problem(device), sh_problem(cpu)
    rep = sh_calls(eng, x)
    check(bool(rep["classify_serve"][3].any())
          and not bool(rep["classify_serve"][3].all()),
          "the sharded problem escalates all or nothing")
    rep_serve = time_ms(lambda: eng.classify_serve(
        x["feats"], x["thr"], x["slot"], x["bank"], x["lo"], x["hi"],
        x["tau"]), SH_ITERS)
    out["replicated_serve"] = dict(
        ms=rep_serve, profile=profile(lambda: eng.classify_serve(
            x["feats"], x["thr"], x["slot"], x["bank"], x["lo"], x["hi"],
            x["tau"]), reps=5))
    out["engine"] = {}
    for shape in SH_MESHES:
        d, m = shape
        for strategy in SH_STRATEGIES:
            name = f"{d}x{m}_{strategy}"
            with forced(shape, cpu, strategy):
                on_cpu = sh_calls(eng, xc)
            with forced(shape, device, strategy):
                got, counts, wall = drive(
                    f"sharded_engine_{name}", lambda: sh_calls(eng, x),
                    ["acam_match_classify"])
            sh_same(f"sharded {name} vs replicated", got, rep)
            sh_same(f"sharded {name} vs the CPU", got, on_cpu)
            check(counts["acam_match_classify"] == 4 * d * m,
                  f"sharded {name}: {counts['acam_match_classify']} B1 "
                  f"launches for 4 calls, expected {4 * d * m}")
            report[f"sharded_engine_{name}"] = dict(launches=counts,
                                                    wall_s=wall)
            out["engine"][name] = sh_serve_timed(eng, x, shape, strategy)
    with forced((2, 1), device):
        _, counts, wall = drive(
            "sharded_serve_2x1", lambda: eng.classify_serve(
                x["feats"], x["thr"], x["slot"], x["bank"], x["lo"],
                x["hi"], x["tau"]), ["acam_match_serve"])
    check(counts["acam_match_serve"] == 2,
          f"a 2x1 serve tick launched B3 {counts['acam_match_serve']} times")
    report["sharded_serve_2x1"] = dict(launches=counts, wall_s=wall)
    big, big_c = (sh_problem(device, c=SH_BIG_C, b=64),
                  sh_problem(cpu, c=SH_BIG_C, b=64))
    want = eng.classify_features(big["feats"], big["bank"])
    with forced((1, 2), cpu):
        on_cpu = eng.classify_features(big_c["feats"], big_c["bank"])
    with forced((1, 2), device):
        got, counts, wall = drive(
            "sharded_big_bank", lambda: eng.classify_features(
                big["feats"], big["bank"]),
            ["acam_match_classify_margins_chunked"])
    compare("sharded big bank vs replicated", got, want)
    compare("sharded big bank vs the CPU", [g.cpu() for g in got], on_cpu)
    check(counts["acam_match_classify_margins_chunked"] == 2,
          "the 2,304-class bank at 1x2: "
          f"{counts['acam_match_classify_margins_chunked']} B2 launches")
    report["sharded_big_bank"] = dict(launches=counts, wall_s=wall)
    sim = match.engine_for(method="similarity", alpha=0.37,
                           backend="kernel")
    sx, sxc = (sh_problem(device, b=64, method="similarity"),
               sh_problem(cpu, b=64, method="similarity"))
    want = sim.classify_features(sx["feats"], sx["bank"])
    with forced((1, 4), cpu):
        on_cpu = sim.classify_features(sxc["feats"], sxc["bank"])
    with forced((1, 4), device):
        got, counts, wall = drive(
            "sharded_similarity", lambda: sim.classify_features(
                sx["feats"], sx["bank"]), ["acam_similarity_classify"])
    compare("sharded similarity vs replicated", got, want)
    compare("sharded similarity vs the CPU", [g.cpu() for g in got], on_cpu)
    check(counts["acam_similarity_classify"] == 4,
          f"similarity at 1x4: {counts['acam_similarity_classify']} B5 "
          "launches")
    report["sharded_similarity"] = dict(launches=counts, wall_s=wall)

    # -- 2. the service at 2 and 4 shards -----------------------------------
    probe = cp_requests(256, 23)
    want = answers(sh_fresh(sh_service_spec(1)._replace(
        mesh=MeshSpec(install=False)), device).serve(probe))
    out["service"] = {}
    for shards, shape in ((2, (1, 2)), (4, (2, 2))):
        with forced(shape, cpu):
            on_cpu = answers(sh_fresh(sh_service_spec(shards), cpu).serve(
                probe))
        with forced(shape, device):
            svc = sh_fresh(sh_service_spec(shards), device)
            check(match.bank_shards_in_mesh() == shards,
                  f"the {shards}-shard service installed no mesh")
            svc.serve(probe[:64])  # warm-up
            svc.reset_metrics()
            got, counts, wall = drive(
                f"sharded_service_{shards}",
                lambda: answers(svc.serve(probe)), ["acam_match_classify"])
            m = svc.metrics()
        check(got == want, f"the {shards}-shard service answers differently "
              "from the replicated one")
        check(got == on_cpu, f"the {shards}-shard service on the card and "
              "the CPU differ")
        check(m["classify_dispatches"] == m["ticks"]
              and counts["acam_match_classify"] == shards * m["ticks"],
              f"{shards} shards: {m['ticks']} ticks, "
              f"{m['classify_dispatches']} engine calls, "
              f"{counts['acam_match_classify']} B1 launches")
        report[f"sharded_service_{shards}"] = dict(launches=counts,
                                                   wall_s=wall)
        out["service"][shards] = dict(metrics=m, ticks=m["ticks"],
                                      b1_launches=counts[
                                          "acam_match_classify"])

    # -- 3. transitions -------------------------------------------------------
    pending, after = cp_requests(64, 31), cp_requests(128, 37)
    fresh_answers = {}
    for shards in (1, 2, 3, 4):
        with forced((1, 4) if shards != 3 else (1, 3), device):
            spec = sh_service_spec(shards)
            if shards == 3:  # the loss target's capacity: 48-row multiples
                spec = spec._replace(registry=spec.registry._replace(
                    initial_classes=144))
            fresh_answers[shards] = answers(sh_fresh(spec, device).serve(
                after))
    check(len({tuple(v) for v in fresh_answers.values()}) == 1,
          "fresh builds at 1-4 shards answer differently")
    trans = {}
    with forced((1, 2), device):
        svc = sh_fresh(sh_service_spec(1), device)
        for r in pending:
            svc.submit(r)
        rep1 = svc.reconfigure(sh_service_spec(2))
        check(svc.registry.bank_shards == match.bank_shards_in_mesh() == 2,
              "reconfigure 1 -> 2 left the bank unsharded")
        check(len(rep1.drained) == len(pending)
              and answers(svc.serve(after)) == fresh_answers[2],
              "reconfigure 1 -> 2 answers differ from a fresh build")
        trans["reconfigure 1 -> 2"] = rep1.downtime_s * 1e3
    with forced((1, 4), device):
        rolling, drained = (sh_fresh(sh_service_spec(2), device),
                            sh_fresh(sh_service_spec(2), device))
        for r in pending:
            rolling.submit(r)
            drained.submit(r)
        rep_r = rolling.rolling_reshard(sh_service_spec(4))
        flipped = rolling.drain()
        rep_d = drained.reconfigure(sh_service_spec(4))
        check(rep_r.drained == [] and answers(flipped) ==
              answers(rep_d.drained), "the rolling reshard's queued "
              "answers differ from the drained path's")
        check(answers(rolling.serve(after)) == answers(drained.serve(after))
              == fresh_answers[4], "after the flip: answers differ")
        trans["rolling_reshard 2 -> 4 (flip)"] = rep_r.downtime_s * 1e3
        trans["reconfigure 2 -> 4 (drained)"] = rep_d.downtime_s * 1e3
        rep_l = rolling.handle_device_loss([3])
        check(rolling.registry.bank_shards == 3
              and answers(rolling.serve(after)) == fresh_answers[3],
              "after the loss of device 3: answers differ")
        rep_h = rolling.restore_devices()
        check(rolling.registry.bank_shards == 4
              and answers(rolling.serve(after)) == fresh_answers[4],
              "after the heal: answers differ")
        trans["handle_device_loss [3] (4 -> 3)"] = rep_l.downtime_s * 1e3
        trans["restore_devices (3 -> 4)"] = rep_h.downtime_s * 1e3
    ckpt_dir = Path(tempfile.mkdtemp())
    with forced((1, 4), device):
        snap = sh_fresh(sh_service_spec(2), device)
        snap.serve(pending)
        snap.snapshot(Checkpointer(ckpt_dir))
        back, rep_s = HybridService.restore(Checkpointer(ckpt_dir),
                                            mesh=MeshSpec(bank_shards=4),
                                            device=device)
        card = answers(back.serve(after))
    with forced((1, 4), cpu):
        on_cpu, _ = HybridService.restore(Checkpointer(ckpt_dir),
                                          mesh=MeshSpec(bank_shards=4),
                                          device=cpu)
        cpu_answers = answers(on_cpu.serve(after))
    check(rep_s.resharded and back.registry.bank_shards == 4
          and card == fresh_answers[4]
          and [a[1:] for a in card] == [a[1:] for a in cpu_answers],
          "the 2-shard snapshot restored at 4 answers differently")
    trans["restore 2 -> 4 (recovery)"] = rep_s.restore_s * 1e3
    out["transitions_ms"] = trans

    cfg = traces.TraceConfig(seed=0, num_features=serving_bench.NUM_FEATURES,
                             **SH_PILOT)
    pool = traces.TenantPool(cfg)
    with forced((1, 2), device):
        svc = HybridService.from_spec(serving_bench.make_spec(
            16, requests=cfg.requests, install_mesh=True), device=device)
        pool.register_all(svc)
        pilot = Autopilot(svc, policy=PolicySpec(interval=4, hysteresis=2,
                                                 cooldown=8))
        responses, submitted = [], 0
        for op in traces.make_trace(cfg):
            if op[0] == "submit":
                svc.submit(pool.request(op[1], op[2]))
                submitted += 1
            elif op[0] == "evict":
                if pool.tenant_id(op[1]) in svc.registry:
                    svc.evict_tenant(pool.tenant_id(op[1]))
            elif op[0] == "register":
                if pool.tenant_id(op[1]) not in svc.registry:
                    pool.register(svc, op[1])
            elif op[0] == "tick":
                responses.extend(svc.step())
                pilot.observe_tick()
                responses.extend(pilot.take_drained())
        responses.extend(svc.drain())
    acts = [a["action"] for a in pilot.actions]
    check("escalate_shards" in acts and svc.registry.bank_shards == 2,
          f"the autopilot did not escalate the shards: {pilot.actions}")
    check(sorted(r.request_id for r in responses) ==
          list(range(1, submitted + 1)),
          "autopilot: not every request answered exactly once")
    out["autopilot"] = dict(actions=pilot.actions, answered=len(responses))

    argv = ["--workload", "acam", "--bank-shards", "2"]
    with forced(None, device, env="1x2"):
        got, counts, wall = drive("sharded_launcher",
                                  lambda: launch_serve.main(argv,
                                                            device=device),
                                  ["acam_match_classify"])
    with forced(None, cpu, env="1x2"):
        on_cpu = launch_serve.main(argv, device="cpu")
    for key in ("accuracy", "completed", "escalated", "classify_dispatches",
                "escalation_rate", "nj_per_request"):
        check(got[key] == on_cpu[key],
              f"--bank-shards 2: {key} {got[key]} on the card, "
              f"{on_cpu[key]} on the CPU")
    report["sharded_launcher"] = dict(launches=counts, wall_s=wall)

    # -- 4. the bench rows ----------------------------------------------------
    t0 = time.perf_counter()
    with forced(None, device, env="1x2"):
        rows = serving_bench.bank_scaling_sweep(smoke=True, device=device)
        rows.append(serving_bench.reshard_bench(device=device))
        rows.append(serving_bench.autopilot_bench(smoke=True, device=device))
        kernel_rows = kernel_bench.sharded_classify_entries(
            (1, SH_B), device=device)
    check(all(r is not None for r in rows) and len(kernel_rows) == 2,
          "a sharded bench row was skipped")
    check(rows[-1]["flip_downtime_ms"] < rows[-1]["drained_downtime_ms"],
          "the autopilot's flip took longer than the drained reshard")
    out["bench"] = dict(serving=rows, kernel=kernel_rows,
                        wall_s=time.perf_counter() - t0)
    return report, out


def print_sharded(sh: dict, card: str) -> None:
    print(f"sharded ({card}; every mesh virtual: one card, its shards run "
          "in turn):")
    r = sh["replicated_serve"]
    print(f"  replicated serve B {SH_B} C {SH_C} K {SH_K} N {N}: "
          f"{r['ms']:.4f} ms a call, device {r['profile']['device_ms']} ms, "
          f"idle share {r['profile']['idle_share']}")
    for name, e in sh["engine"].items():
        print(f"  sharded serve {name}: {e['ms']:.4f} ms a call "
              f"(x{e['ms'] / r['ms']:.2f} the replicated), device "
              f"{e['profile']['device_ms']} ms, idle share "
              f"{e['profile']['idle_share']}, merge ({e['reduce']}) "
              f"{e['merge_ms']:.4f} ms = {e['merge_share']:.3f} of the call")
    for shards, e in sh["service"].items():
        m = e["metrics"]
        print(f"  service at {shards} shards: {e['ticks']} ticks, "
              f"{e['b1_launches']} B1 launches, {m['requests_per_s']:.1f} "
              f"req/s, p50 {m['latency_p50_ms']} / p99 "
              f"{m['latency_p99_ms']} ms")
    for name, ms in sh["transitions_ms"].items():
        print(f"  {name}: {ms:.3f} ms")
    acts = [(a["tick"], a["action"]) for a in sh["autopilot"]["actions"]]
    print(f"  autopilot: {acts}, {sh['autopilot']['answered']} requests "
          "answered once")
    for e in sh["bench"]["serving"]:
        print(f"  serving bench row ({card}): {json.dumps(e)}")
    for e in sh["bench"]["kernel"]:
        print(f"  kernel bench row ({card}): {json.dumps(e)}")


# ---------------------------------------------------------------------------
# 6. the LM decode path and the ACAM semantic cache
# ---------------------------------------------------------------------------

#: full width on the card: the launcher's default --arch, and qk-norm at
#: rope theta 1e6 with the 151,936-token vocabulary
LM_ARCHS = ("tinyllama-1.1b", "qwen3-1.7b")
#: card vs CPU in f32 (`cpu_cut`): the f32 tolerance of the CPU tests
#: (tests/test_torch_lm.py)
LM_RTOL = LM_ATOL = 1e-5
#: bf16: |diff| <= 2^-5 max|logits|, the CPU tests' bf16 tolerance
LM_BF16_REL = 2.0 ** -5
LM_GROUP, LM_PLEN = 4, 32  # one engine group: batch 4, prompts of 32
LM_STEPS = 8  # teacher-forced greedy steps, card against CPU
LM_CUT_LAYERS = 2  # the card-against-CPU configs: full width, 2 layers
#: the zoo's MoE, MLA, SSM and hybrid families at full width on the card,
#: their depth cut to fit one card in bf16 (phi3.5-moe, deepseek-v3) or
#: the script's time (mamba2-2.7b, hymba-1.5b: at all 64 and 32 layers
#: they took 35 and 42 s): arch -> (layers, the tolerance
#: of prefill + decode_step against forward relative to the logits' scale:
#: 2^-5 for phi3.5-moe, the JAX package's 0.08 where MLA decodes through
#: the absorbed weights or an SSM steps in f32, tests/test_models_zoo.py)
LM_FAMILIES = {"phi3.5-moe-42b-a6.6b": (8, LM_BF16_REL),
               "deepseek-v3-671b": (2, 0.08),
               "mamba2-2.7b": (16, 0.08),
               "hymba-1.5b": (8, 0.08)}
#: card against CPU in f32, cuts past `LM_CUT_LAYERS` for the CPU's time:
#: the three largest configs (2.9-3.7 G parameters at 2 layers, where the
#: CPU's side of phases 6 and 7 took 46-130 s each) at one layer (their
#: layers are alike, so one holds every op of the family); deepseek-v3's
#: 256 routed experts cut to 16 (with 256, f32 at 2 layers is about 100 GB
#: a device)
LM_CPU_CUTS = {"deepseek-v3-671b": dict(n_layers=1, n_experts=16),
               "phi3.5-moe-42b-a6.6b": dict(n_layers=1),
               "qwen2-vl-72b": dict(n_layers=1)}


def cpu_cut(arch: str):
    """``arch`` at full width in f32 for a card-against-CPU check:
    `LM_CUT_LAYERS` layers, then `LM_CPU_CUTS`."""
    import dataclasses

    import torch

    from repro_torch import configs

    return dataclasses.replace(configs.get(arch), **(
        dict(n_layers=LM_CUT_LAYERS, dtype=torch.float32)
        | LM_CPU_CUTS.get(arch, {})))


def card_and_cpu(cfg, device) -> tuple:
    """The seed-0 model drawn on ``device`` and a copy of it on the CPU:
    one set of weights on both (the CPU's generator draws about 8 ns a
    parameter, 25-28 s for each of the three largest cut configs)."""
    import copy

    import torch

    from repro_torch.models import lm

    card = lm.init_params(0, cfg, device=device)
    cpu = copy.deepcopy(card, {id(p): torch.nn.Parameter(
        p.detach().cpu(), requires_grad=p.requires_grad)
        for p in card.parameters()})
    return card, cpu


@contextlib.contextmanager
def routes_recorded():
    """Record every MoE routing (`layers.route`) run inside: a list of
    (expert ids, router scores), both on the CPU."""
    from repro_torch.models import layers as L

    orig, got = L.route, []

    def rec(p, xf, top_k, router_type, **group):
        out = orig(p, xf, top_k, router_type, **group)
        got.append((out[3].cpu(), out[1].detach().cpu()))
        return out

    L.route = rec
    try:
        yield got
    finally:
        L.route = orig


@contextlib.contextmanager
def routes_forced(calls):
    """Route every MoE call inside to the given experts (one (T, k) id
    tensor a call, in order), each token's weights renormalised from the
    call's own router scores at those experts: a replay of another path's
    routing decisions."""
    import torch

    from repro_torch.models import layers as L

    orig, pending = L.route, iter(calls)

    def forced(p, xf, top_k, router_type, **group):
        logits, scores, _, _ = orig(p, xf, top_k, router_type, **group)
        ids = next(pending).to(scores.device)
        w = scores.gather(1, ids)
        return logits, scores, w / torch.clamp_min(w.sum(-1, keepdim=True),
                                                   1e-9), ids

    L.route = forced
    try:
        yield
    finally:
        L.route = orig


def min_gap(scores, k: int) -> float:
    """The smallest gap between a row's k-th and (k+1)-th router score."""
    top = scores.sort(dim=-1, descending=True).values
    return float((top[:, k - 1] - top[:, k]).min())


def routing_flips(cfg, r_full, r_path, batch: int, plen: int) -> dict:
    """Where forward (``r_full``: one routing a layer over ``plen + 1``
    tokens) and prefill + decode_step (``r_path``: the prefill's layers,
    then the step's) route a token to other experts. -> {(row, position):
    the first differing decision's layer and token, and the smaller of
    the two paths' k / k+1 score gaps there}, for the positions the
    comparison reads (``plen - 1``: prefill, ``plen``: decode): a flip at
    or before a position in its row reaches that position's logits."""
    import torch

    if not r_full:
        return {}
    n, k = cfg.n_layers, cfg.top_k
    out = {}
    for layer in range(n):
        ids_f, sc_f = r_full[layer]
        ids_p = torch.cat([r_path[layer][0].reshape(batch, plen, k),
                           r_path[n + layer][0].reshape(batch, 1, k)], 1)
        sc_p = torch.cat([r_path[layer][1].reshape(batch, plen, -1),
                          r_path[n + layer][1].reshape(batch, 1, -1)], 1)
        ids_f = ids_f.reshape(batch, plen + 1, k)
        sc_f = sc_f.reshape(batch, plen + 1, -1)
        differ = (ids_f.sort(-1).values != ids_p.sort(-1).values).any(-1)
        for row, tok in differ.nonzero().tolist():
            gap = min(min_gap(sc_f[row, tok][None], k),
                      min_gap(sc_p[row, tok][None], k))
            for pos in (plen - 1, plen):
                if tok <= pos and (row, pos) not in out:
                    out[(row, pos)] = dict(layer=layer, token=tok, gap=gap)
    return out


def lm_bound(cfg, params, batch: int, cur_len: int,
             experts: list[int] | None = None) -> dict:
    """The least time one decode step could take: the bytes it must move
    over the HBM rate, against its multiply-adds over the tensor rate of
    the weights' dtype. Bytes: every weight the step multiplies, read once
    (for MoE only the experts its tokens select, ``experts`` distinct ones
    a layer as counted in this run, plus the router and the shared
    expert); ``batch`` rows of the embedding table; the cache (dense KV:
    up to ``cur_len`` read, or the window's ring, and one slot written;
    MLA: the c_kv + k_rope rows likewise; SSM and hybrid: the f32 ssm
    state and the conv state, each read and written); the logits written.
    Multiply-adds: every non-expert weight and ``top_k`` experts (plus the
    shared one) a token, and the attention over the cache (MLA: through
    the absorbed weights)."""
    item = params.unembed.w.element_size()
    named = dict(params.named_parameters())
    routed = {n for n in named if ".moe." in n and ".shared." not in n
              and n.rsplit(".", 1)[1] in ("gate", "up", "down")}
    weights = sum(p.numel() * p.element_size() for n, p in named.items()
                  if n != "embed" and n not in routed)
    matmul = sum(p.numel() for n, p in named.items() if n.endswith(".w"))
    if cfg.n_experts:
        expert = 3 * cfg.d_model * cfg.d_ff_expert
        weights += sum(experts) * expert * item
        matmul += cfg.n_layers * cfg.top_k * expert
    n, b, cached = cfg.n_layers, batch, cur_len + 1
    nbytes = weights + b * cfg.d_model * item + b * cfg.vocab * item
    att = 0
    if cfg.mla:
        r, rope = cfg.kv_lora_rank, cfg.qk_rope_dim
        nbytes += n * b * (r + rope) * item * (cached + 1)
        att = n * cfg.n_heads * (cfg.qk_nope_dim * r + cur_len * (2 * r + rope)
                                 + r * cfg.v_head_dim)
    elif cfg.uses_attention:
        ring = min(cached, cfg.sliding_window) if cfg.sliding_window \
            else cached
        nbytes += 2 * n * b * cfg.n_kv_heads * cfg.head_dim * item * (ring + 1)
        att = 2 * n * cfg.n_heads * cfg.head_dim * min(cur_len, ring)
    if cfg.ssm or cfg.hybrid:
        spec = cfg.ssm_spec
        state = spec.n_heads * spec.head_dim * spec.d_state
        nbytes += 2 * n * b * (state * 4 + 3 * (spec.d_inner
                                                + 2 * spec.d_state) * item)
        att += 3 * n * state
    flops = 2 * b * (matmul + att)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / FLOPS_PER_S[str(cfg.dtype)] * 1e3
    every = sum(p.numel() * p.element_size() for p in params.parameters())
    return dict(bytes=nbytes, weight_bytes=weights, bytes_ms=bytes_ms,
                all_weights_ms=every / HBM_BYTES_PER_S * 1e3,
                flops=flops, flops_ms=flops_ms,
                bound_ms=max(bytes_ms, flops_ms),
                bound_by="bytes" if bytes_ms >= flops_ms else "operations")


def lm_full_width(device, arch: str, *, smoke: bool = False,
                  layers: int | None = None, rel: float = LM_BF16_REL) -> dict:
    """`launch.serve.run_lm` at full width (the JAX launcher's flags: 8
    requests, prompts of 4-31 tokens, max_new 16, batch 4, max_len 256,
    temperature 0; seeded random bf16 weights drawn on the card), ``layers``
    deep when given, then on its engine's weights: every logit finite,
    prefill + decode_step against forward within ``rel`` of the logits'
    scale, the MLA prefill kernel's launches in one prefill (one a layer
    where the route takes it), and the times of one group prefill, one
    decode step (call and device time, idle share, kernel events) against
    its bound."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.serve.engine import Request

    args = serve.parse_args(["--workload", "lm", "--arch", arch])
    args.smoke = smoke
    cfg = configs.get(arch, smoke=smoke)
    full_layers = cfg.n_layers
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=min(layers, cfg.n_layers))
    torch.zeros((), device=device)  # the allocator exists before its reset
    torch.cuda.reset_peak_memory_stats(device)
    secs, t0 = {}, time.perf_counter()
    res = serve.run_lm(args, device=device, cfg=cfg)
    peak = torch.cuda.max_memory_allocated(device)
    secs["run_lm"] = time.perf_counter() - t0
    eng = res["engine"]
    cfg, params = eng.cfg, eng.params
    check(all(r.done and len(r.out) == args.max_new for r in res["requests"]),
          f"{arch}: a request stopped short")
    rng = np.random.RandomState(1)
    x = torch.as_tensor(rng.randint(0, cfg.vocab, (LM_GROUP, LM_PLEN + 1)),
                        device=device)
    with routes_recorded() as r_full:
        full, _ = lm.forward(params, cfg, x)
    with routes_recorded() as r_path:
        last, cache = lm.prefill(params, cfg, x[:, :LM_PLEN],
                                 max_len=args.max_len)
        step, cache = lm.decode_step(params, cfg, x[:, LM_PLEN:], cache)
    for name, t in (("forward", full), ("prefill", last), ("decode", step)):
        check(bool(torch.isfinite(t).all()), f"{arch}: {name} logits finite")
    stats = eng.stats.as_dict()  # the entry point's run alone
    # the same requests again on the warm engine: steady tokens/s
    again = [Request(prompt=r.prompt, max_new_tokens=r.max_new_tokens)
             for r in res["requests"]]
    t0 = time.perf_counter()
    eng.generate(again)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    check([r.out for r in again] == [r.out for r in res["requests"]],
          f"{arch}: greedy tokens differ between two runs")
    # bf16 GEMMs of other shapes (132 rows against 128 and 4) can move a
    # router score across a near tie: where the two paths route a token
    # otherwise, prefill + decode_step is replayed with forward's routing
    # and held to the same tolerance
    flips = routing_flips(cfg, r_full, r_path, LM_GROUP, LM_PLEN)
    replayed = None
    if flips:
        k = cfg.top_k
        ids = [r[0].reshape(LM_GROUP, LM_PLEN + 1, k) for r in r_full]
        with routes_forced([i[:, :LM_PLEN].reshape(-1, k) for i in ids]
                           + [i[:, LM_PLEN:].reshape(-1, k) for i in ids]):
            r_last, r_cache = lm.prefill(params, cfg, x[:, :LM_PLEN],
                                         max_len=args.max_len)
            r_step, _ = lm.decode_step(params, cfg, x[:, LM_PLEN:], r_cache)
        replayed = {"prefill": r_last, "decode": r_step[:, 0]}
    err, flipped = {}, []
    for name, got, want, pos in (
            ("prefill", last, full[:, LM_PLEN - 1], LM_PLEN - 1),
            ("decode", step[:, 0], full[:, LM_PLEN], LM_PLEN)):
        scale = float(want.float().abs().max())
        rows = (got.float() - want.float()).abs().amax(dim=-1).tolist()
        err[name] = max(rows)
        for row, e in enumerate(rows):
            if (row, pos) in flips:  # routed otherwise at or before pos
                e = float((replayed[name][row].float()
                           - want[row].float()).abs().max())
                flipped.append(dict(path=name, row=row, err=rows[row],
                                    replayed_err=e, scale=scale,
                                    **flips[(row, pos)]))
            check(e <= rel * scale, f"{arch}: {name} row {row} against "
                  f"forward {e} > {rel} x {scale}")

    def prefill():
        return lm.prefill(params, cfg, x[:, :LM_PLEN], max_len=args.max_len)

    def decode():  # writes the same cache slot every call
        return lm.decode_step(params, cfg, x[:, LM_PLEN:], cache)

    with routes_recorded() as routes:  # the experts the timed step reads
        decode()
    experts = [len(torch.unique(ids)) for ids, _ in routes]
    # the MLA prefill kernel: one launch a layer in the timed prefill
    # where the route takes it (bf16 at DeepSeek-V2/V3's head widths)
    from repro_torch.kernels.mla_prefill import mla_prefill as mp

    with torch.no_grad():
        mla_route = cfg.mla and lm._mla_prefill_kernel(
            cfg, x.new_empty(0, dtype=cfg.dtype))
    mp.reset_launches()
    prefill()
    mla_launches = mp.LAUNCHES["mla_prefill"]
    check(mla_launches == (cfg.n_layers if mla_route else 0),
          f"{arch}: {mla_launches} MLA prefill launches in one prefill of "
          f"{cfg.n_layers} layers")
    secs["checks"] = time.perf_counter() - t0 - secs["run_lm"]
    t0 = time.perf_counter()
    timed = dict(prefill_ms=time_ms(prefill, iters=10),
                 decode_ms=time_ms(decode, iters=30))
    secs["timed"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    decode_profile = profile(decode, reps=10, cpu=False)
    secs["profile"] = time.perf_counter() - t0
    out = dict(arch=cfg.name, layers=cfg.n_layers, full_layers=full_layers,
               d_model=cfg.d_model, experts_per_layer=experts or None,
               vocab=cfg.vocab, params=cfg.param_count(), tol_rel=rel,
               requests=len(res["requests"]), tokens=res["tokens"],
               generate_s=res["seconds"],
               tokens_per_s=res["tokens"] / res["seconds"],
               warm_generate_s=warm_s, warm_tokens_per_s=res["tokens"] / warm_s,
               stats=stats, peak_mem_bytes=peak,
               err_vs_forward=err, routing_flips=flipped,
               prefill_shape=[LM_GROUP, LM_PLEN],
               prefill_mla_launches=mla_launches, **timed,
               decode_profile=decode_profile,
               bound=lm_bound(cfg, params, LM_GROUP, cache.length, experts),
               secs=secs)
    return out


def lm_card_vs_cpu(device, arch: str, cfg=None) -> dict:
    """The full-width config cut to `LM_CUT_LAYERS` layers (and by
    `LM_CPU_CUTS`; or ``cfg``, a CPU rehearsal's), in f32 with TF32
    off, weights drawn on the card from a seed and copied to the CPU
    (`card_and_cpu`): an
    engine group's prefill (left-padded prompts of 4-31 tokens) and
    `LM_STEPS` decode steps fed the card's greedy tokens, logits and every
    cache field within the CPU tests' f32 tolerance on both devices
    (rtol = atol = 1e-5 elementwise; for `LM_FAMILIES` 1e-5 of each
    tensor's scale: at deepseek-v3's width f32 sums in another order
    move a logit by about 2.6e-6 of the scale, and the CPU's own prefill
    on one thread is printed beside it), the
    routing ids of every MoE call identical (the smallest k / k+1 score
    gap printed); the greedy tokens
    identical, except where the CPU's top-2 gap is inside the tolerance
    (printed). Then `Engine.generate` on both (8 requests, max_new 16):
    requests with equal tokens reported."""
    import torch

    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine, Request

    cfg = cfg or cpu_cut(arch)
    of_scale = arch in LM_FAMILIES
    secs, t0 = {}, time.perf_counter()
    card, cpu = card_and_cpu(cfg, device)
    secs["init"] = time.perf_counter() - t0
    rng = np.random.RandomState(2)
    lens = rng.randint(4, 32, size=LM_GROUP)
    prompts = np.zeros((LM_GROUP, lens.max()), np.int64)
    for i, n in enumerate(lens):  # left-padded, as the engine's group
        prompts[i, lens.max() - n:] = rng.randint(0, cfg.vocab, n)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    stack = contextlib.ExitStack()
    try:
        recorded = stack.enter_context(routes_recorded())
        worst, ties = {}, []

        def close(name, a, b):
            a, b = a.float().cpu(), b.float()
            d = (a - b).abs()
            worst[name] = max(worst.get(name, 0.0), float(d.max()))
            ref = b.abs().max() if of_scale else b.abs()
            over = d > LM_ATOL + LM_RTOL * ref
            check(not bool(over.any()),
                  f"{cfg.name} card vs CPU: {name} off by {float(d.max())} "
                  f"({int(over.sum())} of {d.numel()} elements over, scale "
                  f"{float(b.abs().max())})")

        gaps = []

        def same_routes(routes):  # the card's calls, then the CPU's
            half = len(routes) // 2
            check(2 * half == len(routes), "routing calls differ")
            for (a, _), (b, scores) in zip(routes[:half], routes[half:]):
                gaps.append(min_gap(scores, cfg.top_k))
                check(torch.equal(a, b), f"{cfg.name} card vs CPU: routing "
                      f"ids differ (smallest gap {gaps[-1]})")
            routes.clear()

        def caches(cc, cp):
            for f in lm.CACHE_FIELDS:
                if getattr(cp, f) is not None:
                    close(f"cache {f}", getattr(cc, f), getattr(cp, f))

        t0 = time.perf_counter()
        lc, cc = lm.prefill(card, cfg, torch.as_tensor(prompts,
                                                       device=device),
                            max_len=64)
        lp, cp = lm.prefill(cpu, cfg, torch.as_tensor(prompts), max_len=64)
        same_routes(recorded)
        secs["prefill"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        threads = torch.get_num_threads()  # the reference against itself
        torch.set_num_threads(1)
        try:
            lp1, _ = lm.prefill(cpu, cfg, torch.as_tensor(prompts),
                                max_len=64)
        finally:
            torch.set_num_threads(threads)
        secs["prefill_1_thread"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        recorded.clear()
        cpu_threads_err = float((lp1 - lp).abs().max())
        close("prefill logits", lc, lp)
        caches(cc, cp)
        tokens = []
        for step in range(LM_STEPS):
            tc = torch.argmax(lc, -1).cpu()
            tp = torch.argmax(lp, -1)
            for row in np.flatnonzero((tc != tp).numpy()):
                top2 = torch.topk(lp[row], 2).values
                gap = float(top2[0] - top2[1])
                check(gap <= 2 * (LM_ATOL + LM_RTOL * float(top2[0].abs())),
                      f"{cfg.name}: greedy token differs at step {step} row "
                      f"{row} with a top-2 gap of {gap}")
                ties.append(dict(step=step, row=int(row), gap=gap))
            tokens.append(tc.tolist())
            lc, cc = lm.decode_step(card, cfg, tc[:, None].to(device), cc)
            lp, cp = lm.decode_step(cpu, cfg, tc[:, None], cp)
            same_routes(recorded)
            lc, lp = lc[:, 0], lp[:, 0]
            close("decode logits", lc, lp)
        caches(cc, cp)
        stack.close()
        secs["decode"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        reqs = {}
        for dev, params in (("card", card), ("cpu", cpu)):
            r2 = np.random.RandomState(0)
            reqs[dev] = Engine(cfg, params, batch_size=4, max_len=256).generate(
                [Request(prompt=r2.randint(0, cfg.vocab, size=r2.randint(4, 32)),
                         max_new_tokens=16) for _ in range(8)])
        same = sum(a.out == b.out for a, b in zip(reqs["card"], reqs["cpu"]))
        secs["engine"] = time.perf_counter() - t0
    finally:
        stack.close()
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return dict(arch=cfg.name, layers=cfg.n_layers, dtype="float32",
                n_experts=cfg.n_experts, max_abs_err=worst,
                tolerance="1e-5 of the scale" if of_scale
                else "rtol = atol = 1e-5", cpu_threads=threads,
                cpu_1_thread_logits_err=cpu_threads_err,
                greedy_tokens=tokens, near_ties=ties,
                routing_calls=len(gaps),
                routing_min_gap=min(gaps) if gaps else None,
                engine_requests_equal=same, engine_requests=8, secs=secs)


def same_match(a, b) -> bool:
    """Two `RoutedResponse`s matched alike: hit, template row, error, the
    margin's f32 bits and the score's and energy's f64 bits."""
    f32 = lambda x: np.float32(x).tobytes()  # noqa: E731
    f64 = lambda x: np.float64(x).tobytes()  # noqa: E731
    return (a.cache_hit == b.cache_hit and a.template_id == b.template_id
            and a.error == b.error and f32(a.margin) == f32(b.margin)
            and f64(a.score) == f64(b.score)
            and f64(a.energy_j) == f64(b.energy_j))


def hits_serve_admitted(responses) -> bool:
    """Every hit serves the tokens that the miss which admitted its
    template row decoded."""
    admitted = {}
    for r in responses:
        if r.cache_hit:
            if admitted.get(r.template_id) != r.tokens:
                return False
        elif r.error is None and r.template_id >= 0:
            admitted[r.template_id] = r.tokens
    return True


CACHED_KEYS = ("hits", "served", "classify_dispatches", "ticks",
               "nj_per_request", "escalated", "requests_per_s")


def lm_cached_match(device, name: str, argv: list[str]) -> dict:
    """`launch.serve.main(argv)` (an lm-cached run) on the card (B3
    launched on every tick, the launch count zeroed just before) against
    the same run on the CPU: every response matched alike (`same_match`),
    and the hits, served, matching calls, ticks and nJ/request equal, one
    B3 launch a tick. The launcher draws its weights on its device, so the
    tokens a miss decodes differ between the two; each run's hits serve
    its misses' tokens (`hits_serve_admitted`). Returns the driven path."""
    from repro_torch.launch import serve

    got, counts, wall = drive(name, lambda: serve.main(argv, device=device),
                              ["acam_match_serve"])
    want = serve.main(argv, device="cpu")
    check(len(got["responses"]) == len(want["responses"]),
          "lm-cached card vs CPU: response counts differ")
    for i, (a, b) in enumerate(zip(got["responses"], want["responses"])):
        check(same_match(a, b),
              f"lm-cached card vs CPU: request {i} matched {a} != {b}")
    for dev, res in (("card", got), ("CPU", want)):
        check(hits_serve_admitted(res["responses"]),
              f"lm-cached on the {dev}: a hit served other tokens than its "
              "template's miss decoded")
    for key in ("hits", "served", "classify_dispatches", "ticks",
                "nj_per_request", "escalated"):
        check(got[key] == want[key],
              f"lm-cached card vs CPU: {key} {got[key]} != {want[key]}")
    check(counts["acam_match_serve"] == got["classify_dispatches"]
          == got["ticks"],
          f"B3 launches {counts['acam_match_serve']}, matching calls "
          f"{got['classify_dispatches']}, ticks {got['ticks']}")
    return dict(argv=argv, launches=counts, wall_s=wall,
                card={k: got[k] for k in CACHED_KEYS},
                cpu={k: want[k] for k in CACHED_KEYS},
                responses_matched=len(got["responses"]))


def lm_cached(device, *, smoke: bool = False) -> tuple[dict, dict]:
    """`lm_cached_match` for the launcher's default arch and for the MoE
    phi3.5-moe (both SMOKE); then `launch.serve.run_lm_cached` with
    full-width tinyllama (``smoke`` keeps the SMOKE config for a CPU
    rehearsal): hit-path and miss-path latency of its responses, and an
    all-hit probe burst on its service; then `lm_cache_bench` at smoke
    size. Returns (the driven paths, the phase's numbers)."""
    import torch

    from repro_torch import configs
    from repro_torch.benchmarks import serving_bench
    from repro_torch.launch import serve
    from repro_torch.serve.semantic_cache import (PromptRequest,
                                                  synthetic_prompt_trace)

    argv = ["--workload", "lm-cached"]
    driven = {"lm_cached": lm_cached_match(device, "lm_cached", argv),
              "lm_cached_moe": lm_cached_match(
                  device, "lm_cached_moe",
                  argv + ["--arch", "phi3.5-moe-42b-a6.6b"])}
    got = driven["lm_cached"]["card"]

    args = serve.parse_args(argv)
    args.smoke = smoke
    res = serve.run_lm_cached(args, device=device)
    torch.cuda.synchronize()
    out, svc = res["responses"], res["service"]
    hits = [r.latency_s * 1e3 for r in out if r.cache_hit]
    misses = [r.latency_s * 1e3 for r in out if not r.cache_hit]
    check(len(hits) == got["hits"] and all(r.error is None for r in out)
          and hits_serve_admitted(out),
          f"full-width cache: {len(hits)} hits, the smoke run {got['hits']}")
    cfg = configs.get(args.arch, smoke=smoke)
    probe = synthetic_prompt_trace(args.seed, vocab=cfg.vocab,
                                   n_unique=args.unique,
                                   n_requests=args.requests)[:args.unique]
    t0 = time.perf_counter()
    probed = svc.serve_prompts(PromptRequest("edge-0", p,
                                             max_new_tokens=args.max_new)
                               for p in probe)
    probe_ms = (time.perf_counter() - t0) * 1e3 / len(probe)
    check(all(r.cache_hit for r in probed), "the probe burst missed")
    t0 = time.perf_counter()
    bench = serving_bench.lm_cache_bench(smoke=True, device=device)
    bench_s = time.perf_counter() - t0
    return driven, dict(
        counts=got, counts_moe=driven["lm_cached_moe"]["card"],
        full_width=dict(arch=cfg.name, requests=len(out),
                        hits=len(hits), misses=len(misses),
                        trace_s=res["seconds"],
                        hit_latency_ms=statistics.median(hits),
                        miss_latency_ms=statistics.median(misses),
                        probe_hit_ms_per_request=probe_ms,
                        nj_per_request=res["nj_per_request"],
                        classify_dispatches=res["classify_dispatches"],
                        ticks=res["ticks"]),
        bench=bench, bench_s=bench_s)


def lm_phase(device, *, smoke: bool = False, cut_cfgs=None
             ) -> tuple[dict, dict]:
    """Phase 6: full width (`lm_full_width`) for each of `LM_ARCHS` and,
    cut in depth, of `LM_FAMILIES` (one at a time, each freed before the
    next), card against CPU (`lm_card_vs_cpu`, `cpu_cut`) for all six,
    and `lm_cached` (the
    launcher's full-width tinyllama). ``smoke`` / ``cut_cfgs`` (arch ->
    config) shrink the configs for a CPU rehearsal."""
    import gc

    import torch

    out = {"full_width": {}, "card_vs_cpu": {}}
    runs = [(a, None, LM_BF16_REL) for a in LM_ARCHS] + [
        (a, layers, rel) for a, (layers, rel) in LM_FAMILIES.items()]
    for arch, layers, rel in runs:
        t0 = time.perf_counter()
        res = lm_full_width(device, arch, smoke=smoke, layers=layers, rel=rel)
        res["wall_s"] = time.perf_counter() - t0
        out["full_width"][arch] = res
        gc.collect()
        torch.cuda.empty_cache()
    for arch in (*LM_ARCHS, *LM_FAMILIES):
        t0 = time.perf_counter()
        out["card_vs_cpu"][arch] = lm_card_vs_cpu(
            device, arch, cfg=cut_cfgs[arch] if cut_cfgs else None)
        out["card_vs_cpu"][arch]["wall_s"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    driven, out["cached"] = lm_cached(device, smoke=smoke)
    out["cached"]["wall_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    return driven, out


def launch_us(p: dict):
    """A profiled call's wall time over its device events: the host's cost
    of one launch where the device idles (idle share near 1)."""
    return p["wall_ms"] * 1e3 / p["device_events"] if p["device_events"] \
        else None


def print_lm(lmo: dict, card: str) -> None:
    for arch, r in lmo["full_width"].items():
        p, b = r["decode_profile"], r["bound"]
        print(f"lm {r['arch']} ({r['layers']} of {r['full_layers']} layers, "
              f"d {r['d_model']}, vocab {r['vocab']}, {r['params']} params, "
              f"bf16; {card}): "
              f"{r['requests']} requests, {r['tokens']} tokens in "
              f"{r['generate_s']:.3f} s = {r['tokens_per_s']:.1f} tokens/s "
              f"(warm: {r['warm_generate_s']:.3f} s = "
              f"{r['warm_tokens_per_s']:.1f} tokens/s); "
              f"stats {json.dumps(r['stats'])}; peak memory "
              f"{r['peak_mem_bytes'] / 2**30:.3f} GiB")
        print(f"lm {r['arch']}: prefill {r['prefill_shape']} "
              f"{r['prefill_ms']:.3f} ms ({r['prefill_mla_launches']} MLA "
              f"prefill launches); decode step (batch {LM_GROUP}) "
              f"{r['decode_ms']:.3f} ms a call, device {p['device_ms']} ms, "
              f"idle share {p['idle_share']}, {p['device_events']} device "
              f"events a step ({launch_us(p)} us of wall time each); "
              f"bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']}: {b['bytes']} bytes, "
              f"{b['weight_bytes']} of weights; every weight incl. the "
              f"embedding table {b['all_weights_ms']:.4f} ms); err vs forward "
              f"{json.dumps(r['err_vs_forward'])} (tolerance {r['tol_rel']} "
              f"x scale); experts read a layer {r['experts_per_layer']}; "
              f"routing flips against forward (replayed with forward's "
              f"routing): {json.dumps(r['routing_flips'])}")
        print(f"lm {r['arch']} decode profile: {json.dumps(p)}")
    for arch, r in lmo["card_vs_cpu"].items():
        print(f"lm card vs CPU {r['arch']} ({r['layers']} layers, "
              f"{r['n_experts']} experts, f32, TF32 off): max abs err "
              f"{json.dumps(r['max_abs_err'])}; routing ids equal in "
              f"{r['routing_calls']} MoE calls (smallest k / k+1 gap "
              f"{r['routing_min_gap']}); greedy "
              f"tokens {r['greedy_tokens']}, near ties {r['near_ties']}; "
              f"engine requests with equal tokens "
              f"{r['engine_requests_equal']} / {r['engine_requests']}; "
              f"tolerance {r['tolerance']}; the CPU's prefill logits on 1 "
              f"thread against {r['cpu_threads']}: "
              f"{r['cpu_1_thread_logits_err']}")
    c = lmo["cached"]
    print(f"lm-cached card == CPU: {json.dumps(c['counts'])}")
    print(f"lm-cached phi3.5-moe (SMOKE) card == CPU: "
          f"{json.dumps(c['counts_moe'])}")
    fw = c["full_width"]
    print(f"lm-cached full width {fw['arch']} ({card}): {fw['hits']} hits / "
          f"{fw['misses']} misses, hit latency {fw['hit_latency_ms']:.3f} ms "
          f"vs miss {fw['miss_latency_ms']:.3f} ms (median), all-hit probe "
          f"{fw['probe_hit_ms_per_request']:.4f} ms a request, "
          f"{fw['nj_per_request']} nJ/request, {fw['classify_dispatches']} "
          f"matching calls over {fw['ticks']} ticks")
    for e in c["bench"]:
        print(f"lm_cache_bench ({card}): {json.dumps(e)}")


# ---------------------------------------------------------------------------
# 7. the LM trainer
# ---------------------------------------------------------------------------

#: full width on the card through `launch.train.main`: the launcher's
#: default arch, batch 8 x seq 64, bf16, remat on, all 22 layers
TRAIN_ARCH = "tinyllama-1.1b"
TRAIN_STEPS = 8
TRAIN_BATCH, TRAIN_SEQ = 8, 64
#: card against CPU in f32 (`cpu_cut`), one config a family (dense, vlm,
#: audio, moe, MLA + sigmoid moe, ssm, hybrid): arch -> (batch, seq), the
#: launcher's 8 x 64 cut to 2 x 32 for the three largest (1.6-2.8 G
#: parameters at one layer), where the CPU's side takes longest
TRAIN_FAMILIES = {"tinyllama-1.1b": (8, 64), "qwen2-vl-72b": (2, 32),
                  "hubert-xlarge": (8, 64), "phi3.5-moe-42b-a6.6b": (2, 32),
                  "deepseek-v3-671b": (2, 32), "mamba2-2.7b": (8, 64),
                  "hymba-1.5b": (8, 64)}
#: one AdamW step from the same gradients on both devices: every
#: parameter within this fraction of its tensor's scale
TRAIN_STEP_REL = 1e-5
#: SMOKE resume: (steps, ckpt-every, resumed to)
TRAIN_RESUME = (6, 3, 8)
#: hubert-xlarge at full width: its encoder's training steps
HUBERT_FULL_STEPS = 4


def train_bound(cfg, params, tokens: int) -> dict:
    """The least time one training step could take: the bytes over the
    HBM rate against the products over the tensor rate of the weights'
    dtype. Bytes: every parameter read three
    times (forward, remat's recompute, backward; the embedding only at the
    ``tokens`` rows gathered) and written once (the update), each gradient
    written once and read twice (the global norm, AdamW), AdamW's f32
    ``mu`` / ``nu`` read and written. ``bytes_once`` counts each input read
    once and each output written once (parameters and moments), the
    algorithm's floor. Products: 2 x tokens x every matmul weight (MoE:
    ``top_k`` experts a token and the shared one) and the attention's
    full S x S score and value products (`chunked_attention` masks, it
    skips nothing), times 4: forward, recompute and the backward's two."""
    item = params.unembed.w.element_size()
    named = dict(params.named_parameters())
    n_all = sum(p.numel() for p in named.values())
    p_bytes = sum(p.numel() * p.element_size() for p in named.values())
    embed = named["embed"].numel() * item if "embed" in named else 0
    rows = tokens * cfg.d_model * item if embed else 0
    nbytes = (3 * (p_bytes - embed + rows) + p_bytes  # reads, the rewrite
              + 3 * p_bytes  # gradients: written, read twice
              + 16 * n_all)  # mu, nu: f32, read and written
    once = 2 * p_bytes + 16 * n_all
    matmul = sum(p.numel() for n, p in named.items() if n.endswith(".w"))
    if cfg.n_experts:
        matmul += cfg.n_layers * cfg.top_k * 3 * cfg.d_model * cfg.d_ff_expert
    seq = TRAIN_SEQ
    att = 0
    if cfg.uses_attention:
        hd = (cfg.qk_nope_dim + cfg.qk_rope_dim + cfg.v_head_dim) // 2 \
            if cfg.mla else cfg.head_dim
        att = cfg.n_layers * 4 * tokens * seq * cfg.n_heads * hd
    flops = 4 * (2 * tokens * matmul + att)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / FLOPS_PER_S[str(cfg.dtype)] * 1e3
    return dict(bytes=nbytes, bytes_ms=bytes_ms, bytes_once=once,
                bytes_once_ms=once / HBM_BYTES_PER_S * 1e3, flops=flops,
                flops_ms=flops_ms, bound_ms=max(bytes_ms, flops_ms),
                bound_by="bytes" if bytes_ms >= flops_ms else "operations")


def lm_train_full_width(device, *, smoke: bool = False) -> dict:
    """`launch.train.main` at full width (`TRAIN_ARCH`, all layers, bf16,
    remat on, the launcher's batch and seq; ``smoke`` takes the SMOKE
    config for a CPU rehearsal) for `TRAIN_STEPS` steps: every loss finite
    and the last below the first; peak memory; then one more step on the
    same weights timed (CUDA events) and profiled (device time, idle
    share, events) against `train_bound`."""
    import torch

    from repro_torch import configs
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.train.cnn_trainer import params_of

    argv = ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ)]
    torch.zeros((), device=device)  # the allocator exists before its reset
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    res = train.main(argv + (["--smoke"] if smoke else []), device=device)
    main_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device)
    losses = res["losses"]
    check(len(losses) == TRAIN_STEPS and bool(np.isfinite(losses).all()),
          f"full-width training: losses {losses}")
    check(losses[-1] < losses[0], f"full-width training: the loss did not "
          f"fall ({losses})")
    cfg = configs.get(TRAIN_ARCH, smoke=smoke)
    model = lm.init_params(0, cfg, device=device)
    opt = steps_lib.make_optimizer(cfg)
    state = [opt.init(params_of(model))]
    step = steps_lib.make_train_step(cfg, opt)
    batch = train.synthetic_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, 0,
                                  device=device)

    def one():
        _, state[0], _, loss = step(model, state[0], None, batch)
        return loss

    out = dict(arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
               vocab=cfg.vocab, params=cfg.param_count(), dtype=str(cfg.dtype),
               remat=cfg.remat, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
               losses=losses, step_s=res["step_s"], main_s=main_s,
               peak_mem_bytes=peak, step_ms=time_ms(one, iters=5),
               step_profile=profile(one, reps=2, cpu=False),
               bound=train_bound(cfg, model, TRAIN_BATCH * TRAIN_SEQ))
    del model, state
    return out


def leaf_groups(named: dict) -> dict:
    """The port's parameter names grouped by their JAX leaf (layers in
    order): one stacked tensor at a time, not the whole stacked tree."""
    import re

    groups = {}
    for name in named:
        groups.setdefault(re.sub(r"^layers\.\d+\.", "layers.", name),
                          []).append(name)
    return groups


#: AdamW and the gradient comparison run on row chunks of at most this many
#: elements (the same elementwise arithmetic; on the CPU whole-tensor
#: temporaries page-fault on every op and take 5-7x longer, on the card
#: they would not fit beside the largest model and its gradients)
ADAMW_CHUNK = 1 << 20


def row_chunks(x):
    """``x`` in chunks of at most `ADAMW_CHUNK` elements: a weight as
    (rows, last dim) row blocks, which keep its rank class (ndim >= 2, on
    which the decay set depends), a vector as slices."""
    if x.ndim > 1:
        return x.reshape(-1, x.shape[-1]).split(
            max(1, ADAMW_CHUNK // x.shape[-1]))
    return x.split(ADAMW_CHUNK)


def lm_train_card_vs_cpu(device, arch: str, card, cpu, cfg) -> dict:
    """The f32 model ``card`` (`cpu_cut`'s config, drawn by
    `card_and_cpu`) and ``cpu``, its copy on the CPU, TF32 off, on the
    launcher's synthetic batch at `TRAIN_FAMILIES`' size: the loss within
    `LM_RTOL` relative, every gradient within relative L2 `GRAD_RTOL` per
    JAX leaf, the routing ids of every MoE call (forward and recompute)
    identical; one AdamW step (`make_optimizer`, clipped) from the CPU's
    gradients on both devices within `TRAIN_STEP_REL` of each tensor's
    scale (each device's step from its own gradients reported); the int8
    compression of the same gradients bit-identical. The seconds of each
    part are reported."""
    import torch

    from repro_torch import convert
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch import train
    from repro_torch.optim import compression
    from repro_torch.optim import optimizers as optim

    b, s = TRAIN_FAMILIES[arch]
    secs = {}
    batch = train.synthetic_batch(cfg, b, s, 0, device="cpu")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        t0 = time.perf_counter()
        with routes_recorded() as routes:
            lc, gc = steps_lib.value_and_grad(
                card, cfg, {k: v.to(device) for k, v in batch.items()})
            half = len(routes)
            t1 = time.perf_counter()
            lp, gp = steps_lib.value_and_grad(cpu, cfg, batch)
        secs["grad_card"], secs["grad_cpu"] = t1 - t0, time.perf_counter() - t1
        check(len(routes) == 2 * half, f"{cfg.name}: routing calls differ")
        gaps = []
        for (a, _), (bb, scores) in zip(routes[:half], routes[half:]):
            gaps.append(min_gap(scores, cfg.top_k))
            check(torch.equal(a, bb), f"{cfg.name} training card vs CPU: "
                  f"routing ids differ (smallest gap {gaps[-1]})")
        loss_err = abs(float(lc) - float(lp))
        check(loss_err <= LM_RTOL * abs(float(lp)),
              f"{cfg.name}: loss card {float(lc)} vs CPU {float(lp)}")
        t0 = time.perf_counter()
        grad_err = {}
        for leaf, names in leaf_groups(gp).items():  # compared on the card
            diff = torch.zeros((), dtype=torch.float64, device=device)
            norm = torch.zeros((), dtype=torch.float64, device=device)
            for n in names:
                for a, w in zip(row_chunks(gc[n]), row_chunks(gp[n])):
                    w = w.to(device).double()
                    diff += (a.double() - w).square().sum()
                    norm += w.square().sum()
            grad_err[leaf] = float(diff.sqrt() / norm.sqrt().clamp_min(1e-30))
            check(grad_err[leaf] <= GRAD_RTOL, f"{cfg.name}: gradient {leaf} "
                  f"rel L2 {grad_err[leaf]}")
        secs["compare"] = time.perf_counter() - t0
        # clipping as `make_train_step` clips, one tensor at a time and in
        # row chunks on both devices (a clipped copy of every gradient, or
        # a whole-tensor step's temporaries beside qwen2-vl's 4.6 GiB
        # embedding, would not fit beside the model and its gradients);
        # every comparison on the card
        t0 = time.perf_counter()
        opt = steps_lib.make_optimizer(cfg)
        scale_p, scale_c = (torch.clamp(1.0 / (optim.global_norm(g) + 1e-9),
                                        max=1.0) for g in (gp, gc))
        scale_d = scale_p.to(device)
        pc = dict(card.named_parameters())
        step_err, own_err = 0.0, 0.0
        for k, p in cpu.named_parameters():
            def update(g, q):
                q = q.detach()
                return opt.update({k: g}, opt.init({k: q}), {k: q})[0][k]

            top, got, own = (torch.zeros((), device=device) for _ in range(3))
            for g, q, gd, qd in zip(*map(row_chunks, (
                    gp[k], p.detach(), gc[k], pc[k].detach()))):
                want = update(g * scale_p, q).to(device)
                top = torch.maximum(top, want.abs().max())
                got = torch.maximum(got, (update(g.to(device) * scale_d, qd)
                                          - want).abs().max())
                own = torch.maximum(own, (update(gd * scale_c, qd)
                                          - want).abs().max())
            scale = float(top) or 1.0
            step_err = max(step_err, float(got) / scale)
            own_err = max(own_err, float(own) / scale)
        check(step_err <= TRAIN_STEP_REL, f"{cfg.name}: AdamW step card vs "
              f"CPU {step_err} of the scale")
        secs["adamw"] = time.perf_counter() - t0
        del gc
        # one scale per JAX leaf, the layers' tensors stacked as
        # `make_train_step` stacks them (one leaf at a time), each leaf's
        # CPU result compared on the card
        t0 = time.perf_counter()
        for names in leaf_groups(gp).values():
            x = convert.lm_stack({n: gp[n] for n in names})
            dp, ep = compression.compress_decompress(
                x, compression.init_error_state(x))
            y = {k: v.to(device) for k, v in x.items()}
            dc, ec = compression.compress_decompress(
                y, compression.init_error_state(y))
            for k in x:
                check(torch.equal(dc[k], dp[k].to(device))
                      and torch.equal(ec[k], ep[k].to(device)),
                      f"{cfg.name}: compression of {k} differs")
            del x, y, dp, ep, dc, ec
        secs["compression"] = time.perf_counter() - t0
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return dict(arch=cfg.name, layers=cfg.n_layers, n_experts=cfg.n_experts,
                dtype="float32", batch=[b, s], loss_card=float(lc),
                loss_cpu=float(lp), loss_err=loss_err,
                grad_rel_l2_max=max(grad_err.values()),
                grad_rel_l2_worst=max(grad_err, key=grad_err.get),
                routing_calls=len(gaps),
                routing_min_gap=min(gaps) if gaps else None,
                adamw_step_rel=step_err, adamw_own_grads_rel=own_err,
                compression="bit-identical", leaves=len(grad_err),
                params=sum(p.numel() for p in cpu.parameters()), secs=secs)


def lm_train_resume(device, tmp: Path) -> dict:
    """SMOKE `TRAIN_ARCH` through `launch.train.main` on the card: two
    uninterrupted runs from one seed, their losses and their final
    checkpoints (parameters, ``mu``, ``nu``, ``step``) bitwise equal
    under the deterministic mode; a run checkpointed every few steps and
    resumed: the resumed steps' losses equal the uninterrupted run's, bit
    for bit; a run with ``--compress``: its first loss (taken before any
    update) equal to the uncompressed run's, every loss finite."""
    import torch

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.convert import flatten_tree
    from repro_torch.launch import train

    steps, every, total = TRAIN_RESUME
    base = ["--arch", TRAIN_ARCH, "--smoke"]
    runs = []
    for i in range(2):
        d = str(tmp / f"run{i}")
        runs.append((train.main([*base, "--steps", str(total), "--ckpt-dir",
                                 d], device=device)["losses"],
                     Checkpointer(d).restore_dict(total - 1)))
    (full, ck0), (again, ck1) = runs
    check(full == again, f"two seeded runs differ: {full} vs {again}")
    leaves = 0
    other = flatten_tree(ck1)
    for k, v in flatten_tree(ck0).items():
        w = other[k]
        same = (torch.equal(v, w) if isinstance(v, torch.Tensor)
                else np.array_equal(v, w))
        check(same, f"two seeded runs: checkpoint leaf {k} differs")
        leaves += 1
    d = str(tmp / "resume")
    first = train.main([*base, "--steps", str(steps), "--ckpt-every",
                        str(every), "--ckpt-dir", d], device=device)["losses"]
    check(first == full[:steps], "the checkpointed run's losses differ")
    resumed = train.main([*base, "--steps", str(total), "--ckpt-dir", d,
                          "--resume"], device=device)["losses"]
    check(resumed == full[steps:], f"resumed losses {resumed} != "
          f"uninterrupted {full[steps:]}")
    compressed = train.main([*base, "--steps", str(every), "--compress"],
                            device=device)["losses"]
    check(compressed[0] == full[0]
          and bool(np.isfinite(compressed).all()),
          f"compressed run's losses {compressed} (uncompressed {full[0]})")
    return dict(losses=full, resumed_losses=resumed,
                compressed_losses=compressed,
                checkpoint_leaves_equal=leaves, steps=steps,
                ckpt_every=every, resumed_to=total)


def hubert_example(device, *, full_width: bool) -> tuple[dict, dict]:
    """`examples.acam_head_for_hubert.main` on the card, SMOKE (the JAX
    example's size) or at full width (`HUBERT_FULL_STEPS` training steps):
    every loss finite, B1 launched once for the one head call (the counts
    zeroed just before), and its pred / per_class bit-identical to the
    plain reference engine's on the same features. Returns (the driven
    path, the numbers)."""
    import torch

    from repro_torch import match
    from repro_torch.examples import acam_head_for_hubert as ex

    argv = (["--full-width", "--steps", str(HUBERT_FULL_STEPS)]
            if full_width else [])
    name = "hubert_full_width" if full_width else "hubert_smoke"
    r, counts, wall = drive(name, lambda: ex.main(argv, device=device),
                            ["acam_match_classify"])
    check(counts["acam_match_classify"] == 1,
          f"{name}: B1 launched {counts['acam_match_classify']} times for "
          "one head call")
    check(bool(np.isfinite(r["losses"]).all()), f"{name}: losses finite")
    pred, per_class = match.engine_for(backend="reference").classify_features(
        r["features"], r["head"].bank)
    check(torch.equal(r["pred"], pred)
          and torch.equal(r["per_class"], per_class),
          f"{name}: B1's answers differ from the plain path's")
    nums = {k: r[k] for k in ("arch", "layers", "d_model", "vocab",
                              "n_classes", "final_loss", "acc_dense",
                              "acc_acam", "nj_per_frame")}
    nums.update(steps=len(r["losses"]), frames=int(r["labels"].numel()),
                features=int(r["features"].shape[1]), wall_s=wall)
    # B1 at this launch site's shape, timed as phase 1 times it: the head
    # call, the plain reference engine and the bipolar product (partial)
    head, feats, bank = r["head"], r["features"], r["head"].bank
    c, k, n = bank.templates.shape
    q_pm = (feats > bank.thresholds).float() * 2 - 1
    t_pm = bank.templates.reshape(c * k, n) * 2 - 1
    ms, by, _ = bound("acam_match_classify", feats.shape[0], c, k, n, 8)
    nums["b1"] = dict(
        shape=[feats.shape[0], c, k, n], ms=time_ms(lambda: head(feats)),
        plain_ms=time_ms(lambda: match.engine_for(
            backend="reference").classify_features(feats, bank)),
        library_ms=time_ms(lambda: torch.matmul(q_pm, t_pm.T)),
        profile=profile(lambda: head(feats), reps=20), bound_ms=ms,
        bound_by=by)
    return dict(launches=counts, wall_s=wall), nums


def lm_train_phase(device, out_dir: Path, *, smoke: bool = False,
                   cut_cfgs=None) -> tuple[dict, dict]:
    """Phase 7: full-width training (`lm_train_full_width`), card against
    CPU for every family (`lm_train_card_vs_cpu`, each freed before the
    next; ``cut_cfgs`` a CPU rehearsal's configs), the SMOKE resume and
    repeatability (`lm_train_resume`), and the HuBERT example at SMOKE and
    full width (`hubert_example`). Returns (the driven paths, the numbers).
    """
    import gc

    import torch

    out = {"card_vs_cpu": {}}
    gc.collect()
    torch.cuda.empty_cache()
    out["mem_at_start_bytes"] = torch.cuda.memory_allocated(device)
    t0 = time.perf_counter()
    out["full_width"] = lm_train_full_width(device, smoke=smoke)
    out["full_width"]["wall_s"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    for arch in TRAIN_FAMILIES:
        t0 = time.perf_counter()
        cfg = cut_cfgs[arch] if cut_cfgs else cpu_cut(arch)
        torch.cuda.reset_peak_memory_stats(device)
        card, cpu = card_and_cpu(cfg, device)
        init_s = time.perf_counter() - t0
        res = lm_train_card_vs_cpu(device, arch, card, cpu, cfg)
        res.update(wall_s=time.perf_counter() - t0, init_s=init_s,
                   peak_mem_bytes=torch.cuda.max_memory_allocated(device))
        out["card_vs_cpu"][arch] = res
        del card, cpu
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["resume"] = lm_train_resume(device, out_dir)
    out["resume"]["wall_s"] = time.perf_counter() - t0
    driven = {}
    for full in (False, True):
        path, nums = hubert_example(device, full_width=full and not smoke)
        key = "hubert_full_width" if full else "hubert_smoke"
        driven[key], out[key] = path, nums
        gc.collect()
        torch.cuda.empty_cache()
    return driven, out


def print_lm_train(t: dict, card: str) -> None:
    fw = t["full_width"]
    p, b = fw["step_profile"], fw["bound"]
    print(f"lm_train {fw['arch']} ({fw['layers']} layers, d {fw['d_model']}, "
          f"vocab {fw['vocab']}, {fw['params']} params, {fw['dtype']}, remat "
          f"{fw['remat']}, batch {fw['batch']} x seq {fw['seq']}; {card}): "
          f"losses {json.dumps(fw['losses'])}; step wall s "
          f"{json.dumps(fw['step_s'])}; main {fw['main_s']:.3f} s; peak "
          f"memory {fw['peak_mem_bytes'] / 2**30:.3f} GiB")
    print(f"lm_train step: {fw['step_ms']:.3f} ms a call (CUDA events), "
          f"profiled wall {p['wall_ms']} ms, device {p['device_ms']} ms, idle "
          f"share {p['idle_share']}, {p['device_events']} device events "
          f"({launch_us(p)} us of wall each); bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']}: {b['bytes']} bytes = {b['bytes_ms']:.4f} ms, "
          f"{b['flops']} FLOP = {b['flops_ms']:.4f} ms; each input and "
          f"output once {b['bytes_once']} bytes = {b['bytes_once_ms']:.4f} "
          f"ms)")
    print(f"lm_train step profile: {json.dumps(p)}")
    print(f"lm_train: {t['mem_at_start_bytes'] / 2**30:.3f} GiB allocated "
          "on the card when the phase began")
    for arch, r in t["card_vs_cpu"].items():
        print(f"lm_train card vs CPU {r['arch']} ({r['layers']} layers, "
              f"{r['n_experts']} experts, f32, TF32 off, batch "
              f"{r['batch'][0]} x {r['batch'][1]}, init {r['init_s']:.1f} s, "
              f"{r['wall_s']:.1f} s): loss {r['loss_card']} vs "
              f"{r['loss_cpu']} (|diff| {r['loss_err']}); worst gradient "
              f"rel L2 {r['grad_rel_l2_max']:.3e} ({r['grad_rel_l2_worst']}; "
              f"{r['leaves']} leaves); routing ids equal in "
              f"{r['routing_calls']} calls (smallest gap "
              f"{r['routing_min_gap']}); AdamW from the CPU's gradients "
              f"{r['adamw_step_rel']:.3e} of the scale (from each device's "
              f"own: {r['adamw_own_grads_rel']:.3e}); compression "
              f"{r['compression']}; {r['params']} parameters, peak memory "
              f"{r['peak_mem_bytes'] / 2**30:.3f} GiB, seconds "
              f"{json.dumps({k: round(v, 2) for k, v in r['secs'].items()})}")
    r = t["resume"]
    print(f"lm_train resume (SMOKE {TRAIN_ARCH}): {r['steps']} steps, "
          f"checkpoint every {r['ckpt_every']}, resumed to {r['resumed_to']}: "
          f"losses {json.dumps(r['resumed_losses'])} == the uninterrupted "
          f"run's; two seeded runs equal in {r['checkpoint_leaves_equal']} "
          f"checkpoint leaves; --compress losses "
          f"{json.dumps(r['compressed_losses'])}")
    for key in ("hubert_smoke", "hubert_full_width"):
        h = t[key]
        print(f"lm_train {key} ({h['arch']}: {h['layers']} layers, d "
              f"{h['d_model']}, vocab {h['vocab']}; {card}): {h['steps']} "
              f"steps, final loss {h['final_loss']:.4f}; {h['frames']} "
              f"frames x {h['features']} features, {h['n_classes']} classes: "
              f"dense {h['acc_dense']:.4f}, ACAM {h['acc_acam']:.4f}, "
              f"{h['nj_per_frame']:.4f} nJ/frame; {h['wall_s']:.1f} s")
        b1 = h["b1"]
        print(f"lm_train {key} B1 {b1['shape']}: call {b1['ms']:.4f} ms, "
              f"device {b1['profile']['device_ms']} ms, plain (reference "
              f"engine) {b1['plain_ms']:.4f} ms, bipolar matmul (partial) "
              f"{b1['library_ms']:.4f} ms, bound {b1['bound_ms']:.6f} ms "
              f"({b1['bound_by']})")


# ---------------------------------------------------------------------------
# 10. the LM zoo on a mesh
# ---------------------------------------------------------------------------

#: full width on forced meshes of the card: tinyllama-1.1b (all 22
#: layers, bf16, remat on) at the launcher's batch 8 x seq 64
MESH_ARCH = "tinyllama-1.1b"
MESH_STEPS = 4
MESH_SHAPE = (2, 2)
#: card against CPU in f32 at `LM_CUT_LAYERS` layers on the 2x2 mesh:
#: arch -> (the config's changes, batch, seq)
MESH_CARD_VS_CPU = {
    "tinyllama-1.1b": ({}, 4, 32),
    "phi3.5-moe-42b-a6.6b": (dict(moe_impl="shard_map"), 2, 32),
    "qwen2.5-14b": (dict(head_pad_multiple=16), 4, 32)}
#: the card-against-CPU configs' other cuts, for the CPU's time: phi3.5's
#: 16 experts to 4 (2 a model rank; with 16 its CPU side took 200 s)
MESH_CPU_CUTS = {"phi3.5-moe-42b-a6.6b": dict(n_experts=4)}
#: qwen2.5-14b's padded layout at full width, padded against unpadded
MESH_PAD = ("qwen2.5-14b", 16, 8)  # (arch, head_pad_multiple, layers)


def forced_mesh(shape, device):
    """A forced mesh of ``device``, installed (`forcemesh.install`)."""
    from repro_torch.distributed import forcemesh

    return forcemesh.install(shape, device=device)


def mesh_resident(tensors: list, mesh) -> dict:
    """Bytes at each mesh coordinate: the blocks that live there, against
    what the specs give it (each leaf's elements over the product of the
    mesh axes its spec names, times its item size)."""
    import torch

    got, want = {}, {}
    for st in tensors:
        item = torch.empty((), dtype=st.dtype).element_size()
        cut = 1
        for axis in st.spec:
            for a in (axis if isinstance(axis, tuple) else (axis,)):
                if a is not None:
                    cut *= mesh.shape[a]
        for c, blk in st.blocks.items():
            key = str(list(c))
            got[key] = got.get(key, 0) + blk.numel() * blk.element_size()
            want[key] = want.get(key, 0) + int(np.prod(st.shape)) // cut \
                * item
    return dict(got=got, want=want)


def mesh_train_run(device, cfg, model, shape, batches, *,
                   profiled: bool) -> dict:
    """`build_train_step` (fsdp_tp) on a forced ``shape`` mesh of the
    card from ``model``'s weights: one step a batch; then one more step
    timed (CUDA events) and, when ``profiled``, one profiled; peak memory;
    resident bytes per coordinate against the specs; the seconds of each
    part."""
    import torch

    from repro_torch.distributed import context, sharding
    from repro_torch.launch import steps

    secs = {}
    t0 = time.perf_counter()
    mesh = forced_mesh(shape, device)
    try:
        fn, in_specs, _, opt = steps.build_train_step(cfg, mesh)
        params = sharding.shard_model(model, in_specs[0], mesh)
        state = [opt.init(params)]
        torch.cuda.synchronize()
        secs["place"] = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        losses = []
        for b in batches:
            _, state[0], met = fn(params, state[0], b)
            losses.append(float(met["loss"]))
        secs["train"] = time.perf_counter() - t0

        def one():
            return fn(params, state[0], batches[0])[2]["loss"]

        t0 = time.perf_counter()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        one()
        stop.record()
        stop.synchronize()
        step_ms = start.elapsed_time(stop)
        prof = profile(one, cpu=False) if profiled else None
        secs["timed"] = time.perf_counter() - t0
        tensors = list(sharding.sharded_tensors(params).values())
        resident = mesh_resident(
            tensors + list(state[0].mu.values()) + list(state[0].nu.values()),
            mesh)
        check(resident["got"] == resident["want"],
              f"mesh {shape}: resident bytes {resident}")
        return dict(shape=list(shape), losses=losses, step_ms=step_ms,
                    step_profile=prof, secs=secs,
                    peak_mem_bytes=torch.cuda.max_memory_allocated(device),
                    resident_bytes=resident["got"])
    finally:
        context.clear()


def mesh_full_width(device, smoke: bool = False) -> dict:
    """tinyllama-1.1b at full width (SMOKE for a CPU rehearsal) through
    `build_train_step` on 2x2 and on 1x1 from one seed, `MESH_STEPS`
    steps on one batch: losses finite, falling, and within 2^-5 of each
    other; `build_prefill_step` /
    `build_decode_step` on 2x2 against the unsharded `prefill` /
    `decode_step` within 2^-5 of the scale."""
    import gc

    import torch

    from repro_torch import configs
    from repro_torch.distributed import context, sharding
    from repro_torch.launch import steps, train
    from repro_torch.models import lm

    cfg = configs.get(MESH_ARCH, smoke=smoke)
    model = lm.init_params(0, cfg, device=device)
    # one batch seen every step: the loss falls from the first step (on
    # fresh random batches it rises over the first few steps)
    batches = [train.synthetic_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, 0,
                                     device=device)] * MESH_STEPS
    out = dict(arch=cfg.name, layers=cfg.n_layers, params=cfg.param_count(),
               batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=MESH_STEPS)
    runs = {}
    for shape in (MESH_SHAPE, (1, 1)):  # the 1x1 run a reference, untraced
        runs["x".join(map(str, shape))] = mesh_train_run(
            device, cfg, model, shape, batches, profiled=shape == MESH_SHAPE)
        gc.collect()
        torch.cuda.empty_cache()
    a, b = runs["2x2"]["losses"], runs["1x1"]["losses"]
    for name, ls in runs.items():
        check(bool(np.isfinite(ls["losses"]).all())
              and ls["losses"][-1] < ls["losses"][0],
              f"mesh {name}: losses {ls['losses']}")
    gap = max(abs(x - y) / abs(y) for x, y in zip(a, b))
    check(gap <= LM_BF16_REL, f"mesh 2x2 vs 1x1 losses {a} vs {b}")
    out.update(runs=runs, loss_gap_rel=gap)
    # serving on 2x2 against the unsharded model
    prompt = torch.randint(0, cfg.vocab, (LM_GROUP, LM_PLEN + 1),
                           generator=torch.Generator().manual_seed(3)).to(
        device)
    want, cache = lm.prefill(model, cfg, prompt[:, :-1], max_len=2 * LM_PLEN)
    want_d, _ = lm.decode_step(model, cfg, prompt[:, -1:], cache)
    del cache
    mesh = forced_mesh(MESH_SHAPE, device)
    try:
        pf, in_sp, _ = steps.build_prefill_step(
            cfg, mesh, max_len=2 * LM_PLEN,
            example_args=(model, prompt[:, :-1]))
        params = sharding.shard_model(model, in_sp[0], mesh)
        t0 = time.perf_counter()
        logits, cache = pf(params, prompt[:, :-1])
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        dc, _, _ = steps.build_decode_step(
            cfg, mesh, example_args=(model, prompt[:, -1:], cache))
        t0 = time.perf_counter()
        step, cache = dc(params, prompt[:, -1:], cache)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
    finally:
        context.clear()
    errs = {}
    for name, got, ref in (("prefill", logits.full(), want),
                           ("decode", step.full(), want_d)):
        errs[name] = float((got.float() - ref.float()).abs().max()
                           / ref.float().abs().max())
        check(errs[name] <= LM_BF16_REL, f"mesh {name} logits: {errs[name]}")
    out.update(serve_rel_err=errs, prefill_s=prefill_s, decode_s=decode_s,
               cache_specs={f: list(getattr(cache, f).spec)
                            for f in lm.CACHE_FIELDS
                            if getattr(cache, f) is not None})
    del model, params
    return out


def mesh_grads(cfg, model, mesh, batch) -> tuple:
    """`steps.mesh_loss` with the backward on ``mesh``: (loss, each owner
    block's gradient by ``name@coord``)."""
    import torch

    from repro_torch.launch import steps
    from repro_torch.models import cnn
    from repro_torch.train import cnn_trainer

    owned = steps._owned(model)
    home = next(iter(owned.values())).device
    for blk in owned.values():
        blk.requires_grad_(True)
    try:
        with torch.enable_grad(), cnn.fp32(home), \
                cnn_trainer.deterministic(home):
            loss = steps.mesh_loss(model, cfg, mesh, steps._placed(
                batch, steps.sharding.batch_specs(cfg, mesh), mesh),
                backward=True)
        grads = {k: b.grad for k, b in owned.items()}
    finally:
        for blk in owned.values():
            blk.grad = None
            blk.requires_grad_(False)
    return loss, grads


def mesh_card_vs_cpu(device, arch: str, cfg=None) -> dict:
    """``arch`` at `LM_CUT_LAYERS` layers in f32 (TF32 off; `MESH_CPU_CUTS`)
    from one set of weights (drawn on the card, held on the CPU): the mesh
    step's loss and gradients on a forced 2x2 mesh of the card
    (`mesh_grads`) against the unsharded step on the CPU
    (`steps.value_and_grad`, which the CPU tests hold against JAX): the loss
    within 1e-5, every gradient within relative L2 `GRAD_RTOL` per JAX
    leaf (each owner block against its slice, compared on the card), the
    MoE routing ids of each layer's forward identical (the coordinates'
    calls in order make the CPU's one); then the card's mesh AdamW step
    (`steps._mesh_update`) from the CPU's gradients against the same
    AdamW on the CPU (`make_optimizer`, row chunks), within
    `TRAIN_STEP_REL` of each block's scale."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.distributed import context, sharding
    from repro_torch.launch import steps, train
    from repro_torch.models import lm

    changes, b, s = MESH_CARD_VS_CPU[arch]
    if cfg is None:
        cfg = dataclasses.replace(configs.get(arch), n_layers=LM_CUT_LAYERS,
                                  dtype=torch.float32, **changes,
                                  **MESH_CPU_CUTS.get(arch, {}))
    secs = {}
    t0 = time.perf_counter()
    model = lm.init_params(0, cfg, device=device).to("cpu")
    secs["init"] = time.perf_counter() - t0
    batch = train.synthetic_batch(cfg, b, s, 0, device="cpu")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        t0 = time.perf_counter()
        mesh = forced_mesh(MESH_SHAPE, device)
        try:
            _, in_specs, _, opt = steps.build_train_step(cfg, mesh)
            params = sharding.shard_model(model, in_specs[0], mesh)
            with routes_recorded() as card_routes:
                loss, grads = mesh_grads(cfg, params, mesh, {
                    k: v.to(device) for k, v in batch.items()})
        finally:
            context.clear()
        secs["grad_card"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        with routes_recorded() as cpu_routes:
            loss_cpu, g_cpu = steps.value_and_grad(model, cfg, batch)
        secs["grad_cpu"] = time.perf_counter() - t0
        # the forward's calls: the CPU's one a layer, the card's one a
        # coordinate and layer, coordinate-major
        moe_layers = len(cpu_routes) // 2
        n_coord = MESH_SHAPE[0]
        check(len(card_routes) == 2 * n_coord * moe_layers,
              f"{cfg.name} mesh: {len(card_routes)} routing calls")
        for layer in range(moe_layers):
            ids = torch.cat([card_routes[i * moe_layers + layer][0]
                             for i in range(n_coord)])
            check(torch.equal(ids, cpu_routes[layer][0]),
                  f"{cfg.name} mesh card vs CPU: layer {layer} routing ids "
                  "differ")
        loss_err = abs(float(loss) - float(loss_cpu))
        check(loss_err <= LM_RTOL * abs(float(loss_cpu)),
              f"{cfg.name} mesh: loss card {float(loss)} vs CPU "
              f"{float(loss_cpu)}")
        # the CPU's gradient cut into the owner blocks, on the card
        t0 = time.perf_counter()
        tensors = sharding.sharded_tensors(params)
        want = {f"{n}@{c}": g_cpu[n][idx].to(device)
                for n, st in tensors.items()
                for c, idx in st.owners().items()}
        grad_err = {}
        for leaf, names in leaf_groups(tensors).items():
            diff = torch.zeros((), dtype=torch.float64, device=device)
            norm = torch.zeros((), dtype=torch.float64, device=device)
            for n in names:
                for c in tensors[n].owners():
                    w = want[f"{n}@{c}"].double()
                    diff += (grads[f"{n}@{c}"].double() - w).square().sum()
                    norm += w.square().sum()
            grad_err[leaf] = float(diff.sqrt() / norm.sqrt().clamp_min(1e-30))
            check(grad_err[leaf] <= GRAD_RTOL, f"{cfg.name} mesh: gradient "
                  f"{leaf} rel L2 {grad_err[leaf]}")
        del grads
        secs["compare"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        state = opt.init(params)
        steps._mesh_update(opt, params, state, want)
        del want, state
        ref, cpu_p = steps.make_optimizer(cfg), dict(model.named_parameters())
        scale = torch.clamp(1.0 / (torch.sqrt(sum(
            torch.sum(torch.square(g_cpu[n][idx]))
            for n, st in tensors.items()
            for idx in st.owners().values())) + 1e-9), max=1.0)
        got = steps._owned(params)
        step_err = 0.0
        for n, st in tensors.items():
            for c, idx in st.owners().items():
                k = f"{n}@{c}"
                top = err = 0.0
                for g, q, d in zip(*map(row_chunks, (
                        g_cpu[n][idx], cpu_p[n].detach()[idx], got[k]))):
                    w = ref.update({k: g * scale}, ref.init({k: q}),
                                   {k: q})[0][k].to(device)
                    top = max(top, float(w.abs().max()))
                    err = max(err, float((d - w).abs().max()))
                step_err = max(step_err, err / (top or 1.0))
        check(step_err <= TRAIN_STEP_REL, f"{cfg.name} mesh AdamW card vs "
              f"CPU {step_err} of the scale")
        del model, cpu_p, g_cpu
        secs["adamw"] = time.perf_counter() - t0
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return dict(arch=cfg.name, layers=cfg.n_layers, dtype="float32",
                changes={k: str(v) for k, v in changes.items()},
                n_experts=cfg.n_experts, batch=[b, s],
                mesh=list(MESH_SHAPE), loss_card=float(loss),
                loss_cpu=float(loss_cpu), loss_err=loss_err,
                grad_rel_l2_max=max(grad_err.values()),
                grad_rel_l2_worst=max(grad_err, key=grad_err.get),
                leaves=len(grad_err), routing_calls=len(card_routes),
                adamw_step_rel=step_err,
                padded_heads=list(lm.padded_heads(cfg)), secs=secs)


def mesh_head_padding(device, smoke: bool = False) -> dict:
    """qwen2.5-14b at full width (`MESH_PAD`: 8 of 48 layers, bf16),
    padded to a multiple of 16 heads, against the unpadded model from the
    same seed: forward logits within 2^-5 of the scale."""
    import dataclasses
    import gc

    import torch

    from repro_torch import configs
    from repro_torch.models import lm

    arch, multiple, layers = MESH_PAD
    base = configs.get(arch, smoke=smoke)
    if not smoke:
        base = dataclasses.replace(base, n_layers=layers)
    x = torch.randint(0, base.vocab, (2, 64),
                      generator=torch.Generator().manual_seed(5)).to(device)
    out = {}
    for name, cfg in (("unpadded", base), ("padded", dataclasses.replace(
            base, head_pad_multiple=multiple))):
        model = lm.init_params(0, cfg, device=device)
        with torch.no_grad():
            out[name], _ = lm.forward(model, cfg, x)
        del model
        gc.collect()
        torch.cuda.empty_cache()
    ref = out["unpadded"].float()
    err = float((out["padded"].float() - ref).abs().max() / ref.abs().max())
    check(err <= LM_BF16_REL, f"{arch} padded vs unpadded: {err}")
    cfg = dataclasses.replace(base, head_pad_multiple=multiple)
    return dict(arch=arch, layers=base.n_layers, multiple=multiple,
                heads=[base.n_heads, base.n_kv_heads],
                padded_heads=list(lm.padded_heads(cfg)),
                geometry=list(lm._pad_geom(cfg) or []), rel_err=err)


def mesh_remesh(device, tmp: Path) -> dict:
    """SMOKE `MESH_ARCH`: one step on a forced 2x2 mesh, checkpointed,
    `remesh_restore` onto 1x2: every logical leaf bit for bit, each in
    the 1x2 layout, and one more step there."""
    import torch

    from repro_torch import configs
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.convert import flatten_tree
    from repro_torch.distributed import context, sharding
    from repro_torch.ft import elastic
    from repro_torch.launch import steps, train
    from repro_torch.models import lm

    cfg = configs.get(MESH_ARCH, smoke=True)
    model = lm.init_params(0, cfg, device=device)
    mesh = forced_mesh(MESH_SHAPE, device)
    try:
        fn, in_specs, _, opt = steps.build_train_step(cfg, mesh)
        params = sharding.shard_model(model, in_specs[0], mesh)
        state = opt.init(params)
        _, state, _ = fn(params, state, train.synthetic_batch(
            cfg, 4, 16, 0, device=device))
        tree = {"params": sharding.model_tree(
            sharding.sharded_tensors(params), mesh),
            "opt": state._replace(mu=sharding.model_tree(state.mu, mesh),
                                  nu=sharding.model_tree(state.nu, mesh))}
        Checkpointer(tmp).save(1, tree)
    finally:
        context.clear()
    mesh = forced_mesh((1, 2), device)
    try:
        specs = sharding.param_specs(cfg, mesh)
        like = sharding.tree_map(
            lambda st: torch.empty(0), tree,
            is_leaf=lambda x: isinstance(x, sharding.ShardedTensor))
        got = elastic.remesh_restore(Checkpointer(tmp), 1, like, mesh, {
            "params": specs, "opt": sharding.opt_state_specs(specs)})
        def flat(t):
            return flatten_tree({"params": t["params"], "mu": t["opt"].mu,
                                 "nu": t["opt"].nu, "step": t["opt"].step})

        leaves = 0
        want = flat(tree)
        for k, st in flat(got).items():
            check(torch.equal(st.full(), want[k].full())
                  and st.mesh is mesh, f"remesh: leaf {k} differs")
            leaves += 1
        fn, in_specs, _, opt = steps.build_train_step(cfg, mesh)
        new = sharding.shard_model(model, in_specs[0], mesh)
        sharding.load_tensors(new, sharding.untree(got["params"]))
        state = state._replace(step=got["opt"].step,
                               mu=sharding.untree(got["opt"].mu),
                               nu=sharding.untree(got["opt"].nu))
        _, state, met = fn(new, state, train.synthetic_batch(
            cfg, 4, 16, 1, device=device))
        check(bool(np.isfinite(float(met["loss"]))) and int(
            state.step.full()) == 2, "remesh: the step after restore")
    finally:
        context.clear()
    return dict(leaves=leaves, from_mesh=list(MESH_SHAPE), to_mesh=[1, 2],
                loss_after=float(met["loss"]))


def lm_mesh_phase(device, out_dir: Path, *, smoke: bool = False,
                  cut_cfgs=None) -> dict:
    """Phase 10: the LM zoo on forced meshes of the card
    (`mesh_full_width`, `mesh_card_vs_cpu` for each of
    `MESH_CARD_VS_CPU`, `mesh_head_padding`, `mesh_remesh`). ``smoke`` /
    ``cut_cfgs`` shrink the configs for a CPU rehearsal."""
    import gc

    import torch

    out = {"card_vs_cpu": {}}
    t0 = time.perf_counter()
    out["full_width"] = mesh_full_width(device, smoke=smoke)
    out["full_width"]["wall_s"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    for arch in MESH_CARD_VS_CPU:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats(device)
        r = mesh_card_vs_cpu(device, arch,
                             cut_cfgs[arch] if cut_cfgs else None)
        r.update(wall_s=time.perf_counter() - t0,
                 peak_mem_bytes=torch.cuda.max_memory_allocated(device))
        out["card_vs_cpu"][arch] = r
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["head_padding"] = mesh_head_padding(device, smoke=smoke)
    out["head_padding"]["wall_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["remesh"] = mesh_remesh(device, out_dir)
    out["remesh"]["wall_s"] = time.perf_counter() - t0
    return out


def print_lm_mesh(m: dict, card: str) -> None:
    fw = m["full_width"]
    for name, r in fw["runs"].items():
        p = r["step_profile"] or {}
        print(f"lm_mesh {fw['arch']} ({fw['layers']} layers, {fw['params']} "
              f"params, bf16, batch {fw['batch']} x seq {fw['seq']}) on a "
              f"forced {name} mesh ({card}): losses "
              f"{json.dumps(r['losses'])}; step {r['step_ms']:.3f} "
              f"ms a call (CUDA events), profiled wall {p.get('wall_ms')} "
              f"ms, device {p.get('device_ms')} ms, idle share "
              f"{p.get('idle_share')}, {p.get('device_events')} device "
              f"events; peak memory "
              f"{r['peak_mem_bytes'] / 2**30:.3f} GiB; resident bytes a "
              f"coordinate {json.dumps(r['resident_bytes'])}; seconds "
              f"{json.dumps({k: round(v, 2) for k, v in r['secs'].items()})}")
    print(f"lm_mesh 2x2 vs 1x1 losses: worst relative gap "
          f"{fw['loss_gap_rel']:.3e}; prefill {LM_GROUP} x {LM_PLEN} and a "
          f"decode step on 2x2 against the unsharded calls: "
          f"{json.dumps(fw['serve_rel_err'])} of the scale (prefill "
          f"{fw['prefill_s']:.3f} s, decode {fw['decode_s']:.3f} s; cache "
          f"specs {json.dumps(fw['cache_specs'])})")
    for r in m["card_vs_cpu"].values():
        print(f"lm_mesh card vs CPU {r['arch']} ({r['layers']} layers, "
              f"{r['n_experts']} experts, f32, TF32 off, "
              f"{json.dumps(r['changes'])}, heads "
              f"{r['padded_heads']}, batch {r['batch'][0]} x {r['batch'][1]} "
              f"on {r['mesh']}, {r['wall_s']:.1f} s): loss {r['loss_card']} "
              f"vs {r['loss_cpu']} (|diff| {r['loss_err']}); worst gradient "
              f"rel L2 {r['grad_rel_l2_max']:.3e} ({r['grad_rel_l2_worst']}; "
              f"{r['leaves']} leaves); routing ids equal in "
              f"{r['routing_calls']} calls; AdamW from the CPU's gradients "
              f"{r['adamw_step_rel']:.3e} of the scale; peak memory "
              f"{r['peak_mem_bytes'] / 2**30:.3f} GiB; seconds "
              f"{json.dumps({k: round(v, 2) for k, v in r['secs'].items()})}")
    h = m["head_padding"]
    print(f"lm_mesh head padding {h['arch']} ({h['layers']} layers, heads "
          f"{h['heads']} -> {h['padded_heads']}, geometry {h['geometry']}): "
          f"padded vs unpadded logits {h['rel_err']:.3e} of the scale")
    r = m["remesh"]
    print(f"lm_mesh remesh_restore {r['from_mesh']} -> {r['to_mesh']}: "
          f"{r['leaves']} leaves bit for bit, loss after {r['loss_after']}")


DRYRUN_CELLS = (("qwen3-1.7b", "train_4k", "multi"),
                *(("tinyllama-1.1b", s, "single") for s in (
                    "train_4k", "prefill_32k", "decode_32k", "long_500k")),
                ("mamba2-2.7b", "long_500k", "single"),
                ("phi3.5-moe-42b-a6.6b", "train_4k", "single"),
                ("deepseek-v3-671b", "decode_32k", "single"))
CENSUS_ARCH = "tinyllama-1.1b"
CENSUS_SEQ = 4096  # the layer and head probes' 1 x 4096
CENSUS_MEM_RTOL, CENSUS_MEM_ATOL = 0.10, 64 << 20
RECORD_BATCH, RECORD_SEQ = 8, 1024
RECORD_TEMP_RTOL = 0.15
CENSUS_ITERS = 5


def dryrun_cells(out_dir: Path, cells=DRYRUN_CELLS) -> dict:
    """`launch.dryrun.main` on each cell, its output checked for "all
    dry-run cells passed"; the records and the report's tables."""
    from repro_torch.analysis import report
    from repro_torch.launch import dryrun

    walls = {}
    for arch, shape, mesh in cells:
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            dryrun.main(["--arch", arch, "--shape", shape, "--mesh", mesh,
                         "--out", str(out_dir)])
        walls[f"{arch} x {shape} x {mesh}"] = time.perf_counter() - t0
        print(buf.getvalue(), end="")
        check("all dry-run cells passed" in buf.getvalue(),
              f"dry run {arch} x {shape} x {mesh}")
    recs = report.load(str(out_dir))
    check(any(r["arch"] == "qwen3-1.7b" and r["shape"] == "train_4k"
              and r["mesh"] == "pod2x16x16" for r in recs),
          "the two-pod qwen3-1.7b train_4k record")
    return dict(walls=walls, trace_s={
        f"{r['arch']} x {r['shape']} x {r['mesh']}": r["trace_s"]
        for r in recs}, tables={m: report.table(recs, m) for m in (
            "pod16x16", "pod2x16x16")},
        candidates=report.candidates(recs, "pod16x16"))


def card_operands(args: tuple, model, device) -> tuple:
    """A probe's meta ``args`` made real on ``device``: the module from
    ``model`` (its first layer, or the model for the head), random bf16
    / f32 activations and caches, random tokens and labels."""
    import torch

    gen = torch.Generator(device=device).manual_seed(7)
    vocab = model.unembed.w.shape[1]

    def real(x):
        if isinstance(x, dict):
            return {k: real(v) for k, v in x.items()}
        if not isinstance(x, torch.Tensor):
            return model.layers[0] if hasattr(x, "ln1") else model
        if x.dtype.is_floating_point:
            return torch.randn(x.shape, generator=gen, device=device,
                               dtype=torch.float32).to(x.dtype)
        return torch.randint(0, vocab, x.shape, generator=gen,
                             device=device, dtype=x.dtype)
    return tuple(real(x) for x in args)


def census_vs_card(device, smoke: bool = False) -> dict:
    """tinyllama-1.1b's probes (`CENSUS_ARCH`, full width; SMOKE for a
    CPU rehearsal) on a 1x1 mesh of the card under `FlopCounterMode`, and
    on meta under the census: product FLOPs equal, the card's peak over
    the call less what was resident before it within `CENSUS_MEM_RTOL` or
    `CENSUS_MEM_ATOL` of the census's peak live bytes; each probe timed
    (CUDA events) against its roofline bound."""
    import dataclasses
    import gc

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import configs
    from repro_torch.analysis import census, roofline
    from repro_torch.distributed import context
    from repro_torch.launch import dryrun, shapes, steps
    from repro_torch.models import lm

    cfg = configs.get(CENSUS_ARCH, smoke=smoke)
    seq = 64 if smoke else CENSUS_SEQ
    dec = shapes.SHAPES["decode_32k"]
    dec_batch, dec_seq = (2, 64) if smoke else (dec["batch"] // 16,
                                                dec["seq"])
    probes = {"layer_train_grad": (steps.build_layer_probe, dict(
                  kind="train", seq=seq, batch=1, with_grad=True)),
              "layer_decode": (steps.build_layer_probe, dict(
                  kind="decode", seq=dec_seq, batch=dec_batch,
                  with_grad=False)),
              "head_train_grad": (steps.build_embed_head_probe, dict(
                  kind="train", seq=seq, batch=1, with_grad=True))}
    # the dry run's counting probes: one query chunk, no remat
    pcfg = dataclasses.replace(cfg, q_chunk=seq, remat=False)
    model = lm.init_params(0, dataclasses.replace(cfg, n_layers=1),
                           device=device)
    out = {}
    for name, (build, kw) in probes.items():
        mode = "fsdp_tp" if kw["kind"] == "train" else dryrun.choose_mode(
            cfg, kw["kind"], dryrun.meta_mesh((1, 1)))
        mesh = forced_mesh((1, 1), device)
        try:
            fn, args, _ = build(pcfg, mesh, mode=mode, **kw)
            placed = fn.place(*card_operands(args, model, device))
            fn(*placed)  # warm: cuBLAS's workspace, the allocator's pools
            gc.collect()
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
            with FlopCounterMode(display=False) as fc:
                res = fn(*placed)
            torch.cuda.synchronize()
            card_peak = torch.cuda.max_memory_allocated(device) - before
            del res
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(CENSUS_ITERS):
                fn(*placed)
            stop.record()
            stop.synchronize()
            ms = start.elapsed_time(stop) / CENSUS_ITERS
            del placed
        finally:
            context.clear()
        mesh = dryrun.meta_mesh((1, 1))
        try:
            fn, args, _ = build(pcfg, mesh, mode=mode, **kw)
            placed = fn.place(*args)
            with census.Census() as c:
                fn(*placed)
        finally:
            context.clear()
        card_flops = fc.get_total_flops()
        check(card_flops == c.flops(),
              f"census {name}: FLOPs card {card_flops} vs meta {c.flops()}")
        gap = abs(card_peak - c.peak_bytes)
        check(gap <= max(CENSUS_MEM_RTOL * c.peak_bytes, CENSUS_MEM_ATOL),
              f"census {name}: card peak {card_peak} B vs census "
              f"{c.peak_bytes} B")
        bound = roofline.Roofline(c.flops(), c.bytes(), 0.0, 1, 0.0)
        out[name] = dict(kw, flops=card_flops, census_bytes=c.bytes(),
                         card_peak_bytes=card_peak,
                         census_peak_bytes=c.peak_bytes, ms=ms,
                         bound_ms=bound.t_bound * 1e3,
                         bound_by=bound.dominant,
                         share=bound.t_bound * 1e3 / ms)
        gc.collect()
        torch.cuda.empty_cache()
    return out


def record_vs_card(device, smoke: bool = False) -> dict:
    """`launch.dryrun.cell_record` for tinyllama-1.1b train at
    `RECORD_BATCH` x `RECORD_SEQ` (full width; SMOKE for a CPU rehearsal)
    on meta meshes 1x1 and 2x2, against `build_train_step` on forced
    meshes of the card of the same shapes: ``argument_bytes`` equal to
    the largest coordinate's resident blocks (parameters, both moments,
    the step counter) plus its batch rows; ``temp_bytes`` times the data
    coordinates (the one card runs them all, each holding what one device
    of a real mesh would) within `RECORD_TEMP_RTOL` of the card's peak
    over a step less what was resident before it."""
    import gc

    import torch

    from repro_torch import configs
    from repro_torch.distributed import context, sharding
    from repro_torch.launch import dryrun, shapes, steps, train
    from repro_torch.models import lm

    cfg = configs.get(CENSUS_ARCH, smoke=smoke)
    b, s = (4, 32) if smoke else (RECORD_BATCH, RECORD_SEQ)
    spec = shapes.CellSpecs("train", ({
        "inputs": torch.empty((b, s), dtype=torch.int32, device="meta"),
        "labels": torch.empty((b, s), dtype=torch.int32, device="meta")},),
        s, b)
    model = lm.init_params(0, cfg, device=device)
    batch = train.synthetic_batch(cfg, b, s, 0, device=device)
    out = {}
    for shape in ((1, 1), (2, 2)):
        t0 = time.perf_counter()
        rec, _ = dryrun.cell_record(cfg, spec, dryrun.meta_mesh(shape))
        record_s = time.perf_counter() - t0
        mesh = forced_mesh(shape, device)
        try:
            fn, in_specs, _, opt = steps.build_train_step(
                cfg, mesh, example_batch=batch)
            params = sharding.shard_model(model, in_specs[0], mesh)
            state = opt.init(params)
            resident = mesh_resident(
                [*sharding.sharded_tensors(params).values(),
                 *state.mu.values(), *state.nu.values(), state.step], mesh)
            rows = sharding.place(batch, sharding.to_shardings(
                in_specs[2], mesh))
            args = dict(resident["got"])
            for st in rows.values():
                for c, n in st.nbytes().items():
                    args[str(list(c))] += n
            del rows
            fn(params, state, batch)  # warm: cuBLAS's workspace
            gc.collect()
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
            fn(params, state, batch)
            torch.cuda.synchronize()
            card_temp = torch.cuda.max_memory_allocated(device) - before
            del params, state
        finally:
            context.clear()
        mem = rec["memory"]
        want = shape[0] * mem["temp_bytes"]
        name = "x".join(map(str, shape))
        check(max(args.values()) == mem["argument_bytes"],
              f"record {name}: argument bytes {mem['argument_bytes']} vs "
              f"the card's {args}")
        check(abs(card_temp - want) <= RECORD_TEMP_RTOL * want,
              f"record {name}: temp {want} B vs the card's {card_temp} B")
        out[name] = dict(argument_bytes=mem["argument_bytes"],
                         card_argument_bytes=args,
                         temp_bytes=mem["temp_bytes"],
                         temp_parts=mem["temp_parts"], temp_want=want,
                         card_temp_bytes=card_temp,
                         temp_rel=card_temp / want - 1, record_s=record_s,
                         trace_s=rec["trace_s"])
        gc.collect()
        torch.cuda.empty_cache()
    return out


def dryrun_phase(device, out_dir: Path, *, smoke: bool = False,
                 cells=DRYRUN_CELLS) -> dict:
    """Phase 11: the dry run on meta (`dryrun_cells`), the census against
    the card (`census_vs_card`), the memory record against the card
    (`record_vs_card`), each part's seconds. ``smoke`` / ``cells`` shrink
    it for a CPU rehearsal."""
    out = {}
    t0 = time.perf_counter()
    out["cells"] = dryrun_cells(out_dir, cells)
    out["cells"]["wall_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["census"] = census_vs_card(device, smoke=smoke)
    out["census_wall_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["record"] = record_vs_card(device, smoke=smoke)
    out["record_wall_s"] = time.perf_counter() - t0
    return out


def print_dryrun(d: dict, card: str) -> None:
    cells = d["cells"]
    print(f"dryrun: {len(cells['walls'])} cells on meta in "
          f"{cells['wall_s']:.1f} s (wall per cell "
          f"{json.dumps({k: round(v, 1) for k, v in cells['walls'].items()})}"
          f"; trace_s {json.dumps(cells['trace_s'])})")
    for mesh, table in cells["tables"].items():
        print(f"dryrun report {mesh} (analysis: the H100 roofline's "
              f"rates, not measurements):\n{table}")
    print(f"dryrun hillclimb candidates: {json.dumps(cells['candidates'])}")
    for name, r in d["census"].items():
        print(f"dryrun census {CENSUS_ARCH} {name} ({r['kind']}, batch "
              f"{r['batch']} x seq {r['seq']}, 1x1 mesh of {card}): "
              f"product FLOPs card {r['flops']} = meta; peak over the call "
              f"card {r['card_peak_bytes']} B vs census "
              f"{r['census_peak_bytes']} B; {r['ms']:.3f} ms a call (CUDA "
              f"events) against a {r['bound_by']} bound of "
              f"{r['bound_ms']:.3f} ms (census bytes {r['census_bytes']}): "
              f"share {r['share']:.3f}")
    for name, r in d["record"].items():
        print(f"dryrun record {CENSUS_ARCH} train {RECORD_BATCH} x "
              f"{RECORD_SEQ} on {name} ({card}): argument bytes "
              f"{r['argument_bytes']} = the card's largest coordinate "
              f"({json.dumps(r['card_argument_bytes'])}); temp "
              f"{r['temp_bytes']} B a coordinate "
              f"({json.dumps(r['temp_parts'])}), {r['temp_want']} B for "
              f"the card vs the card's {r['card_temp_bytes']} B "
              f"({r['temp_rel']:+.3%}); record {r['record_s']:.1f} s")


def main(argv: list[str]) -> int:
    import argparse

    start = time.perf_counter()
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
    for source in (MATCH_SRC, SIM_SRC, KD_SRC, FA_SRC, EPI_SRC, MLA_SRC):
        if not (ROOT / source).is_file():
            print(f"chip_smoke: {source} not found beside this script",
                  file=sys.stderr)
            return 2
    if HBM_BW is None:
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
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

    t0 = time.perf_counter()
    kernels = kernel_phase(device)
    kernels.update(similarity_phase(device))
    kernels.update(kd_phase(device))
    kernels.update(fa_phase(device))
    epilogue = epilogue_phase(device)
    mla = mla_phase(device)
    kernels_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    report = paths(device)
    check(report["predict"]["features"] == N, "paper width: 784 features")
    trained, training, student = training_paths(device)
    report.update(trained)
    report.update(attention_path(device))
    report["device_physics"] = device_physics(device)
    paths_s = time.perf_counter() - t0
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
    t0 = time.perf_counter()
    driven, sharded = sharded_phase(device)
    sharded["wall_s"] = time.perf_counter() - t0
    report.update(driven)
    t0 = time.perf_counter()
    driven, lm_out = lm_phase(device)
    lm_out["wall_s"] = time.perf_counter() - t0
    report.update(driven)
    train_dir = Path(scratch.name) / "lm_train"
    train_dir.mkdir()
    t0 = time.perf_counter()
    driven, lm_train = lm_train_phase(device, train_dir)
    lm_train["wall_s"] = time.perf_counter() - t0
    report.update(driven)
    mesh_dir = Path(scratch.name) / "lm_mesh"
    mesh_dir.mkdir()
    t0 = time.perf_counter()
    lm_mesh = lm_mesh_phase(device, mesh_dir)
    lm_mesh["wall_s"] = time.perf_counter() - t0
    dry_dir = (report_path.parent / "dryrun" if report_path
               else Path(scratch.name) / "dryrun")
    t0 = time.perf_counter()
    dry = dryrun_phase(device, dry_dir)
    dry["wall_s"] = time.perf_counter() - t0
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
    print_epilogue(epilogue)
    print_mla(mla)
    print(f"profile sessions retried: {json.dumps(PROFILE_RETRIES)}")
    print_device_physics(report["device_physics"], report["serve_mega"])
    print_paper_eval(paper)
    print_control_plane(control, smi)
    print_sharded(sharded, smi)
    print_lm(lm_out, smi)
    print_lm_train(lm_train, smi)
    print_lm_mesh(lm_mesh, smi)
    print_dryrun(dry, smi)
    print(f"phase walls: build {build_s:.1f} s, kernels {kernels_s:.1f} s, "
          f"paths {paths_s:.1f} s, paper_eval {paper['wall_s']:.1f} s, "
          f"control_plane "
          f"{control['wall_s']:.1f} s, sharded {sharded['wall_s']:.1f} s, lm "
          f"{lm_out['wall_s']:.1f} s, lm_train {lm_train['wall_s']:.1f} s, "
          f"lm_mesh {lm_mesh['wall_s']:.1f} s, dryrun {dry['wall_s']:.1f} s; "
          f"all {time.perf_counter() - start:.1f} s")
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
            dict(card=smi, build_s=build_s, kernels_s=kernels_s,
                 paths_s=paths_s, nvcc=logs,
                 kernels=line["kernels"], kernel_phases=kernels,
                 student_epilogue=epilogue, mla_prefill=mla,
                 profile_retries=PROFILE_RETRIES,
                 paths=report, training=training, paper_eval=paper,
                 control_plane=control, sharded=sharded, lm=lm_out,
                 lm_train=lm_train, lm_mesh=lm_mesh, dryrun=dry),
            indent=1, default=str))
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    scratch.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
