"""ACAM feature-count classify kernels (paper Eq. 8 + Eq. 12), four faces.

Each face keeps the signature of its Pallas TPU counterpart in
`repro/kernels/acam_match/acam_match.py` (K-major ``(K * Cp, N)`` or
``(K, Cp, N)`` template operands, ``num_classes``, ``chunk``) and comes in
two versions in this module:

  * a **plain PyTorch** version (``*_plain``): binarise, the bipolar count
    ``(N + Q~ . T~^T) / 2`` (exact: +/-1 products summed in f32), the valid
    mask, the per-class max over K, and the `layout` epilogues;
  * a **CUDA wrapper** (the un-suffixed name) over `csrc/acam_match.cu`.

The wrapper takes the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises. Each launch adds one to its face's
entry in `LAUNCHES`, so a run can show that its main path went through the
kernels.

    face                                  TPU kernel replaced (acam_match.py)
    acam_match_classify                   _classify_kernel                  B1
    acam_match_classify_margins           _classify_margins_kernel          B4
    acam_match_classify_margins_chunked   _classify_margins_chunked_kernel  B2
    acam_match_serve                      _serve_kernel                     B3

Templates must be {0, 1} (every producer binarises them). The chunked faces
accept ``chunk`` for signature parity; on the card it changes nothing.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, layout

#: kernel launches per face since the last `reset_launches()`
LAUNCHES = {"acam_match_classify": 0, "acam_match_classify_margins": 0,
            "acam_match_classify_margins_chunked": 0, "acam_match_serve": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path and the card's yardstick)
# ---------------------------------------------------------------------------

def _counts(q: torch.Tensor, templates: torch.Tensor) -> torch.Tensor:
    """(B, M) match counts of bool queries (B, N) against {0,1} templates
    (M, N): +/-1 products sum to integers, exact in f32 below 2**24."""
    q_pm = q.to(torch.float32) * 2.0 - 1.0
    t_pm = templates.to(torch.float32) * 2.0 - 1.0
    return (q_pm @ t_pm.T + q.shape[-1]) * 0.5


def _margins_plain(q, templates_kmajor, valid_row, class_lo, class_hi,
                   num_classes):
    cp = layout.padded_classes(num_classes)
    scores = _counts(q, templates_kmajor)
    per_class, _ = layout.wta_epilogue(scores, valid_row[None, :], cp,
                                       templates_kmajor.shape[0] // cp)
    pred, margin = layout.windowed_margin(
        per_class, class_lo.to(torch.int32)[:, None],
        class_hi.to(torch.int32)[:, None], float(q.shape[-1]))
    return pred, per_class[:, :num_classes], margin


def classify_plain(features, thresholds, templates_kmajor, valid_row,
                   num_classes):
    cp = layout.padded_classes(num_classes)
    scores = _counts(features > thresholds, templates_kmajor)
    per_class, pred = layout.wta_epilogue(scores, valid_row[None, :], cp,
                                          templates_kmajor.shape[0] // cp)
    return pred, per_class[:, :num_classes]


def classify_margins_plain(features, thresholds, templates_kmajor, valid_row,
                           class_lo, class_hi, num_classes):
    return _margins_plain(features > thresholds, templates_kmajor, valid_row,
                          class_lo, class_hi, num_classes)


def classify_margins_chunked_plain(features, thresholds, templates_kcp,
                                   valid_kcp, class_lo, class_hi, num_classes,
                                   *, chunk):
    _check_chunk(templates_kcp.shape[1], chunk)
    return _margins_plain(features > thresholds,
                          templates_kcp.reshape(-1, templates_kcp.shape[-1]),
                          valid_kcp.reshape(-1), class_lo, class_hi,
                          num_classes)


def _slot_thresholds(thr_table, tenant_slot):
    """Each row's threshold row; a slot outside the table reads zeros, as
    the TPU kernel's one-hot select does."""
    t = thr_table.shape[0]
    slot = tenant_slot.to(torch.int64)
    inside = (slot >= 0) & (slot < t)
    rows = thr_table[slot.clamp(0, t - 1)]
    return torch.where(inside[:, None], rows, torch.zeros_like(rows))


def serve_plain(features, thr_table, tenant_slot, templates_kcp, valid_kcp,
                class_lo, class_hi, tau, num_classes, *, chunk):
    _check_chunk(templates_kcp.shape[1], chunk)
    q = (features - _slot_thresholds(thr_table, tenant_slot)) > 0
    pred, per_class, margin = _margins_plain(
        q, templates_kcp.reshape(-1, templates_kcp.shape[-1]),
        valid_kcp.reshape(-1), class_lo, class_hi, num_classes)
    return pred, per_class, margin, margin < tau


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # f, thr, t, valid, B, N, K, Cp, C, qbits, tbits, pred, per_class, stream
    "acam_match_classify": [_P] * 4 + [_I] * 5 + [_P] * 5,
    # f, thr, t, valid, lo, hi, B, N, K, Cp, C, qbits, tbits, pred,
    # per_class, margin, stream
    "acam_match_classify_margins": [_P] * 6 + [_I] * 5 + [_P] * 6,
    # as margins, with chunk after C
    "acam_match_classify_margins_chunked": [_P] * 6 + [_I] * 6 + [_P] * 6,
    # f, thr_table, thr_rows, slot, t, valid, lo, hi, tau, B, N, K, Cp, C,
    # chunk, qbits, tbits, pred, per_class, margin, esc, stream
    "acam_match_serve": [_P, _P, _I] + [_P] * 6 + [_I] * 6 + [_P] * 7,
}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("acam_match")
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _check_chunk(cp: int, chunk: int) -> None:
    if chunk < 1 or cp % chunk:
        raise ValueError(f"chunk={chunk} must divide the padded class "
                         f"count {cp}")


def _check(name: str, x: torch.Tensor, device: torch.device,
           dtype: torch.dtype, shape: tuple[int, ...]) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} is {x.dtype}, expected {dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _kernel_operands(features, templates, num_classes):
    """Validate the shared operands; allocate outputs and bit scratch."""
    device = features.device
    if device.type != "cuda":
        raise ValueError(f"features on {device}: the kernels take CUDA or "
                         "CPU tensors")
    b, n = features.shape
    cp = layout.padded_classes(num_classes)
    rows = templates.numel() // max(n, 1)
    if n < 1 or rows % cp or rows == 0:
        raise ValueError(f"templates {tuple(templates.shape)} are not a "
                         f"K-major bank of {num_classes} classes over {n} "
                         "features")
    _check("features", features, device, torch.float32, (b, n))
    w = -(-n // 32)
    return dict(
        b=b, n=n, k=rows // cp, cp=cp, device=device,
        qbits=torch.empty(b * w, dtype=torch.int32, device=device),
        tbits=torch.empty(rows * w, dtype=torch.int32, device=device),
        pred=torch.empty(b, dtype=torch.int32, device=device),
        per_class=torch.empty((b, num_classes), dtype=torch.float32,
                              device=device),
        margin=torch.empty(b, dtype=torch.float32, device=device))


def _run(name: str, device: torch.device, *args) -> None:
    """Launch a face on ``device``'s current stream (tensors pass as their
    device pointers); raise on a CUDA error."""
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        rc = getattr(_lib(), name)(
            *args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
    LAUNCHES[name] += 1


def acam_match_classify(features, thresholds, templates_kmajor, valid_row,
                        num_classes: int):
    """Fused Eq. 8 + Eq. 12 from raw features to the WTA (B1).

    features (B, N) f32, thresholds (N,), templates_kmajor (K * Cp, N)
    {0,1}, valid_row (K * Cp,) f32 {0,1}. Returns (pred (B,) int32,
    per_class (B, C) f32).
    """
    if features.device.type == "cpu":
        return classify_plain(features, thresholds, templates_kmajor,
                              valid_row, num_classes)
    o = _kernel_operands(features, templates_kmajor, num_classes)
    rows = o["k"] * o["cp"]
    _check("thresholds", thresholds, o["device"], torch.float32, (o["n"],))
    _check("templates_kmajor", templates_kmajor, o["device"], torch.float32,
           (rows, o["n"]))
    _check("valid_row", valid_row, o["device"], torch.float32, (rows,))
    if o["b"]:
        _run("acam_match_classify", o["device"], features, thresholds,
             templates_kmajor, valid_row, o["b"], o["n"], o["k"], o["cp"],
             num_classes, o["qbits"], o["tbits"], o["pred"], o["per_class"])
    return o["pred"], o["per_class"]


def acam_match_classify_margins(features, thresholds, templates_kmajor,
                                valid_row, class_lo, class_hi,
                                num_classes: int):
    """B1 plus per-row class windows [class_lo, class_hi) and the Eq. 12
    winner-vs-runner-up margin clamped to N (B4). Returns (pred, per_class,
    margin (B,) f32)."""
    if features.device.type == "cpu":
        return classify_margins_plain(features, thresholds, templates_kmajor,
                                      valid_row, class_lo, class_hi,
                                      num_classes)
    o = _kernel_operands(features, templates_kmajor, num_classes)
    rows = o["k"] * o["cp"]
    _check("thresholds", thresholds, o["device"], torch.float32, (o["n"],))
    _check("templates_kmajor", templates_kmajor, o["device"], torch.float32,
           (rows, o["n"]))
    _check("valid_row", valid_row, o["device"], torch.float32, (rows,))
    _check("class_lo", class_lo, o["device"], torch.int32, (o["b"],))
    _check("class_hi", class_hi, o["device"], torch.int32, (o["b"],))
    if o["b"]:
        _run("acam_match_classify_margins", o["device"], features,
             thresholds, templates_kmajor, valid_row, class_lo, class_hi,
             o["b"], o["n"], o["k"], o["cp"], num_classes, o["qbits"],
             o["tbits"], o["pred"], o["per_class"], o["margin"])
    return o["pred"], o["per_class"], o["margin"]


def acam_match_classify_margins_chunked(features, thresholds, templates_kcp,
                                        valid_kcp, class_lo, class_hi,
                                        num_classes: int, *, chunk: int):
    """B4 over a (K, Cp, N) stack, the big-bank face (B2). ``chunk`` must
    divide Cp; the outputs do not depend on it."""
    if features.device.type == "cpu":
        return classify_margins_chunked_plain(
            features, thresholds, templates_kcp, valid_kcp, class_lo,
            class_hi, num_classes, chunk=chunk)
    o = _kernel_operands(features, templates_kcp, num_classes)
    _check_chunk(o["cp"], chunk)
    _check("thresholds", thresholds, o["device"], torch.float32, (o["n"],))
    _check("templates_kcp", templates_kcp, o["device"], torch.float32,
           (o["k"], o["cp"], o["n"]))
    _check("valid_kcp", valid_kcp, o["device"], torch.float32,
           (o["k"], o["cp"]))
    _check("class_lo", class_lo, o["device"], torch.int32, (o["b"],))
    _check("class_hi", class_hi, o["device"], torch.int32, (o["b"],))
    if o["b"]:
        _run("acam_match_classify_margins_chunked", o["device"], features,
             thresholds, templates_kcp, valid_kcp, class_lo, class_hi,
             o["b"], o["n"], o["k"], o["cp"], num_classes, chunk, o["qbits"],
             o["tbits"], o["pred"], o["per_class"], o["margin"])
    return o["pred"], o["per_class"], o["margin"]


def acam_match_serve(features, thr_table, tenant_slot, templates_kcp,
                     valid_kcp, class_lo, class_hi, tau, num_classes: int, *,
                     chunk: int):
    """The serving tick (B3): per-slot threshold-row gather -> (f - thr) > 0
    -> match -> per-class max -> windowed margin -> escalate = margin < tau.

    features (B, N) f32 raw, thr_table (T, N) f32, tenant_slot (B,) int32,
    templates_kcp (K, Cp, N), valid_kcp (K, Cp), class_lo/hi (B,) int32,
    tau (B,) f32. Returns (pred, per_class, margin, escalate (B,) bool).
    """
    if features.device.type == "cpu":
        return serve_plain(features, thr_table, tenant_slot, templates_kcp,
                           valid_kcp, class_lo, class_hi, tau, num_classes,
                           chunk=chunk)
    o = _kernel_operands(features, templates_kcp, num_classes)
    _check_chunk(o["cp"], chunk)
    t_rows = thr_table.shape[0] if thr_table.dim() == 2 else -1
    _check("thr_table", thr_table, o["device"], torch.float32,
           (t_rows, o["n"]))
    _check("tenant_slot", tenant_slot, o["device"], torch.int32, (o["b"],))
    _check("templates_kcp", templates_kcp, o["device"], torch.float32,
           (o["k"], o["cp"], o["n"]))
    _check("valid_kcp", valid_kcp, o["device"], torch.float32,
           (o["k"], o["cp"]))
    _check("class_lo", class_lo, o["device"], torch.int32, (o["b"],))
    _check("class_hi", class_hi, o["device"], torch.int32, (o["b"],))
    _check("tau", tau, o["device"], torch.float32, (o["b"],))
    esc = torch.empty(o["b"], dtype=torch.bool, device=o["device"])
    if o["b"]:
        _run("acam_match_serve", o["device"], features, thr_table, t_rows,
             tenant_slot, templates_kcp, valid_kcp, class_lo, class_hi, tau,
             o["b"], o["n"], o["k"], o["cp"], num_classes, chunk, o["qbits"],
             o["tbits"], o["pred"], o["per_class"], o["margin"], esc)
    return o["pred"], o["per_class"], o["margin"], esc
