"""Template-bank layouts shared by the fused ACAM classify kernels.

The bank is stored class-major ``(C, K, N)`` (class c, template k). The
kernels take it **K-major**: template row ``kk * Cp + c`` holds
``bank[c, kk]``, with C padded up to ``Cp`` (a multiple of 128, as in the
JAX package, so operands and tests compare like with like). ``(K * Cp, N)``
and ``(K, Cp, N)`` are the same bytes; the CUDA kernels read either. Padded
class columns and invalid templates carry ``valid = 0`` and score -inf.

`wta_epilogue` and `windowed_margin` are the plain PyTorch epilogues the
kernels reproduce exactly:

  * ties go to the lowest class index (`torch.argmax` returns the first
    maximal index, like `jnp.argmax`);
  * the runner-up excludes only the winner's position, so a tie elsewhere
    gives margin 0;
  * the margin is clamped at ``cap`` (N for feature counts);
  * an empty or all-invalid window gives pred 0 and margin 0.
"""
from __future__ import annotations

import torch

LANE = 128


def padded_classes(num_classes: int, lane: int = LANE) -> int:
    return -(-num_classes // lane) * lane


def stack_kcp(arr: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(C, K, N) -> (K, Cp, N), zero-padded: row [kk, c] = arr[c, kk]."""
    c, k, n = arr.shape
    if c != num_classes:
        raise ValueError(f"bank has {c} classes, expected {num_classes}")
    out = arr.new_zeros((k, padded_classes(c), n))
    out[:, :c] = arr.transpose(0, 1)
    return out


def flatten_kmajor(arr: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(C, K, N) -> (K * Cp, N), row kk*Cp + c = arr[c, kk], zero-padded."""
    out = stack_kcp(arr, num_classes)
    return out.reshape(-1, out.shape[-1])


def valid_kcp(valid: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(C, K) bool -> (K, Cp) float {0,1}; padded classes are invalid."""
    c, k = valid.shape
    if c != num_classes:
        raise ValueError(f"valid has {c} classes, expected {num_classes}")
    out = torch.zeros((k, padded_classes(c)), dtype=torch.float32,
                      device=valid.device)
    out[:, :c] = valid.transpose(0, 1).to(torch.float32)
    return out


def valid_kmajor(valid: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(C, K) bool -> (K * Cp,) float {0,1}; padded classes are invalid."""
    return valid_kcp(valid, num_classes).reshape(-1)


def class_chunk(cp: int, num_k: int, max_rows: int, lane: int = LANE) -> int:
    """Class columns per chunk of the chunked kernels: the largest
    lane-multiple divisor of ``Cp`` whose ``num_k * cc`` template rows fit
    ``max_rows``; ``lane`` when even one lane tile exceeds it. The CUDA
    kernels take it for signature parity; their outputs do not depend on it.
    """
    for units in range(cp // lane, 0, -1):
        cc = units * lane
        if cp % cc == 0 and num_k * cc <= max_rows:
            return cc
    return lane


def wta_epilogue(scores: torch.Tensor, valid_row: torch.Tensor, cp: int,
                 num_k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Valid mask -> Eq. 12 per-class max over the K class slices -> WTA.

    scores: (bm, K * Cp); valid_row: (1, K * Cp) float {0,1}.
    Returns (per_class (bm, Cp), pred (bm,) int32).
    """
    s = torch.where(valid_row > 0, scores,
                    torch.tensor(float("-inf"), device=scores.device))
    per_class = s.reshape(s.shape[0], num_k, cp).amax(dim=1)
    pred = torch.argmax(per_class, dim=-1).to(torch.int32)
    return per_class, pred


def windowed_margin(per_class: torch.Tensor, class_lo: torch.Tensor,
                    class_hi: torch.Tensor, cap: float
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Eq. 12 decision + winner-vs-runner-up margin inside a class window.

    per_class: (bm, Cp) scores (-inf for invalid/padded classes)
    class_lo/class_hi: (bm, 1) int32 window bounds per row
    Returns (pred (bm,) int32 global class index, margin (bm,) f32). Rows
    with an empty window get pred 0, margin 0.
    """
    bm, cp = per_class.shape
    neg = torch.tensor(float("-inf"), device=per_class.device)
    iota = torch.arange(cp, device=per_class.device)[None, :]
    win = (iota >= class_lo) & (iota < class_hi)
    s = torch.where(win, per_class, neg)
    top1 = s.amax(dim=-1)
    pred = torch.argmax(s, dim=-1).to(torch.int32)
    runner = torch.where(iota == pred[:, None], neg, s)
    # clamp the runner-up at (top1 - cap): bounds the margin and keeps the
    # subtraction finite when the window holds a single valid class
    top2 = torch.maximum(runner.amax(dim=-1), top1 - cap)
    margin = torch.where(torch.isfinite(top1), top1 - top2,
                         torch.zeros((), device=per_class.device))
    return pred, margin.to(torch.float32)
