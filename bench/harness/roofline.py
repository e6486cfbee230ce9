"""The yardstick's arithmetic: published H100 peaks, the operations of the
student's forward and of its training step, and the least time of the
ACAM classify kernel. Frozen here so that a change to the program cannot
change what it is measured against.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit
FP32_FLOPS = 67e12  # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15

#: the name of the ACAM classify kernel (B1, `csrc/acam_match.cu`) in a trace
ACAM_KERNEL = "tiled_kernel"


def student_conv_macs(cfg: dict) -> list[int]:
    """Multiply-accumulates of each of the Fig. 5 student's convolutions
    for one 32x32 image: 30x30 (VALID), 15x15, 7x7, 7x7 outputs."""
    f1, f2, f3, f4 = cfg["filters"]
    cin = cfg["in_channels"]
    return [30 * 30 * 9 * cin * f1, 15 * 15 * 9 * f1 * f2,
            7 * 7 * 9 * f2 * f3, 7 * 7 * 9 * f3 * f4]


def student_feature_flops(cfg: dict) -> int:
    """Operations of the front end's forward for one image (2 per MAC;
    24,810,624 MACs at the paper's sizes)."""
    return 2 * sum(student_conv_macs(cfg))


def student_step_flops(cfg: dict) -> int:
    """Operations of one training step for one image: the forward of the
    convolutions and the dense head, the weight gradient of each, and the
    input gradient of each but the first convolution (whose input, the
    image, takes none). 2 per MAC; elementwise work not counted."""
    convs = student_conv_macs(cfg)
    head = cfg["num_features"] * cfg["num_classes"]
    macs = sum(convs) + head  # forward
    macs += sum(convs) + head  # weight gradients
    macs += sum(convs[1:]) + head  # input gradients
    return 2 * macs


def acam_match_classify_bound(b: int, c: int, k: int, n: int
                              ) -> tuple[float, str, int]:
    """Least time in ms of one B1 call (``acam_match_classify``): the
    bytes it must move (features, the (C, K, N) templates and their valid
    flags, the thresholds, the (B,) predictions and the (B, C) per-class
    scores, each once) over HBM bandwidth, against its B*K*C*N cell matches
    at two int8 operations each. Returns (ms, what bounds it, bytes)."""
    nbytes = (b * n * 4 + k * c * n * 4 + k * c * 4 + b * 4 + b * c * 4
              + n * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * b * k * c * n / INT8_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes)
