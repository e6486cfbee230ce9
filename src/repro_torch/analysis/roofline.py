"""Roofline model for one NVIDIA H100 SXM, the port's target: the JAX
package's `repro/analysis/roofline.py` (the same formulas and field
names) with the card's rates in place of the TPU's.

All inputs are PER-DEVICE quantities: one data coordinate's share as the
op census counts it (`repro_torch.analysis.census`), and the bytes it
receives from other coordinates.

    compute term    = flops_dev / 989e12 FLOP/s      [bf16 tensor cores]
    memory term     = bytes_dev / 3.35e12 B/s        [HBM3]
    collective term = coll_dev  / 450e9  B/s         [NVLink, each way]

Totals for MFU-style reporting multiply by `chips`.

The rates are an H100 SXM's published peaks at its 700 W power limit
(NVIDIA's data sheet, dense rates without sparsity); a card set below
700 W runs slower under load. NVLink joins the eight cards of one host;
a mesh of more than 8 cards crosses hosts, over a network these rates do
not give, so there the collective term is a lower bound. `hlo_flops_dev`
keeps the JAX field's name but counts products only (the census's FLOPs):
XLA's count also has the elementwise ops.

`FLOPS_BY_DTYPE` holds the other operand types' peaks for the bounds that
`chip_smoke.py` prints: fp16 at the bf16 rate, float32 outside the
tensor cores (TF32 is off in the port's f32 products).
"""
from __future__ import annotations

from typing import NamedTuple

PEAK_FLOPS = 989e12  # bf16 dense, per card
HBM_BW = 3.35e12  # B/s per card
LINK_BW = 450e9  # B/s per card, NVLink each way
#: dense peaks by operand type (``str(torch dtype)``)
FLOPS_BY_DTYPE = {"torch.bfloat16": PEAK_FLOPS, "torch.float16": PEAK_FLOPS,
                  "torch.float32": 67e12}


class Roofline(NamedTuple):
    flops_dev: float  # per-device product flops
    bytes_dev: float  # per-device bytes accessed
    coll_dev: float  # per-device collective bytes
    chips: int
    model_flops: float  # 6*N*D (train) / 2*N*D (decode/prefill), global

    @property
    def t_compute(self) -> float:
        return self.flops_dev / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_dev / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_dev / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        """Step-time lower bound if all three engines fully overlap."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_frac(self) -> float:
        """MODEL_FLOPS / total counted FLOPs — remat/dispatch waste
        diagnostic."""
        total = self.flops_dev * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu_bound(self) -> float:
        """MFU ceiling at the roofline: MODEL_FLOPS/(t_bound x chips x peak)."""
        denom = self.t_bound * self.chips * PEAK_FLOPS
        return self.model_flops / denom if denom else 0.0

    @property
    def roofline_frac(self) -> float:
        """How close the compute term is to the binding constraint — the
        perf 'score': 1.0 means compute-bound at the roofline."""
        return self.t_compute / self.t_bound if self.t_bound else 0.0

    def row(self) -> dict:
        return {
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "t_bound_s": self.t_bound,
            "model_flops": self.model_flops,
            "hlo_flops_dev": self.flops_dev,
            "hlo_bytes_dev": self.bytes_dev,
            "coll_bytes_dev": self.coll_dev,
            "useful_frac": self.useful_flops_frac,
            "mfu_bound": self.mfu_bound,
            "roofline_frac": self.roofline_frac,
        }


def model_flops(param_count: int, tokens: int, kind: str) -> float:
    """6*N*D for training, 2*N*D forward-only (prefill/decode)."""
    return (6.0 if kind == "train" else 2.0) * param_count * tokens
