"""The paper's primary contribution: the hybrid CNN + RRAM-CMOS ACAM
classifier.

Modules:
  distill   — knowledge distillation + curriculum (Eq. 1-4)
  prune     — polynomial-decay magnitude pruning (Eq. 5-7)
  quant     — 8-bit QAT + binary mean-threshold feature quantisation
  templates — template generation (§II-D-1)
  matching  — deprecated shims over `repro_torch.match` (Eq. 8-12)
  acam      — TXL-ACAM 6T4R / 3T1R behavioural device models (§III)
  energy    — Horowitz + Eq. 14 energy model (§V-D)
  hybrid    — the deployable hybrid classifier + ACAMHead
"""
from repro_torch.core import (acam, distill, energy, hybrid, matching, prune,
                              quant, templates)

__all__ = ["acam", "distill", "energy", "hybrid", "matching", "prune",
           "quant", "templates"]
