"""Fused knowledge-distillation loss (paper Eq. 1-3) kernel (B8)."""
