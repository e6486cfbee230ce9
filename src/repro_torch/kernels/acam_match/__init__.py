"""ACAM feature-count matching (paper Eq. 8) + Eq. 12 WTA kernels."""
