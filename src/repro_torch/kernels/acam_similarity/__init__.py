"""ACAM similarity matching (paper Eq. 9-11) + Eq. 12 WTA kernels."""
