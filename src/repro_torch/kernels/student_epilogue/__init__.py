"""The Fig. 5 student's fused convolution epilogues (eval forward)."""
