"""The paper's primary contribution: the hybrid CNN + ACAM classifier
(quant, templates, energy, the ACAM device config, hybrid) and the
training-side compression of §II (distill, prune)."""
