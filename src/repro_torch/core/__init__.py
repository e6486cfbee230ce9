"""The paper's primary contribution: the hybrid CNN + ACAM classifier
(quant, templates, energy, the ACAM device config, hybrid)."""
