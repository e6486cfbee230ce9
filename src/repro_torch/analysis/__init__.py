"""The dry run's analysis: the op census (`census`, the port's stand-in for
the JAX package's HLO reader), the H100 roofline (`roofline`) and the
report over the dry run's records (`report`)."""
