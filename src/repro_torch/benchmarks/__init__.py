"""The paper's evaluation on the port: twins of the JAX package's
`benchmarks/` (Table I, Table II, Fig. 1, Fig. 6/7, the §V-D energy model,
the kernel bench and the `run` harness over them). Run them as modules,
``python -m repro_torch.benchmarks.run``; they import `torch` and
`repro_torch` only."""
