"""`repro_torch` — the hybrid CNN + RRAM-CMOS ACAM classifier on PyTorch/CUDA.

A port of the JAX package `repro` to PyTorch, with every TPU kernel on the
ported path rewritten by hand in CUDA C++ for Hopper (`sm_90a`). The layout
and names mirror `repro` module for module, so each module's counterpart is
where a reader expects it:

    device.py                  resolve(device) — the card unless asked for the CPU
    convert.py                 JAX params / banks (as numpy) -> port modules
    kernels/layout.py          template-bank layouts + the WTA / margin epilogues
    kernels/acam_match/        Eq. 8 + Eq. 12 kernels (B1-B4), ops, oracle
    kernels/_build.py          nvcc build + ctypes loader for `csrc/*.cu`
    core/                      quant, templates, energy, acam config, hybrid
    match/                     EngineConfig, backends, MatchEngine
    models/cnn.py              the Fig. 5 student CNN
    serve/                     registry, scheduler, spec, service, control
    obs/, ft/elastic.py        flight recorder, straggler monitor

The package imports `torch` and numpy only; it never imports `jax` or
`repro`. Entry points run on the card unless the caller passes
``device="cpu"``, which is what the tests do: on a CPU tensor every kernel
wrapper runs its plain PyTorch version.
"""
