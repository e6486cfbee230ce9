"""`repro_torch` — the hybrid CNN + RRAM-CMOS ACAM classifier on PyTorch/CUDA.

A port of the JAX package `repro` to PyTorch, with every TPU kernel on the
ported path rewritten by hand in CUDA C++ for Hopper (`sm_90a`). The layout
and names mirror `repro` module for module, so each module's counterpart is
where a reader expects it:

    device.py                  resolve(device) — the card unless asked for the CPU
    convert.py                 JAX params / masks / banks (numpy) <-> port
    kernels/layout.py          template-bank layouts + the WTA / margin epilogues
    kernels/acam_match/        Eq. 8 + Eq. 12 kernels (B1-B4, B7a), ops, oracle
    kernels/acam_similarity/   Eq. 9-11 + Eq. 12 kernels (B5, B6, B7b)
    kernels/kd_loss/           the fused Eq. 1-3 distillation loss (B8)
    kernels/flash_attention/   attention forward, online softmax, GQA (B9)
    kernels/_build.py          nvcc build + ctypes loader for `csrc/*.cu`
    core/                      quant (STE), templates, energy, acam (the
                               §III device models), hybrid, distill (Eq.
                               1-4), prune (Eq. 5-7), matching (shims)
    match/                     EngineConfig, backends (reference, kernel,
                               device), MatchEngine
    models/cnn.py              the Fig. 5 student and the ResNet teacher
    models/layers.py           chunked_attention
    data/, optim/, train/      synthetic data + pipeline, AdamW/SGD, trainer
    serve/, launch/serve.py    registry, scheduler, spec, service, control
    obs/, ft/elastic.py        flight recorder, straggler monitor

The package imports `torch` and numpy only; it never imports `jax` or
`repro`. Entry points run on the card unless the caller passes
``device="cpu"``, which is what the tests do: on a CPU tensor every kernel
wrapper runs its plain PyTorch version.
"""
