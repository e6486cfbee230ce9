"""Hand-written Hopper kernels (CUDA C++ in `repro_torch/csrc/`) with their
plain PyTorch versions and the layouts they share."""
