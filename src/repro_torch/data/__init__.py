"""The training data: the synthetic CIFAR-10-like dataset and its batch
pipeline (numpy, bit-identical to the JAX package's)."""
