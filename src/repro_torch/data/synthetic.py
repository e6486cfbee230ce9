"""Synthetic CIFAR-10-like dataset (offline substitute for CIFAR-10).

A numpy copy of the JAX package's `repro/data/synthetic.py`: the same seed
gives bit-identical images and labels in both packages.

The package assumes no CIFAR-10 download, so the paper's data substrate is
a *deterministic, procedurally generated* 10-class 32x32x3 image dataset
with CIFAR-like statistics:

  - each class is a generative program: an oriented sinusoidal texture
    (class-specific frequency/orientation band) + a class-conditioned shape
    mask (disc/square/stripe) at a random position/scale + a class-tinted
    colour field, corrupted with instance noise;
  - intra-class variability (random phase, position, scale, tint jitter)
    is large enough that k>1 template clustering is meaningful;
  - classes overlap enough that the task is non-trivial (a linear probe
    lands far below a small CNN, mirroring CIFAR's difficulty ordering).

Deterministic in (seed, split), so experiments are exactly reproducible.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

NUM_CLASSES = 10
IMAGE_SHAPE = (32, 32, 3)

CLASS_NAMES = [
    "airplane", "automobile", "bird", "cat", "deer",
    "dog", "frog", "horse", "ship", "truck",
]  # kept for report parity with the paper's CIFAR-10 framing


class Dataset(NamedTuple):
    images: np.ndarray  # (n, 32, 32, 3) float32 in [0, 1]
    labels: np.ndarray  # (n,) int32


def _class_params(c: int) -> dict:
    """Fixed per-class generative parameters."""
    rng = np.random.RandomState(1000 + c)
    return {
        # overlapping frequency bands so neighbouring classes confuse
        "freq": 1.5 + 0.35 * c + rng.uniform(-0.15, 0.15),
        "theta": (np.pi / NUM_CLASSES) * c + rng.uniform(-0.1, 0.1),
        "tint": rng.uniform(0.25, 0.95, size=3),
        "shape": c % 3,  # 0: disc, 1: square, 2: stripe
        "shape_gain": 0.45 + 0.03 * c,
    }


_PARAMS = [_class_params(c) for c in range(NUM_CLASSES)]


def _generate_class(c: int, n: int, rng: np.random.RandomState) -> np.ndarray:
    h, w, _ = IMAGE_SHAPE
    yy, xx = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w), indexing="ij")
    p = _PARAMS[c]

    phase = rng.uniform(0, 2 * np.pi, size=(n, 1, 1))
    theta = p["theta"] + rng.normal(0, 0.25, size=(n, 1, 1))
    freq = p["freq"] * (1 + rng.normal(0, 0.15, size=(n, 1, 1)))
    u = xx[None] * np.cos(theta) + yy[None] * np.sin(theta)
    texture = 0.5 + 0.5 * np.sin(2 * np.pi * freq * u + phase)  # (n, h, w)

    cx = rng.uniform(-0.5, 0.5, size=(n, 1, 1))
    cy = rng.uniform(-0.5, 0.5, size=(n, 1, 1))
    scale = rng.uniform(0.18, 0.55, size=(n, 1, 1))
    dx, dy = xx[None] - cx, yy[None] - cy
    if p["shape"] == 0:
        mask = (dx**2 + dy**2 < scale**2).astype(np.float32)
    elif p["shape"] == 1:
        mask = ((np.abs(dx) < scale) & (np.abs(dy) < scale)).astype(np.float32)
    else:
        mask = (np.abs(dx + dy) < 0.5 * scale).astype(np.float32)

    base = 0.55 * texture + p["shape_gain"] * mask  # (n, h, w)
    tint = p["tint"][None, None, None, :] * (
        1 + rng.normal(0, 0.22, size=(n, 1, 1, 3))
    )
    img = base[..., None] * tint
    # contrast/brightness jitter + occlusion patch + instance noise
    img = img * rng.uniform(0.6, 1.3, size=(n, 1, 1, 1)) + rng.uniform(
        -0.15, 0.15, size=(n, 1, 1, 1)
    )
    ox = rng.randint(0, w - 8, size=n)
    oy = rng.randint(0, h - 8, size=n)
    osz = rng.randint(4, 10, size=n)
    for i in range(n):  # small loop, vectorised inner assignment
        img[i, oy[i] : oy[i] + osz[i], ox[i] : ox[i] + osz[i], :] = rng.uniform(0, 1)
    img += rng.normal(0, 0.18, size=img.shape)  # instance noise
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def make_dataset(n_per_class: int, seed: int) -> Dataset:
    rng = np.random.RandomState(seed)
    images = np.concatenate(
        [_generate_class(c, n_per_class, rng) for c in range(NUM_CLASSES)], axis=0
    )
    labels = np.repeat(np.arange(NUM_CLASSES, dtype=np.int32), n_per_class)
    perm = rng.permutation(len(labels))
    return Dataset(images[perm], labels[perm])


def load(
    split: str = "train", *, n_per_class: int | None = None, seed: int = 0
) -> Dataset:
    """CIFAR-10-shaped splits: train 5000/class, test 1000/class by default."""
    if split == "train":
        return make_dataset(n_per_class or 5000, seed=seed)
    if split == "test":
        return make_dataset(n_per_class or 1000, seed=seed + 777)
    raise ValueError(f"unknown split {split}")


def to_grayscale(images: np.ndarray) -> np.ndarray:
    """The paper's §IV-A conversion: Y = .2989 R + .5870 G + .1140 B."""
    w = np.asarray([0.2989, 0.5870, 0.1140], dtype=np.float32)
    return (images @ w)[..., None]


def normalize(images: np.ndarray) -> np.ndarray:
    """Zero-mean/unit-std normalisation (paper: 'values are normalised')."""
    mu = images.mean()
    sd = images.std() + 1e-8
    return ((images - mu) / sd).astype(np.float32)
