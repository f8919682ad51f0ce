"""Synthetic stand-ins for MNIST / FashionMNIST / CIFAR10 (the port's own
numpy copy of `repro/data/synth.py`: same draws, equal arrays per seed).

The evaluation container is offline, so the paper's public datasets are not
available.  We generate statistically-matched classification tasks — same
input shapes, 10 classes, a train/val/test split mirroring the paper's
5000/5000 server split — built from per-class anisotropic Gaussian clusters
with inter-class overlap controlled by `difficulty`.  All of the paper's
*relative* phenomena (heterogeneity sensitivity, straggler noise, privacy
noise) are preserved because they are properties of the FL pipeline, not of
the image statistics.  Absolute accuracies differ from the paper.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

SHAPES = {
    "mnist": (784,),
    "fmnist": (784,),
    "cifar10": (32, 32, 3),
}
N_CLASSES = 10


class SynthDataset(NamedTuple):
    name: str
    x_train: np.ndarray
    y_train: np.ndarray
    x_val: np.ndarray      # held at the server (utility evaluation)
    y_val: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray

    @property
    def input_shape(self):
        return self.x_train.shape[1:]


def make_dataset(name: str = "mnist", *, n_train: int = 12000, n_val: int = 1000,
                 n_test: int = 1000, difficulty: float = 1.0,
                 seed: int = 0) -> SynthDataset:
    """Class-clustered Gaussian images.  Higher `difficulty` => more overlap."""
    if name not in SHAPES:
        raise ValueError(f"unknown dataset {name!r}; options {sorted(SHAPES)}")
    shape = SHAPES[name]
    dim = int(np.prod(shape))
    rng = np.random.default_rng(seed)

    # class prototypes: sparse localized "strokes" so an MLP/CNN can learn them
    protos = np.zeros((N_CLASSES, dim), np.float32)
    for c in range(N_CLASSES):
        support = rng.choice(dim, size=max(dim // 8, 8), replace=False)
        protos[c, support] = rng.normal(1.5, 0.5, size=support.size)

    def sample(n, rng):
        y = rng.integers(0, N_CLASSES, size=n)
        noise = rng.normal(0.0, 0.6 * difficulty, size=(n, dim)).astype(np.float32)
        x = protos[y] + noise
        # per-sample random brightness/shift, mimicking image nuisances
        x += rng.normal(0.0, 0.2, size=(n, 1)).astype(np.float32)
        return x.reshape((n,) + shape).astype(np.float32), y.astype(np.int32)

    x_tr, y_tr = sample(n_train, rng)
    x_va, y_va = sample(n_val, rng)
    x_te, y_te = sample(n_test, rng)
    return SynthDataset(name, x_tr, y_tr, x_va, y_va, x_te, y_te)
