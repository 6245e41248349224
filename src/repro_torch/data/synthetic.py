"""Deterministic synthetic classification data (numpy, host side).

Port of ``repro/data/synthetic.py::synthetic_classification``: the same
numpy calls in the same order, so a seed gives byte-identical arrays in
both packages.
"""
from __future__ import annotations

import numpy as np


def synthetic_classification(
    n: int, num_classes: int, image_shape=(28, 28, 1), seed: int = 0,
    noise: float = 0.35,
):
    """Gaussian-mixture images: class c has a fixed random template + noise."""
    rng = np.random.default_rng(seed)
    templates = rng.normal(size=(num_classes,) + image_shape).astype(np.float32)
    labels = rng.integers(0, num_classes, size=n, dtype=np.int32)
    x = templates[labels] + noise * rng.normal(size=(n,) + image_shape).astype(np.float32)
    return x.astype(np.float32), labels
