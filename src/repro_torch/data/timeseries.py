"""Synthetic structured time-series generators (UCR-archive stand-ins).

Numpy copies of the JAX package's generators, with identical outputs for
the same arguments. Each returns a float32 (m, d) array and an int32 label
vector (m,) for the downstream k-NN experiments.
"""

from __future__ import annotations

import numpy as np


def znormalize(x: np.ndarray, axis: int = -1, eps: float = 1e-8) -> np.ndarray:
    """Per-series z-normalization (standard UCR preprocessing)."""
    mu = x.mean(axis=axis, keepdims=True)
    sd = x.std(axis=axis, keepdims=True)
    return ((x - mu) / (sd + eps)).astype(np.float32)


def sinusoid_mixture(
    m: int,
    d: int,
    rank: int = 8,
    n_classes: int = 4,
    noise: float = 0.05,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Linear combinations of `rank` fixed sinusoids -> data matrix of rank ~rank.

    This is the generator used in the paper's scalability experiment (§4.3):
    "sampling linear combinations of sinusoids with random amplitude and phase
    shifts such that the intrinsic dimensionality remains fixed".
    """
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 1.0, d, dtype=np.float64)
    freqs = rng.uniform(1.0, 12.0, size=rank)
    phases = rng.uniform(0.0, 2 * np.pi, size=rank)
    basis = np.stack([np.sin(2 * np.pi * f * t + p) for f, p in zip(freqs, phases)])
    labels = rng.integers(0, n_classes, size=m)
    # class-conditioned amplitude means so k-NN retrieval is meaningful
    class_means = rng.normal(0.0, 1.0, size=(n_classes, rank))
    amps = class_means[labels] + 0.3 * rng.normal(size=(m, rank))
    x = amps @ basis + noise * rng.normal(size=(m, d))
    return znormalize(x), labels.astype(np.int32)


def ecg_like(
    m: int,
    d: int,
    n_classes: int = 5,
    noise: float = 0.05,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Quasi-periodic spike trains mimicking ECG heartbeats (highly structured).

    Each class has a characteristic beat morphology (QRS-like gaussian bumps);
    instances vary phase, rate, and baseline wander. Intrinsic dimensionality is
    low: a handful of morphology + phase factors explain most variance.
    """
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 1.0, d, dtype=np.float64)
    labels = rng.integers(0, n_classes, size=m)
    # per-class morphology: widths/heights/offsets of 3 bumps (P, QRS, T waves)
    widths = rng.uniform(0.01, 0.05, size=(n_classes, 3))
    heights = np.abs(rng.normal(1.0, 0.5, size=(n_classes, 3))) * np.array([0.3, 1.5, 0.5])
    offsets = np.array([0.18, 0.30, 0.55]) + rng.normal(0, 0.02, size=(n_classes, 3))
    x = np.empty((m, d), dtype=np.float64)
    period = rng.uniform(0.28, 0.40, size=m)  # beats per unit time vary by instance
    phase = rng.uniform(0.0, 1.0, size=m)
    for i in range(m):
        c = labels[i]
        sig = 0.15 * np.sin(2 * np.pi * (t + phase[i]))  # baseline wander
        # repeat the beat template at quasi-periodic positions
        pos = np.arange(-1.0, 2.0, period[i]) + phase[i] * period[i]
        for p0 in pos:
            for b in range(3):
                center = p0 + offsets[c, b] * period[i]
                sig += heights[c, b] * np.exp(-0.5 * ((t - center) / widths[c, b]) ** 2)
        x[i] = sig
    x += noise * rng.normal(size=(m, d))
    return znormalize(x), labels.astype(np.int32)


def mnist_like(
    m: int = 4096, side: int = 28, n_classes: int = 10, seed: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """Structured image-like data (§4.5 stand-in for MNIST): smooth class
    prototypes mixed through a small factor space, flattened to (m, d).

    Like real MNIST (whose PCA spectrum concentrates ~90% of variance in a
    few dozen components), instances live near a low-dimensional manifold:
    each image is a class prototype plus a few smooth deformation modes, with
    mild pixel noise — so sampling-based PCA has real structure to find."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, size=m)
    yy, xx = np.mgrid[0:side, 0:side].astype(np.float64) / side
    protos, modes = [], []
    for c in range(n_classes):
        cx, cy = rng.uniform(0.3, 0.7, size=2)
        sx, sy = rng.uniform(0.08, 0.22, size=2)
        theta = rng.uniform(0, np.pi)
        u = (xx - cx) * np.cos(theta) + (yy - cy) * np.sin(theta)
        v = -(xx - cx) * np.sin(theta) + (yy - cy) * np.cos(theta)
        protos.append(np.exp(-0.5 * ((u / sx) ** 2 + (v / sy) ** 2)))
    # shared smooth deformation modes (translation/scale/shear gradients)
    base = protos[0]
    for gx, gy in ((1, 0), (0, 1), (1, 1), (2, 0), (0, 2)):
        modes.append(np.sin(np.pi * gx * xx) * np.sin(np.pi * gy * yy))
    protos = np.stack(protos).reshape(n_classes, -1)
    modes = np.stack(modes).reshape(len(modes), -1)
    coeff = 0.25 * rng.normal(size=(m, len(modes)))
    x = protos[labels] + coeff @ modes
    x += 0.005 * rng.normal(size=x.shape)
    return znormalize(x), labels.astype(np.int32)
