"""Procedural MNIST-like digit dataset (MNIST itself is unavailable offline).

A numpy copy of ``repro/data/mnist_synth.py`` (the same images and labels
for a seed, array for array).  Seven-segment-style digits rendered at random
position/scale/thickness with noise, 32×32 grayscale, white-on-black — the
same input contract as the paper's §6 camera pipeline (invert + threshold
produces exactly this form).  Used to train LeNet-5 end to end before it is
fused, planned and emitted as C (`repro_torch.core.export_c`).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

# segments: (x0,y0,x1,y1) in a 3×5 box — A top, B tr, C br, D bottom, E bl,
# F tl, G middle
_SEGS = {
    "A": (0, 0, 2, 0), "B": (2, 0, 2, 2), "C": (2, 2, 2, 4),
    "D": (0, 4, 2, 4), "E": (0, 2, 0, 4), "F": (0, 0, 0, 2), "G": (0, 2, 2, 2),
}
_DIGIT_SEGS = {
    0: "ABCDEF", 1: "BC", 2: "ABGED", 3: "ABGCD", 4: "FGBC",
    5: "AFGCD", 6: "AFGEDC", 7: "ABC", 8: "ABCDEFG", 9: "ABCFGD",
}


def _render(digit: int, rng: np.random.Generator, size: int = 32) -> np.ndarray:
    img = np.zeros((size, size), np.float32)
    scale = rng.uniform(3.2, 4.6)
    ox = rng.uniform(4, max(size - 3 * scale - 4, 5))
    oy = rng.uniform(2, max(size - 5 * scale - 2, 3))
    thick = rng.integers(1, 3)
    for seg in _DIGIT_SEGS[digit]:
        x0, y0, x1, y1 = _SEGS[seg]
        n = int(6 * scale)
        xs = np.linspace(ox + x0 * scale, ox + x1 * scale, n)
        ys = np.linspace(oy + y0 * scale, oy + y1 * scale, n)
        # every (dx, dy) offset of the pen at once: (dx, dy, point)
        d = np.arange(-thick, thick + 1)
        xi = np.clip(xs[None, None, :] + d[:, None, None], 0, size - 1).astype(int)
        yi = np.clip(ys[None, None, :] + d[None, :, None], 0, size - 1).astype(int)
        img[yi, xi] = 1.0
    img += rng.normal(0, 0.08, img.shape).astype(np.float32)
    # the paper's threshold filter: dark pixels snapped to pure black
    img = np.clip(img, 0.0, 1.0)
    img[img < 100.0 / 255.0] = 0.0
    return img


def make_dataset(n: int, seed: int = 0, size: int = 32) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (images (N,1,size,size) float32 in [0,1], labels (N,) int32)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, n).astype(np.int32)
    imgs = np.stack([_render(int(d), rng, size) for d in labels])
    return imgs[:, None], labels
