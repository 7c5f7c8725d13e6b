"""Synthetic phantoms (port of deepinv_tpu/datasets/phantoms.py): the
Shepp-Logan phantom, random circles and random ellipse phantoms, and their
datasets. Pure numpy: the items are numpy arrays, as the JAX package's are,
and the ellipse table is the port's own copy."""

from __future__ import annotations

import numpy as np

from .base import ImageDataset

__all__ = ["shepp_logan", "SheppLoganDataset", "RandomPhantomDataset", "random_circles",
           "random_shapes", "generate_random_phantom"]

# (intensity, a, b, x0, y0, phi_deg): the standard Shepp-Logan ellipses
_ELLIPSES = [
    (1.0, 0.69, 0.92, 0.0, 0.0, 0),
    (-0.8, 0.6624, 0.874, 0.0, -0.0184, 0),
    (-0.2, 0.11, 0.31, 0.22, 0.0, -18),
    (-0.2, 0.16, 0.41, -0.22, 0.0, 18),
    (0.1, 0.21, 0.25, 0.0, 0.35, 0),
    (0.1, 0.046, 0.046, 0.0, 0.1, 0),
    (0.1, 0.046, 0.046, 0.0, -0.1, 0),
    (0.1, 0.046, 0.023, -0.08, -0.605, 0),
    (0.1, 0.023, 0.023, 0.0, -0.606, 0),
    (0.1, 0.023, 0.046, 0.06, -0.605, 0),
]

def shepp_logan(size: int = 128, dtype=np.float32) -> np.ndarray:
    """Shepp-Logan phantom of shape (size, size) in [0, 1] (phantoms.py:26)."""
    y, x = np.mgrid[-1 : 1 : size * 1j, -1 : 1 : size * 1j]
    img = np.zeros((size, size), dtype)
    for A, a, b, x0, y0, phi in _ELLIPSES:
        th = np.deg2rad(phi)
        xr = (x - x0) * np.cos(th) + (y - y0) * np.sin(th)
        yr = -(x - x0) * np.sin(th) + (y - y0) * np.cos(th)
        img += A * ((xr / a) ** 2 + (yr / b) ** 2 <= 1)
    img = np.clip(img, 0, 1)
    return img.astype(dtype)

def random_circles(size: int = 64, n_circles: int = 5, seed: int = 0, channels: int = 1):
    """``(channels, size, size)`` image of random circles (phantoms.py:39)."""
    rng = np.random.RandomState(seed)
    img = np.zeros((channels, size, size), np.float32)
    y, x = np.mgrid[0:size, 0:size]
    for _ in range(n_circles):
        cx, cy = rng.randint(0, size, 2)
        r = rng.randint(size // 16, size // 4)
        val = rng.rand()
        mask = (x - cx) ** 2 + (y - cy) ** 2 <= r**2
        for c in range(channels):
            img[c][mask] = val
    return img

class SheppLoganDataset(ImageDataset):
    """Dataset of the Shepp-Logan phantom (phantoms.py:57).

    With ``length=1`` (the default) each item is the exact
    phantom repeated over ``n_data`` channels, shape ``(n_data, size,
    size)``. ``length>1`` is an extension: items beyond determinism get a
    small deterministic shift + intensity jitter so the set is usable as
    (diverse) training data without downloads.
    """

    def __init__(self, size: int = 128, n_data: int = 1, transform=None,
                 length: int = 1, channels: int = None, seed: int = 0):
        self.size = size
        self.n_data = channels if channels is not None else n_data
        self.transform = transform
        self.length = int(length)
        self.seed = seed

    def __len__(self):
        return self.length

    def __getitem__(self, i):
        base = shepp_logan(self.size)
        if self.length > 1:
            rng = np.random.RandomState(self.seed + i)
            shift = rng.randint(-self.size // 16, self.size // 16 + 1, 2)
            base = np.roll(base, shift, axis=(0, 1)) * (0.8 + 0.4 * rng.rand())
        x = np.repeat(base[None], self.n_data, axis=0).astype(np.float32)
        if self.transform is not None:
            x = self.transform(x)
        return x

def random_shapes(rng: np.random.RandomState, interior: bool = False):
    """Random ellipse parameters (phantoms.py:90):
    (intensity, a, b, x0, y0, theta)."""
    if interior:
        x0, y0 = rng.rand() - 0.5, rng.rand() - 0.5
    else:
        x0, y0 = 2 * rng.rand() - 1.0, 2 * rng.rand() - 1.0
    return ((rng.rand() - 0.5) * rng.exponential(0.4),
            rng.exponential() * 0.2, rng.exponential() * 0.2,
            x0, y0, rng.rand() * 2 * np.pi)

def generate_random_phantom(size: int, n_ellipse: int = 50,
                            interior: bool = False, rng=None) -> np.ndarray:
    """Random ellipse phantom in [0, 1] (phantoms.py:102), vectorised over
    the ellipses."""
    rng = rng or np.random.RandomState()
    n = rng.poisson(n_ellipse)
    y, x = np.mgrid[-1 : 1 : size * 1j, -1 : 1 : size * 1j]
    img = np.zeros((size, size), np.float32)
    if n:
        p = np.stack([random_shapes(rng, interior) for _ in range(n)])  # (n,6)
        a, b, c, x0, y0, th = (p[:, j, None, None] for j in range(6))
        xr = (x - x0) * np.cos(th) + (y - y0) * np.sin(th)
        yr = -(x - x0) * np.sin(th) + (y - y0) * np.cos(th)
        img = (a * (((xr / b) ** 2 + (yr / c) ** 2) <= 1)).sum(0)
    return np.clip(img, 0, 1).astype(np.float32)

class RandomPhantomDataset(ImageDataset):
    """Random ellipse phantoms made on the fly (phantoms.py:119), each item
    ``(n_data, size, size)``, deterministic per index (seeded)."""

    def __init__(self, length: int, size: int = 128, n_data: int = 1,
                 transform=None, seed: int = 0):
        self.size = size
        self.n_data = n_data
        self.transform = transform
        self.length = int(length)
        self.seed = seed

    def __len__(self):
        return self.length

    def __getitem__(self, i):
        rng = np.random.RandomState(self.seed * 100003 + i)
        x = np.stack([generate_random_phantom(self.size, rng=rng)
                      for _ in range(self.n_data)])
        if self.transform is not None:
            x = self.transform(x)
        return x
