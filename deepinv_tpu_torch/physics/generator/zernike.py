"""Zernike polynomials (port of deepinv_tpu/physics/generator/zernike.py):
:class:`Zernike` evaluates ``Z_n^m`` on tensors with Noll's RMS
normalisation and converts single indices (ANSI, Noll) to ``(n, m)``;
:func:`zernike_basis` is the grid-normalised host-side basis.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["zernike_basis", "noll_to_nm", "Zernike"]

# the standard aberration names (zernike.py:21)
_NAMES = {
    (0, 0): "Piston", (1, -1): "Vertical Tilt", (1, 1): "Horizontal Tilt",
    (2, -2): "Oblique Astigmatism", (2, 0): "Defocus", (2, 2): "Vertical Astigmatism",
    (3, -3): "Vertical Trefoil", (3, -1): "Vertical Coma", (3, 1): "Horizontal Coma",
    (3, 3): "Oblique Trefoil", (4, -4): "Oblique Quadrafoil",
    (4, -2): "Oblique Secondary Astigmatism", (4, 0): "Primary Spherical",
    (4, 2): "Vertical Secondary Astigmatism", (4, 4): "Vertical Quadrafoil",
    (6, 0): "Secondary Spherical",
}


def _radial_coefficients(n: int, m: int):
    """``(coefficient, power)`` of each term of the radial polynomial."""
    m_abs = abs(m)
    return [((-1) ** k * math.factorial(n - k)
             / (math.factorial(k) * math.factorial((n + m_abs) // 2 - k)
                * math.factorial((n - m_abs) // 2 - k)), n - 2 * k)
            for k in range((n - m_abs) // 2 + 1)]


class Zernike:
    r"""Zernike polynomials ``Z_n^m = N_n^m R_n^m(rho) cos/sin(m theta)``
    (zernike.py:40), with Noll's normalisation."""

    @staticmethod
    def get_name(n: int, m: int) -> str:
        """The aberration's standard name."""
        Zernike._validate(n, m)
        name = _NAMES.get((n, m))
        return f"Zernike(n = {n}, m = {m}) -- {name}" if name else f"Zernike(n={n}, m={m})"

    @staticmethod
    def normalization_constant(n: int, m: int) -> float:
        """``sqrt(n + 1)`` if ``m == 0``, else ``sqrt(2 n + 2)``."""
        return math.sqrt(n + 1) if m == 0 else math.sqrt(2 * (n + 1))

    @staticmethod
    def cartesian_evaluate(n: int, m: int, x, y, use_mask: bool = True):
        """``Z_n^m`` at Cartesian coordinates (tensors)."""
        Zernike._validate(n, m)
        return Zernike.polar_evaluate(n, m, torch.sqrt(x ** 2 + y ** 2), torch.atan2(y, x),
                                      use_mask)

    @staticmethod
    def polar_evaluate(n: int, m: int, rho, theta, use_mask: bool = True):
        """``Z_n^m`` at polar coordinates (tensors)."""
        Zernike._validate(n, m)
        R = torch.zeros_like(rho)
        for c, p in _radial_coefficients(n, m):
            R = R + c * rho ** p
        angular = torch.cos(m * theta) if m >= 0 else torch.sin(abs(m) * theta)
        Z = Zernike.normalization_constant(n, m) * R * angular
        return torch.where(rho > 1.0, torch.zeros_like(Z), Z) if use_mask else Z

    @staticmethod
    def _validate(n: int, m: int):
        if n < 0:
            raise ValueError(f"n must be >= 0. Got {n}.")
        if abs(m) > n:
            raise ValueError(f"|m| must be <= n. Got n={n}, m={m}.")
        if (n - abs(m)) % 2 != 0:
            raise ValueError(f"n - |m| must be even. Got n={n}, m={m}.")

    @staticmethod
    def index_conversion(index: int, *, convention: str = "ansi"):
        """A single index as ``(n, m)`` in the ANSI or Noll convention
        (zernike.py:110)."""
        if convention.lower() == "ansi":
            n = math.floor((2 * index + 0.25) ** 0.5 - 0.5)
            return n, 2 * index - n * (n + 2)
        if convention.lower() == "noll":
            if index < 1:
                raise ValueError("Noll index must be >= 1")
            n = math.floor((2 * (index - 1) + 0.25) ** 0.5 - 0.5)
            m = n % 2 + 2 * math.floor((index - n * (n + 1) / 2 - 1 + (n + 1) % 2) / 2)
            return n, m * (-1) ** index
        raise NotImplementedError("Only 'ANSI' and 'Noll' conventions are implemented.")


def noll_to_nm(j: int):
    """A Noll index as ``(n, m)``."""
    return Zernike.index_conversion(j, convention="noll")


def zernike_basis(n_modes: int = 10, grid_size: int = 31, radius: float = 8.0):
    """The first ``n_modes`` Noll modes on a ``grid_size`` grid within
    ``radius``, each of unit norm on the grid ``(n_modes, G, G)`` float32,
    and the pupil mask ``(G, G)`` complex64 (zernike.py:134)."""
    ax = np.arange(grid_size) - (grid_size - 1) / 2
    yy, xx = np.meshgrid(ax, ax, indexing="ij")
    r = np.sqrt(xx ** 2 + yy ** 2) / radius
    th = np.arctan2(yy, xx)
    mask = (r <= 1.0).astype(np.float64)
    rc = np.clip(r, 0, 1)
    modes = []
    for j in range(1, n_modes + 1):
        n, m = noll_to_nm(j)
        R = sum(c * rc ** p for c, p in _radial_coefficients(n, m))
        Z = R * (np.cos(m * th) if m > 0 else np.sin(-m * th) if m < 0 else 1.0) * mask
        modes.append(Z / (np.sqrt(np.sum(Z ** 2)) + 1e-12))
    return (torch.from_numpy(np.stack(modes).astype(np.float32)),
            torch.from_numpy(mask.astype(np.complex64)))
