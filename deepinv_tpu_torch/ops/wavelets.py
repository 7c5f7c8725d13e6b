"""Separable orthonormal discrete wavelet transforms with periodized borders
(port of deepinv_tpu/ops/wavelets.py).

The analysis is a strided circular correlation with the decomposition
filters (:data:`WAVELET_FILTERS`, the port's own copy of the JAX package's
table); the basis is orthonormal, so the synthesis is the analysis'
autograd transpose. Inputs are padded symmetrically to a multiple of
``2^level`` and cropped back after the inverse.
"""

from __future__ import annotations

import math

import torch

from ..core.linalg import linear_transpose

__all__ = ["WaveletTransform", "WAVELET_FILTERS"]

_SQRT2 = math.sqrt(2.0)

# orthonormal decomposition low-pass filters (wavelets.py:29)
WAVELET_FILTERS = {
    "haar": [1 / _SQRT2, 1 / _SQRT2],
    "db1": [1 / _SQRT2, 1 / _SQRT2],
    "db2": [-0.12940952255092145, 0.22414386804185735, 0.836516303737469,
            0.48296291314469025],
    "db4": [-0.010597401784997278, 0.032883011666982945, 0.030841381835986965,
            -0.18703481171888114, -0.02798376941698385, 0.6308807679295904,
            0.7148465705525415, 0.23037781330885523],
    "db8": [-0.00011747678400228192, 0.0006754494059985568, -0.0003917403729959771,
            -0.00487035299301066, 0.008746094047015655, 0.013981027917015516,
            -0.04408825393106472, -0.01736930100202211, 0.128747426620186,
            0.00047248457399797254, -0.2840155429624281, -0.015829105256023893,
            0.5853546836548691, 0.6756307362980128, 0.3128715909144659, 0.05441584224308161],
    "sym4": [-0.07576571478927333, -0.02963552764599851, 0.49761866763201545,
             0.8037387518059161, 0.29785779560527736, -0.09921954357684722,
             -0.012603967262037833, 0.0322231006040427],
}


def _qmf(lo):
    """The high-pass filter of a low-pass one, by the quadrature mirror
    relation (wavelets.py:80)."""
    n = len(lo)
    return [((-1) ** k) * lo[n - 1 - k] for k in range(n)]


def _symmetric_index(n: int, total: int) -> torch.Tensor:
    """Indices of numpy's ``mode="symmetric"`` padding of a length-``n`` axis
    to ``total`` at its end (the edge repeated, then mirrored)."""
    j = torch.arange(total) % (2 * n)
    return torch.where(j < n, j, 2 * n - 1 - j)


class WaveletTransform:
    """Multi-level separable DWT on ``(B, C, H, W)`` (``ndim=2``) or ``(B,
    C, D, H, W)`` (``ndim=3``) tensors (wavelets.py:86).

    :meth:`dwt2` returns ``{"coeffs": [cA_L, details_L, ..., details_1],
    "orig_shape": ...}``, coarsest first (PyWavelets' order); each level's
    details are the ``2^ndim - 1`` bands after the all-low-pass one (2D:
    lh, hl, hh).
    """

    def __init__(self, wavelet: str = "db4", level: int = 3, ndim: int = 2):
        if wavelet not in WAVELET_FILTERS:
            raise ValueError(f"unknown wavelet {wavelet!r}; available: "
                             f"{sorted(WAVELET_FILTERS)}")
        if ndim not in (2, 3):
            raise ValueError("ndim must be 2 or 3")
        self.wavelet, self.level, self.ndim = wavelet, level, ndim
        lo = WAVELET_FILTERS[wavelet]
        self.lo = torch.tensor(lo, dtype=torch.float32)
        self.hi = torch.tensor(_qmf(lo), dtype=torch.float32)

    def _analysis_1d(self, x, axis: int):
        """Circular correlation with the filters and decimation by 2 along
        ``axis`` (wavelets.py:110)."""
        x = x.movedim(axis, -1)
        N, L = x.shape[-1], self.lo.shape[0]
        idx = (torch.arange(0, N, 2)[:, None] + torch.arange(L)[None, :] - (L - 2)) % N
        gathered = x[..., idx.to(x.device)]                     # (..., N/2, L)
        lo = (gathered * self.lo.flip(0).to(x.device, x.dtype)).sum(-1)
        hi = (gathered * self.hi.flip(0).to(x.device, x.dtype)).sum(-1)
        return lo.movedim(-1, axis), hi.movedim(-1, axis)

    def _dwt2_level(self, x):
        """One analysis level over the trailing ``ndim`` axes: the all-low
        band and the ``2^ndim - 1`` others (wavelets.py:122)."""
        bands = [x]
        for ax in range(-self.ndim, 0):
            bands = [b for band in bands for b in self._analysis_1d(band, ax)]
        return bands[0], tuple(bands[1:])

    def _pad(self, x):
        """Symmetric padding of the trailing axes to a multiple of
        ``2^level`` (wavelets.py:134)."""
        m = 2 ** self.level
        sp = tuple(x.shape[-self.ndim:])
        for d, s in enumerate(sp):
            if s % m:
                idx = _symmetric_index(s, s + (-s) % m).to(x.device)
                x = x.index_select(x.dim() - self.ndim + d, idx)
        return x, sp

    def dwt2(self, x):
        """Analysis of ``x`` (wavelets.py:146)."""
        x, orig = self._pad(x)
        coeffs = []
        a = x
        for _ in range(self.level):
            a, details = self._dwt2_level(a)
            coeffs.append(details)
        return {"coeffs": [a] + coeffs[::-1], "orig_shape": orig}

    def idwt2(self, tree):
        """Synthesis, the inverse of :meth:`dwt2` (wavelets.py:156)."""
        coeffs, orig = tree["coeffs"], tree["orig_shape"]
        a = coeffs[0]
        for details in coeffs[1:]:
            a = self._idwt2_level(a, details)
        return a[(Ellipsis,) + tuple(slice(0, s) for s in orig)]

    def _idwt2_level(self, a, details):
        # the synthesis is the transpose of the orthonormal analysis (wavelets.py:164)
        def analysis(x):
            lo, detail = self._dwt2_level(x)
            return (lo,) + detail

        shape = tuple(a.shape[:-self.ndim]) + tuple(2 * s for s in a.shape[-self.ndim:])
        return linear_transpose(analysis, (a,) + tuple(details), shape)

    def map_detail(self, tree, fn):
        """``fn`` applied to every detail band, the approximation kept
        (wavelets.py:176)."""
        coeffs = tree["coeffs"]
        new = [coeffs[0]] + [tuple(fn(c) for c in d) for d in coeffs[1:]]
        return {"coeffs": new, "orig_shape": tree["orig_shape"]}

    def flat_coeffs(self, tree):
        """The detail coefficients concatenated into ``(B, -1)``
        (wavelets.py:182)."""
        return torch.cat([c.reshape(c.shape[0], -1) for d in tree["coeffs"][1:] for c in d],
                         dim=1)
