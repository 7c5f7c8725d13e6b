"""Phase retrieval (port of deepinv_tpu/physics/phase_retrieval.py):
``y = |B x|^2`` with ``B`` linear, a nonlinear physics with the analytic
vector-Jacobian product, and the spectral initialization.

The dense sensing matrix of :class:`RandomPhaseRetrieval` is applied in
exact f32 (:func:`~deepinv_tpu_torch.core.exact_f32`). Random tables (the
matrix, the phase diagonals, the spectral method's start) are taken from
the caller or drawn on the CPU from its ``torch.Generator`` and moved.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from ..core.linalg import exact_f32
from ..device import resolve_device
from .base import LinearPhysics, Physics
from .structured_random import generate_diagonal

__all__ = ["PhaseRetrieval", "RandomPhaseRetrieval", "StructuredRandomPhaseRetrieval",
           "PtychographyLinearOperator", "Ptychography", "spectral_methods",
           "correct_global_phase", "cosine_similarity"]


class PhaseRetrieval(Physics):
    r"""``y = |B x|^2`` (phase_retrieval.py:34)."""

    def __init__(self, B: LinearPhysics, **kwargs):
        super().__init__(**kwargs)
        self.B = B

    def A(self, x, **params):
        return self.B.A(x, **params).abs() ** 2

    def A_vjp(self, x, v):
        """``v^T dA/dx = B^H (2 (B x) v)`` (phase_retrieval.py:43)."""
        return self.B.A_adjoint(2.0 * self.B.A(x) * v)

    def B_adjoint(self, y, **params):
        return self.B.A_adjoint(y, **params)

    def A_adjoint(self, y, **params):
        """``B``'s adjoint, a linear backprojection (phase_retrieval.py:51)."""
        return self.B_adjoint(y, **params)

    def B_dagger(self, y, **params):
        return self.B.A_dagger(y, **params)

    def release_memory(self):
        """The reference's API (phase_retrieval.py:60); the tensors go with
        the physics."""
        return self

    def A_dagger(self, y, generator=None, **params):
        """The spectral initialization (phase_retrieval.py:65)."""
        return spectral_methods(y, self, generator=generator)


class _DenseB(LinearPhysics):
    """``B x = mat vec(x)``, complex64, in exact f32."""

    def __init__(self, mat, img_size):
        super().__init__()
        self.register_buffer("mat", mat)
        self.img_size = tuple(img_size)

    def A(self, x, **params):
        with exact_f32(x.device.type):
            return x.reshape(x.shape[0], -1).to(torch.complex64) @ self.mat.T

    def A_adjoint(self, y, **params):
        with exact_f32(y.device.type):
            v = y.to(torch.complex64) @ self.mat.conj()
        return v.reshape((y.shape[0],) + self.img_size)


class RandomPhaseRetrieval(PhaseRetrieval):
    r"""An i.i.d. complex Gaussian ``B`` (phase_retrieval.py:70).

    :param m: measurements.
    :param img_size: the image's ``(C, H, W)``.
    :param matrix: the complex ``(m, n)`` matrix, of entries of variance
        ``1/m``; drawn from ``generator`` (seeded from ``seed`` if None) where
        None: real and imaginary parts two normal draws over ``sqrt(2m)``.
    :param device: where the matrix lives; the CUDA device by default.
    """

    def __init__(self, m: int, img_size, matrix=None, generator=None, seed: int = 0,
                 device=None, **kwargs):
        device = resolve_device(device)
        n = int(np.prod(img_size))
        if matrix is None:
            if generator is None:
                generator = torch.Generator().manual_seed(seed)
            re = torch.randn((m, n), generator=generator)
            im = torch.randn((m, n), generator=generator)
            matrix = torch.complex(re, im) / math.sqrt(2 * m)
        super().__init__(_DenseB(torch.as_tensor(matrix).to(torch.complex64), img_size),
                         **kwargs)
        self.m = m
        self.img_size = tuple(img_size)
        self.to(device)

    def get_A_squared_mean(self):
        """``E|B_ij|^2``, ``var + |mean|^2`` of the entries
        (phase_retrieval.py:112)."""
        m = self.B.mat.mean()
        return ((self.B.mat - m).abs() ** 2).mean() + m.abs() ** 2


def _crop_or_pad(v, hw):
    """A centred crop to ``hw`` where it is smaller, a centred zero pad where
    it is larger (phase_retrieval.py:148)."""
    H, W = v.shape[-2:]
    h, w = hw
    if h <= H and w <= W:
        top, left = (H - h) // 2, (W - w) // 2
        return v[..., top:top + h, left:left + w]
    return F.pad(v, ((w - W) // 2, w - W - (w - W) // 2, (h - H) // 2, h - H - (h - H) // 2))


class _StructB(LinearPhysics):
    """``B = crop(prod_i F D_i)`` with orthonormal 2-D FFTs."""

    def __init__(self, diagonals, img_size, output_size):
        super().__init__()
        self._n = len(diagonals)
        for i, d in enumerate(diagonals):
            self.register_buffer(f"diagonal_{i}", torch.as_tensor(d).to(torch.complex64))
        self.img_size, self.output_size = tuple(img_size), tuple(output_size)

    @property
    def diagonals(self):
        return [getattr(self, f"diagonal_{i}") for i in range(self._n)]

    def A(self, x, **params):
        out = x.to(torch.complex64)
        for d in self.diagonals:
            out = torch.fft.fft2(out * d, norm="ortho")
        return _crop_or_pad(out, self.output_size[-2:])

    def A_adjoint(self, y, **params):
        out = _crop_or_pad(y, self.img_size[-2:])
        for d in reversed(self.diagonals):
            out = torch.fft.ifft2(out, norm="ortho") * d.conj()
        return out


class StructuredRandomPhaseRetrieval(PhaseRetrieval):
    r"""``B = prod_i F D_i``, random phase diagonals between orthonormal FFTs
    (phase_retrieval.py:122), cropped or zero-padded to ``output_size``.

    :param diagonals: the ``n_layers`` unit complex diagonals of
        ``img_size``; drawn from ``generator`` (seeded from ``seed`` if None)
        where None.
    :param device: where the diagonals live; the CUDA device by default.
    """

    def __init__(self, img_size, output_size=None, n_layers: int = 2, diagonals=None,
                 generator=None, seed: int = 0, device=None, **kwargs):
        device = resolve_device(device)
        img_size = tuple(img_size)
        output_size = tuple(output_size) if output_size is not None else img_size
        if diagonals is None:
            if generator is None:
                generator = torch.Generator().manual_seed(seed)
            diagonals = [generate_diagonal(img_size, "uniform_phase", generator)
                         for _ in range(int(n_layers))]
        super().__init__(_StructB(diagonals, img_size, output_size), **kwargs)
        self.img_size = img_size
        self.output_size = output_size
        self.n_layers = n_layers
        self.to(device)

    @property
    def diagonals(self):
        """The random phase diagonals."""
        return self.B.diagonals

    def get_A_squared_mean(self):
        """``var + mean^2`` of the first diagonal (phase_retrieval.py:176);
        None for a single Fourier transform (``n_layers`` 0.5)."""
        if self.n_layers == 0.5:
            warnings.warn("computing the mean of the squared operator for a single "
                          "Fourier transform.")
            return None
        d = self.diagonals[0]
        m = d.mean()
        return ((d - m).abs() ** 2).mean() + m ** 2

    @staticmethod
    def get_structure(n_layers) -> str:
        """The operator's structure, e.g. ``"FDFD"`` (phase_retrieval.py:192)."""
        return "FD" * math.floor(n_layers) + "F" * (n_layers % 1 == 0.5)


def _shift_mask(H: int, W: int, sy: int, sx: int) -> np.ndarray:
    """Where a roll by ``(sy, sx)`` did not wrap around."""
    ii, jj = np.arange(H)[:, None], np.arange(W)[None, :]
    keep_i = ii >= sy if sy >= 0 else ii < H + sy
    keep_j = jj >= sx if sx >= 0 else jj < W + sx
    return keep_i & keep_j


class PtychographyLinearOperator(LinearPhysics):
    r"""Shifted illumination probes, each followed by an orthonormal FFT
    (phase_retrieval.py:206); ``A`` maps ``(B, C, H, W)`` to ``(B, n_img, C,
    H, W)``. The shifted probes, the wrapped-in region zeroed, are one
    ``(n_img, H, W)`` buffer, so ``A`` is one broadcast product and one FFT.

    :param probe: the ``(H, W)`` probe (a disc of ``probe_radius`` by default).
    :param shifts: ``(n_img, 2)`` integer shifts (a ``sqrt(n_img)`` square
        grid over half the image by default).
    :param device: where the probes live; the CUDA device by default.
    """

    def __init__(self, img_size, probe=None, shifts=None, n_img: int = 25,
                 probe_radius: float = 0.3, device=None, **kwargs):
        device = resolve_device(device)
        super().__init__(**kwargs)
        self.img_size = tuple(img_size)
        H, W = self.img_size[-2:]
        if probe is None:
            yy, xx = np.meshgrid(np.arange(H) - H / 2, np.arange(W) - W / 2, indexing="ij")
            probe = (np.sqrt(yy ** 2 + xx ** 2) < probe_radius * min(H, W)).astype(np.float32)
        probe = torch.as_tensor(np.asarray(probe)).to(torch.complex64)
        if shifts is None:
            k = int(np.sqrt(n_img))
            ys = np.linspace(-H / 4, H / 4, k).astype(int)
            xs = np.linspace(-W / 4, W / 4, k).astype(int)
            shifts = np.array([(y, x) for y in ys for x in xs])
        shifts = np.asarray(shifts).astype(np.int64)
        probes = torch.stack([
            torch.roll(probe, (int(sy), int(sx)), dims=(-2, -1))
            * torch.from_numpy(_shift_mask(H, W, int(sy), int(sx))) for sy, sx in shifts])
        self.register_buffer("probe", probe)
        self.register_buffer("shifts", torch.from_numpy(shifts))
        self.register_buffer("probes", probes)
        self.to(device)

    def A(self, x, **params):
        xc = x.to(torch.complex64)
        return torch.fft.fft2(xc[:, None] * self.probes[None, :, None], norm="ortho")

    def A_adjoint(self, y, **params):
        return (torch.fft.ifft2(y, norm="ortho") * self.probes[None, :, None].conj()).sum(1)

    @staticmethod
    def shift(x, x_shift: int, y_shift: int, pad_zeros: bool = True):
        """``x`` rolled by ``(x_shift, y_shift)``, the wrapped-in region
        zeroed where ``pad_zeros`` (phase_retrieval.py:255)."""
        x = torch.roll(x, (x_shift, y_shift), dims=(-2, -1))
        if pad_zeros:
            H, W = x.shape[-2:]
            keep = torch.from_numpy(_shift_mask(H, W, x_shift, y_shift)).to(x.device)
            x = torch.where(keep, x, torch.zeros_like(x))
        return x

    def get_overlap_img(self, shifts):
        """The summed squared shifted probe intensities, the illumination
        coverage map (phase_retrieval.py:279)."""
        overlap = torch.zeros(self.probe.shape, device=self.probe.device)
        for x_shift, y_shift in np.asarray(torch.as_tensor(shifts).cpu()):
            overlap = overlap + self.shift(self.probe, int(x_shift), int(y_shift)).abs() ** 2
        return overlap


class Ptychography(PhaseRetrieval):
    r"""``y = |P(x)|^2`` with ``P`` a :class:`PtychographyLinearOperator`
    (phase_retrieval.py:294)."""

    def __init__(self, img_size, probe=None, shifts=None, n_img: int = 25,
                 probe_radius: float = 0.3, device=None, **kwargs):
        B = PtychographyLinearOperator(img_size, probe=probe, shifts=shifts, n_img=n_img,
                                       probe_radius=probe_radius, device=device)
        super().__init__(B, **kwargs)
        self.img_size = tuple(img_size)


def spectral_methods(y, physics, x=None, n_iter: int = 50, preprocessing=None,
                     lamb: float = 10.0, generator=None):
    """The spectral initialization (phase_retrieval.py:312): the leading
    eigenvector of ``B^H diag(T(y)) B + lamb I`` by ``n_iter`` power steps,
    scaled to the measurements' energy.

    :param x: the start, complex or real of ``B^H y``'s shape; a normal draw
        of ``generator`` (a ``torch.Generator`` seeded 23 on the CPU if None,
        as the JAX package seeds its key) where None.
    """
    if preprocessing is None:
        def preprocessing(u):
            return torch.clamp_min(1 - 1 / u.clamp_min(1e-6), -5.0)
    dims = tuple(range(1, y.dim()))
    diag = preprocessing(y / y.mean(dim=dims, keepdim=True))
    if x is None:
        shape = physics.B.A_adjoint(y).shape
        if generator is None:
            generator = torch.Generator().manual_seed(23)
        x = torch.randn(shape, generator=generator, device=generator.device)
    v = torch.as_tensor(x).to(device=y.device, dtype=torch.complex64)
    for _ in range(n_iter):
        v = physics.B.A_adjoint(diag * physics.B.A(v)) + lamb * v
        v = v / torch.sqrt((v.abs() ** 2).sum())
    scale = torch.sqrt(y.mean(dim=dims))
    vmean = torch.sqrt((physics.B.A(v).abs() ** 2).mean(dim=dims))
    ratio = (scale / vmean.clamp_min(1e-12)).reshape((v.shape[0],) + (1,) * (v.dim() - 1))
    return v * ratio


def correct_global_phase(x_hat, x):
    """``x_hat`` with its global phase aligned to ``x``'s
    (phase_retrieval.py:343)."""
    inner = (x_hat.conj() * x).sum(dim=tuple(range(1, x.dim())), keepdim=True)
    return x_hat * (inner / inner.abs().clamp_min(1e-12))


def cosine_similarity(a, b):
    """``|<a, b>| / (||a|| ||b||)`` (phase_retrieval.py:351)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    num = torch.vdot(a.reshape(-1).to(dt), b.reshape(-1).to(dt)).abs()
    den = torch.sqrt((a.abs() ** 2).sum() * (b.abs() ** 2).sum())
    return num / den.clamp_min(1e-12)
