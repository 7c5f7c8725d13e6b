"""The reference's functional namespace (port of
deepinv_tpu/physics/functional.py).

Re-exports the ops layer's stateless functions under the reference's public
names, with the few helpers that live only here: the 1-D DCT wrappers,
``liu_jia_pad`` (the DST-I harmonic boundary extension),
``multiplier_adjoint``, the tiled partition-of-unity multipliers, and the
class wrappers ``Radon``/``IRadon``/``RampFilter``/``ApplyRadon``/
``XrayTransform`` over the functional projectors. ``random_uniform`` draws
from a ``torch.Generator`` where the JAX package takes a key.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.linalg import linear_transpose, power_method
from ..ops import (ThinPlateSpline, bicubic_filter, bilinear_filter, conv2d, conv2d_fft, conv3d,
                   conv3d_fft, conv_transpose2d, conv_transpose2d_fft, conv_transpose3d,
                   conv_transpose3d_fft, dct1d, dct2, dst1, filter_fft_2d, gaussian_blur,
                   histogram, histogramdd, idct1d, idct2, imresize_matlab, kaiser_window,
                   multiplier, product_convolution2d, product_convolution2d_adjoint,
                   random_choice, sinc_filter)
from ..ops.radon import fanbeam
from ..ops.radon import iradon as _iradon_fn
from ..ops.radon import radon as _radon_fn
from ..ops.radon import ramp_filter as _ramp
from ..ops.xray import ray_integrals, xray_geometry, xray_transform

__all__ = [
    "conv2d", "conv_transpose2d", "conv3d", "conv_transpose3d",
    "conv2d_fft", "conv_transpose2d_fft", "conv3d_fft",
    "conv_transpose3d_fft", "filter_fft", "filter_fft_2d",
    "gaussian_blur", "bilinear_filter", "bicubic_filter", "sinc_filter",
    "kaiser_window", "dct", "idct", "dct_2d", "idct_2d", "dst1",
    "histogram", "histogramdd", "imresize_matlab", "random_choice",
    "random_uniform", "product_convolution2d",
    "product_convolution2d_adjoint", "multiplier", "multiplier_adjoint",
    "generate_tiled_multipliers", "tiled_product_convolution", "liu_jia_pad", "power_method",
    "Radon", "IRadon", "RampFilter", "ApplyRadon", "XrayTransform",
    "ThinPlateSpline", "ray_integrals",
]

# the reference's aliases (functional.py:67-69)
filter_fft = filter_fft_2d
dct_2d = dct2
idct_2d = idct2


def _dct_scale(N: int, dtype, device) -> torch.Tensor:
    """Orthonormal to scipy's unnormalized DCT-II factors (functional.py:72):
    ``X_u[0] = 2 sqrt(N) X_o[0]``, ``X_u[k>0] = sqrt(2N) X_o[k]``."""
    s = np.full((N,), np.sqrt(2.0 * N))
    s[0] = np.sqrt(4.0 * N)
    return torch.as_tensor(s, dtype=dtype, device=device)


def dct(x: torch.Tensor, norm=None) -> torch.Tensor:
    """DCT-II over the last axis (functional.py:80), ``norm`` None (scipy's
    unnormalized convention) or ``"ortho"``."""
    y = dct1d(x, axis=-1, ortho=True)
    if norm == "ortho":
        return y
    return y * _dct_scale(x.shape[-1], x.dtype, x.device)


def idct(x: torch.Tensor, norm=None) -> torch.Tensor:
    """Inverse of :func:`dct`, a scaled DCT-III (functional.py:91)."""
    if norm == "ortho":
        return idct1d(x, axis=-1, ortho=True)
    return idct1d(x / _dct_scale(x.shape[-1], x.dtype, x.device), axis=-1, ortho=True)


def random_uniform(generator=None, shape=(), minval: float = 0.0, maxval: float = 1.0,
                   dtype=torch.float32, device=None) -> torch.Tensor:
    """Uniform draws on ``[minval, maxval)`` from ``generator`` (the JAX
    package's ``random_uniform(key, ...)``, functional.py:99), made on the
    generator's device (the CPU for None) and returned on ``device``."""
    gdev = generator.device if generator is not None else torch.device("cpu")
    u = torch.rand(tuple(shape), generator=generator, dtype=dtype, device=gdev)
    u = minval + (maxval - minval) * u
    return u if device is None else u.to(device)


def multiplier_adjoint(x: torch.Tensor, mult: torch.Tensor) -> torch.Tensor:
    """Adjoint of :func:`multiplier`: ``x * conj(mult)`` (functional.py:105)."""
    return x * (mult.conj() if mult.is_complex() else mult)


# -- padding ---------------------------------------------------------------------


def _biharmonic_inpainting(x: torch.Tensor) -> torch.Tensor:
    """Fill the interior of ``x`` harmonically from its 1-pixel boundary
    (functional.py:112): the 5-point Laplace equation diagonalized by the
    DST-I."""
    H, W = x.shape[-2:]
    lap = (x[..., 1:-1, 2:] + x[..., 1:-1, :-2] + x[..., 2:, 1:-1] + x[..., :-2, 1:-1]
           - 4 * x[..., 1:-1, 1:-1])
    spec = dst1(lap, axes=(-2, -1), ortho=True)
    fh = torch.arange(1, H - 1, dtype=x.dtype, device=x.device)
    fw = torch.arange(1, W - 1, dtype=x.dtype, device=x.device)
    d = (2 * torch.cos(math.pi * fh / (H - 1))[:, None]
         + 2 * torch.cos(math.pi * fw / (W - 1))[None, :] - 4)
    z = dst1(-spec / d, axes=(-2, -1), ortho=True)
    out = x.clone()
    out[..., 1:-1, 1:-1] = z
    return out


def liu_jia_pad(x: torch.Tensor, *, padding) -> torch.Tensor:
    """Liu-Jia boundary-smoothing pad (functional.py:133): ``(B, C, H, W)``
    to ``(B, C, H + 2 pad_h, W + 2 pad_w)`` with smooth circular boundaries
    (the pad region inpainted harmonically), against the ringing of a
    spectral deconvolution of a real blurry image."""
    if x.dim() != 4:
        raise ValueError("Input tensor must be 4-dimensional (B, C, H, W)")
    padding_lr, padding_tb = padding
    if padding_lr < 0 or padding_tb < 0:
        raise ValueError(f"Padding values must be non-negative. Got: {padding}")
    if padding_lr == 0 and padding_tb == 0:
        return x
    if padding_lr == 0 or padding_tb == 0:
        raise ValueError(f"Single direction padding is not supported. Got: {padding}")
    padding_h, padding_w = 2 * padding_lr, 2 * padding_tb
    BC = tuple(x.shape[:-2])
    H, W = x.shape[-2:]
    kw = dict(dtype=x.dtype, device=x.device)
    A = torch.zeros(BC + (2 + padding_h, W), **kw)
    B = torch.zeros(BC + (H, 2 + padding_w), **kw)
    C = torch.zeros(BC + (2 + padding_h, 2 + padding_w), **kw)
    # the boundaries shared with x (circular continuation)
    A[..., :1, :] = x[..., -1:, :]
    A[..., -1:, :] = x[..., :1, :]
    B[..., :, :1] = x[..., :, -1:]
    B[..., :, -1:] = x[..., :, :1]
    a = torch.linspace(0, 1, padding_h, **kw).reshape((1,) * len(BC) + (padding_h,))
    b = torch.linspace(0, 1, padding_w, **kw).reshape((1,) * len(BC) + (padding_w,))
    A[..., 1:-1, 0] = (1 - a) * A[..., 0, 0, None] + a * A[..., -1, 0, None]
    A[..., 1:-1, -1] = (1 - a) * A[..., 0, -1, None] + a * A[..., -1, -1, None]
    B[..., 0, 1:-1] = (1 - b) * B[..., 0, 0, None] + b * B[..., 0, -1, None]
    B[..., -1, 1:-1] = (1 - b) * B[..., -1, 0, None] + b * B[..., -1, -1, None]
    # C shares its rows with B and its columns with A (functional.py:179-184)
    C[..., :1, :] = B[..., -1:, :]
    C[..., -1:, :] = B[..., :1, :]
    C[..., :, :1] = A[..., :, -1:]
    C[..., :, -1:] = A[..., :, :1]
    A = _biharmonic_inpainting(A)[..., 1:-1, :]
    B = _biharmonic_inpainting(B)[..., :, 1:-1]
    C = _biharmonic_inpainting(C)[..., 1:-1, 1:-1]
    z = torch.cat([torch.cat([x, B], dim=-1), torch.cat([A, C], dim=-1)], dim=-2)
    return torch.roll(z, shifts=tuple(padding), dims=(-2, -1))


# -- tiles -----------------------------------------------------------------------


def generate_tiled_multipliers(img_size, patch_size, stride, mode: str = "bump",
                               dtype=torch.float32) -> torch.Tensor:
    """Per-patch partition-of-unity blending masks ``(1, 1, K, ph, pw)``
    (functional.py:199), made on the host."""
    def pair(v):
        return (v, v) if isinstance(v, int) else tuple(v)

    H, W = pair(img_size)
    ph, pw = pair(patch_size)
    sh, sw = pair(stride)

    def wins(L, p, s):
        n = (L - p) // s + 1
        t = np.linspace(-1, 1, p)
        if mode == "linear":
            w = 1.0 - np.abs(t)
        elif mode == "bump":
            w = np.exp(-1.0 / np.clip(1 - t ** 2, 1e-9, None))
        else:
            raise ValueError("mode must be 'bump' or 'linear'")
        w = np.clip(w, 1e-12, None)
        M = np.zeros((n, p + (n - 1) * s))
        for i in range(n):
            M[i, i * s:i * s + p] = w
        M /= M.sum(0, keepdims=True) + 1e-8
        return M, n

    My, ny = wins(H, ph, sh)
    Mx, nx = wins(W, pw, sw)
    out = np.zeros((ny * nx, ph, pw))
    for i in range(ny):
        for j in range(nx):
            out[i * nx + j] = np.outer(My[i, i * sh:i * sh + ph], Mx[j, j * sw:j * sw + pw])
    return torch.as_tensor(out, dtype=dtype)[None, None]


def tiled_product_convolution(x: torch.Tensor, filters, patch_size, stride,
                              mode: str = "bump") -> torch.Tensor:
    """Tiled space-varying convolution ``y = sum_k h_k * (m_k . x)``
    (functional.py:238), by
    :class:`~deepinv_tpu_torch.physics.TiledSpaceVaryingBlur` on ``x``'s
    device."""
    from .blur import TiledSpaceVaryingBlur

    p = TiledSpaceVaryingBlur(filters=filters, patch_size=patch_size, stride=stride,
                              blending_mode=mode, device=x.device)
    return p.A(x)


# -- radon -------------------------------------------------------------------------


def _theta(theta) -> torch.Tensor:
    return torch.as_tensor(np.arange(180.0) if theta is None else theta, dtype=torch.float32)


class Radon:
    """Functional Radon projector (functional.py:251); angles in degrees,
    ``fan_parameters`` those of :func:`~deepinv_tpu_torch.ops.radon.fanbeam`."""

    def __init__(self, in_size=None, theta=None, circle: bool = False,
                 parallel_computation: bool = True, fan_beam: bool = False,
                 fan_parameters=None, dtype=torch.float32):
        self.theta = _theta(theta)
        self.circle = circle
        self.fan_beam = fan_beam
        self.fan_parameters = fan_parameters

    def __call__(self, x):
        if self.fan_beam:
            return fanbeam(x, self.theta, **(self.fan_parameters or {}))
        return _radon_fn(x, self.theta, circle=self.circle)


class IRadon:
    """Functional filtered or plain backprojection (functional.py:274)."""

    def __init__(self, in_size=None, theta=None, circle: bool = False, use_filter: bool = True,
                 out_size=None, dtype=torch.float32):
        self.in_size = in_size
        self.theta = _theta(theta)
        self.circle = circle
        self.use_filter = use_filter

    def __call__(self, sino):
        return _iradon_fn(sino, self.theta, circle=self.circle, filtered=self.use_filter,
                          out_size=self.in_size)


class RampFilter:
    """Frequency-domain ramp filter (functional.py:292)."""

    def create_filter(self, f):
        """The ramp passes the base ``|omega|`` response through unchanged
        (functional.py:295)."""
        return f

    def _get_fourier_filter(self, size: int) -> torch.Tensor:
        """Real-spectrum ramp response of the Ram-Lak kernel
        (functional.py:300)."""
        n = np.concatenate([np.arange(1, size / 2 + 1, 2), np.arange(size / 2 - 1, 0, -2)])
        f = np.zeros(size, np.float32)
        f[0] = 0.25
        f[1::2] = -1 / (np.pi * n) ** 2
        return 2 * torch.fft.rfft(torch.from_numpy(f))

    def filter(self, x: torch.Tensor, fourier_filter: torch.Tensor, pad_width: int,
               dim: int = 3) -> torch.Tensor:
        """Filter the detector axis ``dim`` of a sinogram with a 1-D Fourier
        filter after a zero pad of ``pad_width`` (functional.py:309)."""
        input_size = x.shape[dim]
        padded = torch.cat([x, x.new_zeros(x.shape[:dim] + (pad_width,) + x.shape[dim + 1:])],
                           dim=dim)
        f = fourier_filter.to(x.device)
        f = f.reshape(f.shape + (1,) * (x.dim() - 1 - dim % x.dim()))
        result = torch.fft.irfft(torch.fft.rfft(padded, dim=dim) * f, dim=dim,
                                 n=padded.shape[dim])
        return result.narrow(dim, 0, input_size)

    def __call__(self, sino):
        return _ramp(sino)


class ApplyRadon:
    """Function-style Radon apply with its adjoint (functional.py:326): the
    forward is differentiable by autograd as it stands."""

    @staticmethod
    def apply(x, radon: Radon, iradon: IRadon, is_adjoint: bool = False):
        return iradon(x) if is_adjoint else radon(x)


class XrayTransform:
    """The ray-driven X-ray transform of :mod:`deepinv_tpu_torch.ops.xray`
    (functional.py:338), the reference's astra-backed ``XrayTransform``.

    :param geometry: a dict of :func:`~deepinv_tpu_torch.ops.xray_geometry`
        (or its keywords in ``geom_kwargs``).
    :param img_size: ``(H, W)`` or ``(D, H, W)``.
    """

    def __init__(self, geometry=None, img_size=None, pixel_spacing=1.0, n_detector_pixels=None,
                 **geom_kwargs):
        self.geometry_type = geom_kwargs.get("geometry_type")
        if geometry is None:
            geometry = xray_geometry(**geom_kwargs)
        self.geometry = geometry
        self.img_size = tuple(img_size)
        self.pixel_spacing = pixel_spacing
        self.n_detector_pixels = n_detector_pixels

    @property
    def domain_shape(self) -> tuple:
        """The input volume's shape (functional.py:361)."""
        return tuple(self.img_size)

    @property
    def range_shape(self) -> tuple:
        """The projection's shape: ``(A, N)`` in 2D, ``(V, A, N)`` in 3D
        (functional.py:366)."""
        A = int(np.asarray(self.geometry["det"]).shape[0])
        n = self.n_detector_pixels
        if isinstance(n, (tuple, list)):
            V, N = int(n[0]), int(n[-1])
        else:
            N = int(n) if n is not None else int(np.ceil(np.sqrt(2) * max(self.img_size[-2:])))
            V = self.img_size[0] if len(self.img_size) == 3 else None
        return (A, N) if V is None else (V, A, N)

    @property
    def detector_cell_u_length(self) -> float:
        """Horizontal detector cell pitch ``||u||`` (functional.py:380)."""
        return float(np.linalg.norm(np.asarray(self.geometry["u"])[0]))

    @property
    def detector_cell_v_length(self) -> float:
        """Vertical detector cell pitch ``||v||`` (functional.py:386)."""
        return float(np.linalg.norm(np.asarray(self.geometry["v"])[0]))

    @property
    def detector_cell_area(self) -> float:
        """One detector cell's area (functional.py:391)."""
        return self.detector_cell_u_length * self.detector_cell_v_length

    @property
    def source_radius(self) -> float:
        """Source-to-axis distance; 0 for parallel beams (functional.py:396)."""
        src = self.geometry.get("src")
        return 0.0 if src is None else float(np.linalg.norm(np.asarray(src)[0]))

    @property
    def detector_radius(self) -> float:
        """Detector-centre-to-axis distance (functional.py:405)."""
        return float(np.linalg.norm(np.asarray(self.geometry["det"])[0]))

    @property
    def object_cell_volume(self) -> float:
        """One voxel's volume (functional.py:411)."""
        return float(self.pixel_spacing) ** len(self.img_size)

    @property
    def magnification_factor(self) -> float:
        """Cone-beam magnification; 1 for parallel and fan beams
        (functional.py:416)."""
        if self.geometry_type and "cone" in self.geometry_type and self.source_radius > 0:
            return (self.detector_radius + self.source_radius) / self.source_radius
        return 1.0

    def __call__(self, x):
        return xray_transform(x, self.geometry, self.img_size, pixel_spacing=self.pixel_spacing,
                              n_detector_pixels=self.n_detector_pixels)

    forward = __call__

    def T(self, y):
        """The exact adjoint, the autograd transpose (functional.py:432)."""
        return linear_transpose(self, y, tuple(y.shape[:2]) + self.img_size)
