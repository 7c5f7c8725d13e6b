"""DEAL, deep equilibrium attention least squares (port of
deepinv_tpu/models/deal.py; Pourya et al. 2025).

- :class:`LinearSpline`: activations on uniform knots with slope-projected
  coefficients, evaluated by a gather and a linear interpolation.
- :class:`MultiConv2d`: stacked convolutions, the first kernel zero-mean,
  normalized by the Fourier spectral norm of ``W^T W``; the adjoint is the
  autograd transpose of the forward (``core/linalg.py``
  :func:`~deepinv_tpu_torch.core.linalg.linear_transpose`, the JAX
  ``jax.linear_transpose``).
- the solver: an outer loop refreshing the mask around per-sample conjugate
  gradients on ``(H^T H + lambda L^T L) x = H^T y`` over ``1 + lambda``. Both
  JAX ``lax.while_loop``s (deal.py:225, 320) run on
  :func:`~deepinv_tpu_torch.core.linalg.device_while`, which decides the stop
  on the device and reads it every ``CHECK_EVERY`` iterations; the frozen
  iterations past the stop are discarded, so the result is the loop's. The
  solve is not differentiated (nor is the JAX one: a ``while_loop`` has no
  reverse mode), so it runs without a graph.

Published checkpoints load through
:func:`~deepinv_tpu_torch.models.convert.port_deal`.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..core.linalg import device_while, linear_transpose
from ..device import resolve_device
from .base import Reconstructor

__all__ = ["DEAL", "LinearSpline", "MultiConv2d"]


class LinearSpline(nn.Module):
    """Linear-spline activations on ``num_knots`` uniform knots in
    ``[x_min, x_max]`` (deal.py:37), ``num_activations`` of them grouped over
    the channel axis.

    :param init: "identity" | "gaussian" | "zero" | a float.
    :param slope_min, slope_max: slope clamps applied by the coefficient
        projection.
    :param clamp: zero the first and last slopes (flat extrapolation).
    """

    def __init__(self, num_activations: int, num_knots: int, x_min: float, x_max: float,
                 init="identity", slope_max=None, slope_min=None, clamp: bool = True):
        super().__init__()
        self.num_activations = int(num_activations)
        self.num_knots = int(num_knots)
        self.x_min = float(x_min)
        self.x_max = float(x_max)
        self.slope_min = slope_min
        self.slope_max = slope_max
        self.clamp = clamp
        grid = torch.linspace(x_min, x_max, num_knots).expand(num_activations, num_knots)
        if isinstance(init, float):
            coeffs = torch.ones_like(grid) * init
        elif init == "gaussian":
            coeffs = torch.exp(-(grid ** 2))
        elif init == "identity":
            coeffs = grid.clone()
        elif init == "zero":
            coeffs = grid * 0
        else:
            raise ValueError("init should be in [identity, zero, gaussian].")
        self.coefficients = nn.Parameter(coeffs.contiguous())

    @property
    def step_size(self):
        return (self.x_max - self.x_min) / (self.num_knots - 1)

    def projected_coefficients(self):
        """The slope-projected coefficients (deal.py:78)."""
        cs = self.coefficients
        if self.slope_min is None and self.slope_max is None and not self.clamp:
            return cs
        slopes = (cs[:, 1:] - cs[:, :-1]) / self.step_size
        if self.slope_min is not None or self.slope_max is not None:
            slopes = slopes.clamp(self.slope_min, self.slope_max)
        if self.clamp:
            slopes = slopes.clone()
            slopes[:, 0] = 0
            slopes[:, -1] = 0
        new_cs = torch.cat([torch.zeros_like(cs[:, :1]),
                            torch.cumsum(slopes, 1) * self.step_size], 1)
        return new_cs + (cs - new_cs).mean(1, keepdim=True)

    def forward(self, x):
        """``x`` ``(B, C, ...)``, C a multiple of ``num_activations``."""
        cs = self.projected_coefficients().to(x.dtype)
        A, K = cs.shape
        step = self.step_size
        in_shape = x.shape
        x = x.reshape(x.shape[0], A, x.shape[1] // A, *x.shape[2:])
        xc = x.clamp(self.x_min, self.x_max - step)
        floored = torch.floor((xc - self.x_min) / step)
        frac = (x - self.x_min) / step - floored
        idx = floored.long()
        a_idx = torch.arange(A, device=x.device).reshape(1, A, *([1] * (x.dim() - 2)))
        a_idx = a_idx.expand(idx.shape)
        c0 = cs[a_idx, idx]
        c1 = cs[a_idx, (idx + 1).clamp(0, K - 1)]
        return (c1 * frac + c0 * (1 - frac)).reshape(in_shape)


class MultiConv2d(nn.Module):
    """Stacked convolutions (deal.py:115), OIHW cross-correlations with the
    first kernel's padding at every layer, the first kernel zero-mean.

    :param generator: CPU ``torch.Generator`` of the uniform initialization
        (``U(-1, 1) / sqrt(fan_in)``).
    """

    def __init__(self, num_channels: Sequence[int] = (1, 64), size_kernels: Sequence[int] = (3,),
                 zero_mean: bool = True, sn_size: int = 256, color: bool = False,
                 generator=None):
        super().__init__()
        self.num_channels = tuple(num_channels)
        self.size_kernels = tuple(size_kernels)
        self.zero_mean = zero_mean
        self.sn_size = sn_size
        self.color = color
        self.padding = self.size_kernels[0] // 2
        self.padding_total = sum(k // 2 for k in size_kernels)
        ws = []
        for j in range(len(num_channels) - 1):
            k = size_kernels[j]
            u = torch.rand((num_channels[j + 1], num_channels[j], k, k), generator=generator)
            ws.append(nn.Parameter((2 * u - 1) / math.sqrt(num_channels[j] * k * k)))
        self.weights = nn.ParameterList(ws)

    def _effective_weights(self):
        ws = list(self.weights)
        if self.zero_mean:
            ws[0] = ws[0] - ws[0].mean((1, 2, 3), keepdim=True)
        return ws

    def _conv_stack(self, x):
        for w in self._effective_weights():
            x = F.conv2d(x, w.to(x.dtype), padding=self.padding)
        return x

    def convolution(self, x, L):
        return self._conv_stack(x / torch.sqrt(torch.as_tensor(L, dtype=x.dtype)))

    def transpose(self, y, L):
        """The exact adjoint of :meth:`convolution` (deal.py:163)."""
        B, Cin = y.shape[0], self.num_channels[0]
        xt = linear_transpose(self._conv_stack, y, (B, Cin) + tuple(y.shape[-2:]))
        return xt / torch.sqrt(torch.as_tensor(L, dtype=y.dtype))

    def get_kernel_WtW(self):
        """The kernel of ``W^T W``, from a centred Dirac (deal.py:174)."""
        pt = self.padding_total
        dirac = self.weights[0].new_zeros((1, self.num_channels[0], 4 * pt + 1, 4 * pt + 1))
        dirac[0, 1 if self.color else 0, 2 * pt, 2 * pt] = 1.0
        return self.transpose(self._conv_stack(dirac), 1.0)

    def spectral_norm(self):
        """The largest modulus of the FFT of the zero-padded ``W^T W`` kernel
        (deal.py:183)."""
        kernel = self.get_kernel_WtW()
        padding = (self.sn_size - 1) // 2 - self.padding_total
        fk = torch.fft.fft2(F.pad(kernel, (padding,) * 4)).abs()
        if self.color:
            return fk[:, 0].max() + fk[:, 1].max() + fk[:, 2].max()
        return fk.max()


def _batched_cg(BtB, b, x0, max_iter, tol):
    """Per-sample conjugate gradients (deal.py:197): ``alpha`` and ``beta``
    per sample, converged samples frozen, the loop stopping once every
    sample's squared residual is within ``tol``."""
    dims = tuple(range(1, b.dim()))

    def dot(a, c):
        return (a * c).sum(dims, keepdim=True)

    r0 = b - BtB(x0)

    def body(s):
        x, r, p, rn = s
        active = (rn > tol).to(b.dtype)
        Bp = BtB(p)
        alpha = rn / dot(p, Bp).clamp(min=1e-30)
        x = x + active * alpha * p
        r = r - active * alpha * Bp
        rn_new = dot(r, r)
        beta = rn_new / rn.clamp(min=1e-30)
        p = torch.where(active > 0, r + beta * p, p)
        rn = torch.where(active > 0, rn_new, rn)
        return x, r, p, rn

    (x, _, _, _), _ = device_while(lambda s: (s[3] > tol).any(), body,
                                   (x0, r0, r0, dot(r0, r0)), max_iter)
    return x


class DEAL(Reconstructor):
    """DEAL (deal.py:229): ``argmin_x 1/2 ||Hx - y||^2 + lambda/2 sum_c
    ||m_c(x) . K_c x||^2`` by mask refreshes alternating with per-sample CG
    solves.

    ``model(y, physics)`` reconstructs; ``model(y, sigma)`` (a second
    argument that is not a ``LinearPhysics``), ``model(y, sigma=...)`` and a
    physics whose type is named ``Denoising`` (then at ``sigma_denoiser``)
    denoise (deal.py:364-388).

    :param sigma_denoiser: the denoiser's noise level on [0, 1] (times 255
        inside, as the reference).
    :param lambda_reg: the regularization weight of reconstruction.
    :param max_iter: outer iterations of reconstruction (and 20 times as many
        CG iterations).
    :param color: the color (3-channel) variant.
    :param clamp_output: clip the output to [0, 1].
    :param pretrained: refused, as in the JAX package: load a checkpoint by
        :func:`~deepinv_tpu_torch.models.convert.port_deal`.
    :param generator: CPU ``torch.Generator`` of the initialization.
    :param device: the CUDA device by default.
    """

    def __init__(self, sigma_denoiser: float = 0.1, lambda_reg: float = 10.0,
                 max_iter: int = 50, color: bool = False, clamp_output: bool = True,
                 pretrained=None, generator=None, device=None):
        if pretrained is not None:
            raise ValueError("DEAL does not download or read a checkpoint itself: pass its torch "
                             "state dict through models.convert.port_deal")
        device = resolve_device(device)
        super().__init__()
        self.sigma_denoiser = float(sigma_denoiser)
        self.lambda_reg = float(lambda_reg)
        self.max_iter = int(max_iter)
        self.color = color
        self.clamp_output = clamp_output
        channels = [3, 12, 24, 128] if color else [1, 4, 8, 128]
        self.last_c = channels[-1]
        ks = [9] * (len(channels) - 1)
        g = generator
        self.W1 = MultiConv2d(channels, ks, color=color, generator=g)
        self.M1 = MultiConv2d(channels, ks, color=color, generator=g)
        self.M2 = nn.Parameter(torch.randn((self.last_c, self.last_c, 3, 3), generator=g) * 0.01)
        self.M3 = nn.Parameter(torch.randn((self.last_c, self.last_c, 3, 3), generator=g) * 0.01)
        self.spline1 = LinearSpline(1, 31, 0, 3, "identity", clamp=False, slope_min=0)
        self.spline2 = LinearSpline(1, 31, 0, 3, "identity", clamp=False, slope_min=0)
        self.spline3 = LinearSpline(1, 31, 0, 3, "gaussian", clamp=False)
        self.spline_lambda = LinearSpline(1, 53, -1, 51, "identity", clamp=False)
        self.spline_scaling = LinearSpline(self.last_c, 14, -1, 51, 3.0, clamp=False)
        self.to(device)

    def _cal_mask(self, x, L, scaling):
        """The spatially varying mask (deal.py:283)."""
        u = self.spline1(self.M1.convolution(x, L).abs())
        u = self.spline2(F.conv2d(u, self.M2, padding=1).abs())
        u = F.conv2d(u, self.M3, padding=1)
        return self.spline3(scaling * u.abs()).clamp(1e-2, 1.0)

    def _Lt_L(self, x, mask, L):
        return self.W1.transpose(self.W1.convolution(x, L) * mask ** 2, L)

    def _scaling(self, sigma255, B):
        scale_in = torch.ones((B, self.last_c, 1, 1), device=sigma255.device) * sigma255
        return torch.exp(self.spline_scaling(scale_in)) / (sigma255 + 1e-5)

    @torch.no_grad()
    def _solve(self, y, H, Ht, sigma255, lmbda, x_init, n_out, n_in, eps_in, eps_out):
        """The outer loop (deal.py:295): refresh the mask at the iterate, CG
        from the last iterate, stop when the relative change is below
        ``eps_out``."""
        L = self.W1.spectral_norm()
        scaling = self._scaling(sigma255, y.shape[0])
        b = Ht(y) / (1 + lmbda)

        def outer_body(s):
            c_k, c_old, _ = s
            mask = self._cal_mask(c_k, L, scaling)

            def BtB(v):
                return (Ht(H(v)) + lmbda * self._Lt_L(v, mask, L)) / (1 + lmbda)

            c_new = _batched_cg(BtB, b, c_old, n_in, eps_in)
            res = torch.linalg.vector_norm(c_new - c_k) / torch.linalg.vector_norm(c_k).clamp(
                min=1e-12)
            return c_new, c_new, res

        inf = torch.full((), float("inf"), device=y.device)
        (c_k, _, _), _ = device_while(lambda s: s[2] >= eps_out, outer_body,
                                      (x_init, x_init, inf), n_out)
        return c_k

    def mask(self, x, sigma=0.05):
        """The DEAL mask at ``x`` and the noise level ``sigma``
        (deal.py:326). The JAX function broadcasts a per-sample level along
        the last axis and raises for a batch of more than one (ROADMAP queue
        3); here it is per sample."""
        with torch.no_grad():
            sigma255 = torch.full((x.shape[0], 1, 1, 1), 255.0 * float(sigma), dtype=x.dtype,
                                  device=x.device)
            return self._cal_mask(x, self.W1.spectral_norm(), self._scaling(sigma255, x.shape[0]))

    def denoise(self, y, sigma):
        """Denoising (deal.py:337): H the identity, lambda the spline of
        ``255 sigma``, 60 outer and 200 CG iterations at most."""
        sigma255 = torch.as_tensor(255.0 * sigma, dtype=y.dtype, device=y.device).expand(
            y.shape[0]).reshape(-1, 1, 1, 1)
        with torch.no_grad():
            lmbda = self.spline_lambda(sigma255)
        ident = lambda v: v
        out = self._solve(y, ident, ident, sigma255, lmbda, torch.zeros_like(y), n_out=60,
                          n_in=200, eps_in=1e-6, eps_out=1e-5)
        return out.clamp(0.0, 1.0) if self.clamp_output else out

    def solve_inverse_problem(self, y, H, Ht, sigma, lmbda, x_init=None, eps_in: float = 1e-8,
                              eps_out: float = 1e-5):
        """Reconstruction (deal.py:351): ``max_iter`` outer and ``20 max_iter``
        CG iterations at most."""
        if x_init is None:
            x_init = Ht(y) * 0
        sigma255 = torch.full((y.shape[0], 1, 1, 1), float(sigma), dtype=y.dtype,
                              device=y.device)
        out = self._solve(y, H, Ht, sigma255, torch.as_tensor(lmbda, dtype=y.dtype,
                                                              device=y.device),
                          x_init, n_out=self.max_iter, n_in=self.max_iter * 20, eps_in=eps_in,
                          eps_out=eps_out)
        return out.clamp(0.0, 1.0) if self.clamp_output else out

    def forward(self, y, physics=None, sigma=None, **kwargs):
        from ..physics.base import LinearPhysics

        if sigma is None and physics is not None and not isinstance(physics, LinearPhysics):
            sigma, physics = physics, None
        if physics is None or type(physics).__name__ == "Denoising":
            if physics is None and sigma is None:
                raise ValueError("denoising needs sigma when physics is None")
            return self.denoise(y, sigma if physics is None else self.sigma_denoiser)
        return self.solve_inverse_problem(y, physics.A, physics.A_adjoint,
                                          sigma=255.0 * self.sigma_denoiser,
                                          lmbda=self.lambda_reg, x_init=physics.A_adjoint(y))
