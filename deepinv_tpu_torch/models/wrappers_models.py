"""Model adapters and wrappers (port of deepinv_tpu/models/wrappers_models.py):
the gradient-step denoisers, the equivariant and time and complex adapters,
the input-convex network, the exact posterior mean and the noise-level
estimators."""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.kernels.conv_chain import fused_chains_disabled
from ..utils.mixins import TimeMixin
from .base import Denoiser, Reconstructor
from .layers import Conv2d
from .misc_models import ScoreModelWrapper

__all__ = ["GSDRUNet", "EquivariantDenoiser", "TimeAgnosticNet", "TimeAveragingNet",
           "ComplexDenoiser", "to_complex_denoiser", "ICNN", "MMSE", "WaveletNoiseEstimator",
           "PatchCovarianceNoiseEstimator", "GSPnP", "EquivariantReconstructor",
           "DiffusersDenoiserWrapper", "ComplexDenoiserWrapper"]


class GSPnP(Denoiser):
    r"""Gradient-step denoiser over any denoiser ``N`` (wrappers_models.py:298):
    ``D(x) = x - grad_x g(x)`` with ``g(x) = alpha/2 ||x - N(x, sigma)||^2``.

    The gradient is autograd's (:func:`~deepinv_tpu_torch.optim.potential.autograd_grad`),
    with its graph kept where a loss will differentiate it again: in grad mode
    when ``x`` or a parameter of ``N`` requires grad. The kernel ops have no
    second derivative (they raise), so ``N`` then runs under
    ``fused_chains_disabled()``, as its layers; a first-order call (PnP
    inference, the gradient in ``x`` alone) keeps the kernel path.
    """

    def __init__(self, denoiser, alpha: float = 1.0):
        super().__init__()
        self.student = denoiser
        self.alpha = alpha

    def potential(self, x, sigma):
        """``alpha/2 ||x - N(x, sigma)||^2``, summed over the batch."""
        return 0.5 * self.alpha * ((x - self.student(x, sigma)) ** 2).sum()

    def _second_order(self, x) -> bool:
        if not torch.is_grad_enabled():
            return False
        params = self.student.parameters() if isinstance(self.student, nn.Module) else ()
        return x.requires_grad or any(p.requires_grad for p in params)

    def potential_grad(self, x, sigma):
        """``grad_x g(x)`` (wrappers_models.py:313)."""
        from ..optim.potential import autograd_grad

        chains = fused_chains_disabled() if self._second_order(x) else contextlib.nullcontext()
        with chains:
            return autograd_grad(lambda u: self.potential(u, sigma), x)

    def forward(self, x, sigma=0.05, **kwargs):
        return x - self.potential_grad(x, sigma)


class GSDRUNet(GSPnP):
    r"""The gradient-step denoiser over an ELU DRUNet with 2 blocks a stage
    (wrappers_models.py:31).

    :param pretrained: upstream GS-DRUNet weights (a path or a state dict),
        their ``student_grad.model.`` prefix stripped (wrappers_models.py:52-57).
    :param generator: CPU ``torch.Generator`` of the DRUNet's weights.
    :param device: the CUDA device by default.
    :param kwargs: more DRUNet arguments.
    """

    def __init__(self, student=None, alpha: float = 1.0, nb: int = 2, act_mode: str = "E",
                 pretrained=None, generator=None, device=None, **kwargs):
        from .convert import load_torch_checkpoint, port_drunet
        from .drunet import DRUNet

        if student is None:
            student = DRUNet(nb=nb, act_mode=act_mode, generator=generator, device=device,
                             **kwargs)
        super().__init__(student, alpha)
        if pretrained is not None:
            prefix = "student_grad.model."
            sd = {k.removeprefix(prefix): v for k, v in load_torch_checkpoint(pretrained).items()}
            port_drunet(self.student, sd)


class EquivariantDenoiser(Denoiser):
    r"""Monte-Carlo group average ``mean_t t^-1(D(t(x)))``
    (wrappers_models.py:66), over ``transform.n_trans`` transforms drawn from
    the call's ``generator`` (one seeded ``seed`` where it is None); a random
    90-degree rotation by default."""

    def __init__(self, denoiser, transform=None, random: bool = True, seed: int = 0):
        super().__init__()
        if transform is None:
            from ..transform import Rotate

            transform = Rotate(multiples=90)
        self.denoiser = denoiser
        self.transform = transform
        self.random = random
        self.seed = seed

    def forward(self, x, sigma=0.05, generator=None, **kwargs):
        if generator is None:
            generator = torch.Generator(device=x.device).manual_seed(int(self.seed))
        f = self.transform.symmetrize(lambda u: self.denoiser(u, sigma))
        return f(x, generator=generator)


class TimeAgnosticNet(Reconstructor, TimeMixin):
    r"""A 2D network applied frame by frame to ``(B, C, T, H, W)`` data, time
    folded into the batch (wrappers_models.py:98)."""

    def __init__(self, backbone_net):
        super().__init__()
        self.backbone_net = backbone_net

    def forward(self, y, physics=None, **kwargs):
        B, C, T, H, W = y.shape
        flat = y.movedim(2, 1).reshape(B * T, C, H, W)
        out = (self.backbone_net(flat, physics, **kwargs) if physics is not None
               else self.backbone_net(flat))
        return out.reshape(B, T, C, H, W).movedim(1, 2)


class TimeAveragingNet(Reconstructor, TimeMixin):
    r"""A 2D network applied to the time average of ``(B, C, T, H, W)`` data
    (wrappers_models.py:112); where the physics has a mask of the data's
    rank, the average of the acquired frames."""

    def __init__(self, backbone_net):
        super().__init__()
        self.backbone_net = backbone_net

    def forward(self, y, physics=None, **kwargs):
        mask = getattr(physics, "mask", None)
        if isinstance(mask, torch.Tensor) and mask.dim() == y.dim():
            y2d = (y * mask).sum(2) / mask.sum(2).clamp_min(1e-6)
        else:
            y2d = y.mean(2)
        return (self.backbone_net(y2d, physics, **kwargs) if physics is not None
                else self.backbone_net(y2d))


class ComplexDenoiser(Denoiser):
    r"""A real denoiser on a complex image's real and imaginary parts, stacked
    as channels or, with ``separate``, one at a time (wrappers_models.py:130)."""

    def __init__(self, denoiser, separate: bool = False):
        super().__init__()
        self.denoiser = denoiser
        self.separate = separate

    def forward(self, x, sigma=0.05, **kwargs):
        if not torch.is_complex(x):
            return self.denoiser(x, sigma)
        re, im = x.real, x.imag
        if self.separate:
            return torch.complex(self.denoiser(re, sigma), self.denoiser(im, sigma))
        out = self.denoiser(torch.cat([re, im], dim=1), sigma)
        C = x.shape[1]
        return torch.complex(out[:, :C], out[:, C:])


def to_complex_denoiser(denoiser, **kwargs):
    """``ComplexDenoiser(denoiser, **kwargs)`` (wrappers_models.py:150)."""
    return ComplexDenoiser(denoiser, **kwargs)


ComplexDenoiserWrapper = ComplexDenoiser


class ICNN(nn.Module):
    r"""Input-convex neural network (wrappers_models.py:154): softplus-
    reparametrized, hence non-negative, weights on the hidden path make the
    scalar output convex in ``x``.

    :param generator: CPU ``torch.Generator`` of the He-normal initialization.
    :param device: the CUDA device by default.
    """

    def __init__(self, in_channels: int = 3, dim_hidden: int = 64, depth: int = 4,
                 generator=None, device=None):
        device = resolve_device(device)
        super().__init__()
        g = generator
        self.w_x = nn.ModuleList([Conv2d(in_channels, dim_hidden, 3, 1, 1, generator=g)
                                  for _ in range(depth)])
        self.w_z = nn.ModuleList([Conv2d(dim_hidden, dim_hidden, 3, 1, 1, bias=False,
                                         generator=g) for _ in range(depth - 1)])
        self.final = Conv2d(dim_hidden, 1, 3, 1, 1, generator=g)
        self.to(device)

    @staticmethod
    def _pos_conv(conv, z):
        """``conv`` with its weight through softplus (wrappers_models.py:207)."""
        b = conv.bias
        return F.conv2d(z, F.softplus(conv.weight), None if b is None else b, 1, conv.padding)

    def fn(self, x):
        """The potential, one value a sample (wrappers_models.py:168)."""
        z = F.softplus(self.w_x[0](x))
        for wx, wz in zip(self.w_x[1:], self.w_z):
            z = F.softplus(wx(x) + self._pos_conv(wz, z))
        return self._pos_conv(self.final, z).reshape(x.shape[0], -1).sum(1)

    def forward(self, x):
        return self.fn(x)

    def grad(self, x):
        """``grad_x sum fn(x)`` by autograd (wrappers_models.py:179)."""
        from ..optim.potential import autograd_grad

        return autograd_grad(self.fn, x)

    @torch.no_grad()
    def initialize_weights(self, min_val: float = 0.0, max_val: float = 0.001, generator=None):
        """Redraw the convex path's raw weights (each ``w_z`` and ``final``)
        uniformly in ``[min_val, max_val]`` from ``generator`` (a CPU
        ``torch.Generator``, seed 0 by default; wrappers_models.py:182).
        Returns the module."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for conv in list(self.w_z) + [self.final]:
            u = torch.rand(conv.weight.shape, generator=generator)
            conv.weight.copy_(min_val + (max_val - min_val) * u)
        return self

    @torch.no_grad()
    def zero_clip_weights(self):
        """Clamp the convex path's raw weights at 0 from below
        (wrappers_models.py:197). Returns the module."""
        for conv in list(self.w_z) + [self.final]:
            conv.weight.clamp_(min=0.0)
        return self


class MMSE(Reconstructor):
    r"""The exact posterior mean over a finite set of signals under Gaussian
    noise (wrappers_models.py:224): ``sum_i x_i p(y|x_i) / sum_i p(y|x_i)``.

    :param dataset: the signals, anything indexable with a length.
    :param device: where they are kept; the CUDA device by default.
    """

    def __init__(self, dataset, sigma: float = 0.1, device=None):
        device = resolve_device(device)
        super().__init__()
        xs = torch.stack([torch.as_tensor(dataset[i]) for i in range(len(dataset))])
        self.register_buffer("xs", xs.to(device))
        self.sigma = sigma

    def forward(self, y, physics, **kwargs):
        logs = []
        for xi in self.xs:
            r = physics.A(xi[None]) - y
            logs.append(-(r.abs() ** 2).sum(tuple(range(1, r.dim()))) / (2 * self.sigma ** 2))
        w = torch.softmax(torch.stack(logs), dim=0)                       # (N, B)
        return torch.tensordot(w.T, self.xs, dims=([1], [0]))


class WaveletNoiseEstimator(nn.Module):
    r"""``sigma`` as the median absolute finest diagonal wavelet detail over
    0.6745 (wrappers_models.py:248)."""

    def __init__(self, wv: str = "db4"):
        from ..ops.wavelets import WaveletTransform

        super().__init__()
        self.wt = WaveletTransform(wavelet=wv, level=1)

    def estimate_noise(self, x):
        """The MAD estimate, one a sample (wrappers_models.py:257)."""
        hh = self.wt.dwt2(x)["coeffs"][1][2]
        return hh.abs().reshape(x.shape[0], -1).quantile(0.5, dim=1) / 0.6745

    def forward(self, y, **kwargs):
        return self.estimate_noise(y)


class PatchCovarianceNoiseEstimator(nn.Module):
    r"""``sigma`` as the square root of the median eigenvalue of the patches'
    covariance (wrappers_models.py:269)."""

    def __init__(self, patch_size: int = 8, stride: int = 4):
        super().__init__()
        self.patch_size = patch_size
        self.stride = stride

    def forward(self, y, **kwargs):
        return self.estimate_noise(y)

    def estimate_noise(self, y):
        """One estimate a sample (wrappers_models.py:282)."""
        P = F.unfold(y, self.patch_size, stride=self.stride).transpose(1, 2)   # (B, N, d)
        P = P - P.mean(1, keepdim=True)
        cov = P.transpose(1, 2) @ P / (P.shape[1] - 1)
        eig = torch.linalg.eigvalsh(cov)
        return eig.quantile(0.5, dim=1).clamp_min(0.0).sqrt()


def _transformed_physics(physics, transform, params):
    """``A T_g`` with adjoint ``T_g^-1 A^T`` as a plain ``LinearPhysics``
    (wrappers_models.py:319), so that its prox and pseudo-inverse take the
    generic Krylov path of the composed operator."""
    from ..physics.base import LinearPhysics

    return LinearPhysics(A=lambda x: physics.A(transform.transform(x, **params)),
                         A_adjoint=lambda y: transform.inverse(physics.A_adjoint(y), **params))


class EquivariantReconstructor(Reconstructor):
    r"""Reynolds-averaged reconstructor ``mean_g T_g R(y, A T_g)``
    (wrappers_models.py:333), over ``transform.n_trans`` transforms drawn from
    the call's ``generator`` (one seeded ``seed`` where it is None); a random
    90-degree rotation by default."""

    def __init__(self, model, transform=None, seed: int = 0):
        super().__init__()
        if transform is None:
            from ..transform import Rotate

            transform = Rotate(multiples=90.0)
        self.model = model
        self.transform = transform
        self.seed = seed

    def forward(self, y, physics, generator=None, **kwargs):
        x0 = physics.A_adjoint(y)
        if generator is None:
            generator = torch.Generator(device=x0.device).manual_seed(int(self.seed))
        B = x0.shape[0]
        params = self.transform.get_params(x0, generator)
        out = 0.0
        for i in range(self.transform.n_trans):
            p_i = {k: v[i * B:(i + 1) * B] for k, v in params.items()}
            x_g = self.model(y, _transformed_physics(physics, self.transform, p_i), **kwargs)
            out = out + self.transform.transform(x_g, **p_i)
        return out / self.transform.n_trans


class DiffusersDenoiserWrapper(ScoreModelWrapper):
    """The ``diffusers`` UNet adapter (wrappers_models.py:368). It needs the
    ``diffusers`` package and downloaded weights, so it raises, as the JAX
    one does; :class:`~deepinv_tpu_torch.models.ScoreModelWrapper` wraps any
    score network."""

    def __init__(self, *args, **kwargs):
        raise ImportError(
            "DiffusersDenoiserWrapper requires the 'diffusers' package and downloaded "
            "pretrained weights. Wrap a score network in ScoreModelWrapper instead.")
