"""Unrolled reconstruction networks: MoDL, VarNet, PDNet, PanNet (port of
deepinv_tpu/models/unrolled.py)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..optim.data_fidelity import L2
from ..optim.optimizers import BaseOptim
from ..optim.prior import PnP
from ..physics.mri import MRIMixin
from .base import Reconstructor
from .dncnn import DnCNN
from .layers import Conv2d
from .unet import UNet

__all__ = ["MoDL", "VarNet", "VarNetBlock", "PDNet", "PDNet_PrimalBlock", "PDNet_DualBlock",
           "PanNet"]


class MoDL(BaseOptim):
    r"""Model-based deep learning for MRI (unrolled.py:23): ``num_iter``
    unrolled HQS steps with a trainable denoiser as the prox, by default a
    depth-7, 2-channel DnCNN, and a trainable schedule (``unfold=True``: the
    schedule's entries are ``nn.Parameter``\\ s, ``param_stepsize`` ...).

    :param denoiser: the prox; a ``DnCNN(2, 2, depth=7)`` from ``generator``
        where None.
    :param generator: CPU ``torch.Generator`` of the default DnCNN's weights.
    :param device: the CUDA device by default.
    """

    def __init__(self, denoiser=None, num_iter: int = 3, generator=None, device=None):
        device = resolve_device(device)
        if denoiser is None:
            denoiser = DnCNN(in_channels=2, out_channels=2, depth=7, generator=generator,
                             device=device)
        super().__init__("HQS", data_fidelity=L2(), prior=PnP(denoiser),
                         params_algo={"stepsize": [1.0] * num_iter, "lambda": 1.0,
                                      "g_param": 0.05},
                         max_iter=num_iter, unfold=True, device=device)


class VarNetBlock(nn.Module):
    r"""One VarNet cascade (unrolled.py:40):
    ``x <- x - w A^T(A x - y) - D(x)`` with a trainable weight ``w``."""

    def __init__(self, denoiser):
        super().__init__()
        self.denoiser = denoiser
        self.dc_weight = nn.Parameter(torch.ones(()))

    def forward(self, x, y, physics):
        dc = physics.A_adjoint(physics.A(x) - y)
        return x - self.dc_weight * dc - self.denoiser(x, None)


class VarNet(MRIMixin, Reconstructor):
    r"""(E2E-)VarNet MRI reconstructor (unrolled.py:54): ``num_cascades``
    cascades from ``A^T y``, each with its own 3-scale, 16-channel UNet
    without norms where no ``denoiser`` is given (one shared ``denoiser``
    otherwise).

    :param generator: CPU ``torch.Generator`` of the UNets' weights.
    :param device: the CUDA device by default.
    """

    def __init__(self, denoiser=None, num_cascades: int = 8, mode: str = "varnet",
                 generator=None, device=None):
        device = resolve_device(device)
        super().__init__()
        if denoiser is None:
            blocks = [VarNetBlock(UNet(2, 2, scales=3, base=16, residual=False, batch_norm=False,
                                       generator=generator, device=device))
                      for _ in range(num_cascades)]
        else:
            blocks = [VarNetBlock(denoiser) for _ in range(num_cascades)]
        self.blocks = nn.ModuleList(blocks)
        self.mode = mode
        self.to(device)

    def backbone_inference(self, tensor_in, physics, y):
        """The cascades on ``tensor_in`` with ``(physics, y)`` data
        consistency (unrolled.py:70)."""
        x = tensor_in
        for b in self.blocks:
            x = b(x, y, physics)
        return x

    def forward(self, y, physics, **kwargs):
        return self.backbone_inference(physics.A_adjoint(y), physics, y)


class PDNet_PrimalBlock(nn.Module):
    """conv - ReLU - conv - ReLU - conv at 32 channels (unrolled.py:82)."""

    def __init__(self, in_ch: int = 7, out_ch: int = 5, generator=None):
        super().__init__()
        self.c1 = Conv2d(in_ch, 32, 3, 1, 1, generator=generator)
        self.c2 = Conv2d(32, 32, 3, 1, 1, generator=generator)
        self.c3 = Conv2d(32, out_ch, 3, 1, 1, generator=generator)

    def forward(self, h):
        return self.c3(F.relu(self.c2(F.relu(self.c1(h)))))


class PDNet_DualBlock(PDNet_PrimalBlock):
    """The dual update's block (unrolled.py:97)."""


class PDNet(Reconstructor):
    r"""Learned primal-dual reconstruction (unrolled.py:101): ``num_iter``
    unrolled Chambolle-Pock steps whose primal and dual updates are small
    CNNs on ``n_primal`` / ``n_dual`` stacked copies of the iterates.

    :param generator: CPU ``torch.Generator`` of the blocks' weights.
    :param device: the CUDA device by default.
    """

    def __init__(self, num_iter: int = 5, n_primal: int = 5, n_dual: int = 5,
                 n_channels: int = 1, generator=None, device=None):
        device = resolve_device(device)
        super().__init__()
        C, g = n_channels, generator
        primal, dual = [], []
        for _ in range(num_iter):
            primal.append(PDNet_PrimalBlock((n_primal + 1) * C, n_primal * C, generator=g))
            dual.append(PDNet_DualBlock((n_dual + 2) * C, n_dual * C, generator=g))
        self.primal_blocks = nn.ModuleList(primal)
        self.dual_blocks = nn.ModuleList(dual)
        self.n_primal = n_primal
        self.n_dual = n_dual
        self.to(device)

    def forward(self, y, physics, **kwargs):
        x0 = physics.A_adjoint(y)
        C = x0.shape[1]
        primal = x0.repeat(1, self.n_primal, 1, 1)
        dual = y.new_zeros((y.shape[0], self.n_dual * y.shape[1]) + tuple(y.shape[2:]))
        for pb, db in zip(self.primal_blocks, self.dual_blocks):
            dual = dual + db(torch.cat([dual, physics.A(primal[:, C:2 * C]), y], dim=1))
            primal = primal + pb(torch.cat([primal, physics.A_adjoint(dual[:, :C])], dim=1))
        return primal[:, :C]


class PanNet(Reconstructor):
    r"""PanNet pansharpening (unrolled.py:135): the bicubic-upsampled
    multispectral image plus a residual CNN's detail, computed from the
    high-passed upsampled multispectral image and the high-passed
    panchromatic one.

    :param generator: CPU ``torch.Generator`` of the convs' weights.
    :param device: the CUDA device by default.
    """

    def __init__(self, hrms_shape=(3, 32, 32), nf: int = 32, n_blocks: int = 4,
                 scale_factor: int = 4, highpass_kernel_size: int = 5, generator=None,
                 device=None):
        device = resolve_device(device)
        super().__init__()
        C, g = hrms_shape[0], generator
        self.hrms_shape = tuple(hrms_shape)
        self.scale_factor = scale_factor
        self.highpass_kernel_size = highpass_kernel_size
        self.device = device
        self.head = Conv2d(C + 1, nf, 3, 1, 1, generator=g)
        self.blocks = nn.ModuleList([
            nn.ModuleList([Conv2d(nf, nf, 3, 1, 1, generator=g), Conv2d(nf, nf, 3, 1, 1,
                                                                        generator=g)])
            for _ in range(n_blocks)])
        self.tail = Conv2d(nf, C, 3, 1, 1, generator=g)
        self.to(device)

    def highpass(self, x):
        """``x`` minus its ``k x k`` box mean, edges replicated
        (unrolled.py:155)."""
        from ..ops.conv import conv2d

        k = self.highpass_kernel_size
        box = x.new_full((1, 1, k, k), 1.0 / (k * k))
        return x - conv2d(x, box, padding="replicate")

    def create_sampler(self, direction: str, hr_shape, noise_gain: float = 0.0):
        """The bicubic ``Downsampling`` by ``scale_factor`` of the Wald
        protocol's reduced-resolution training (unrolled.py:164), with
        ``PoissonNoise(noise_gain, clip_positive=True)`` where the gain is
        positive: the physics for ``"down"``, its adjoint otherwise."""
        from ..physics import Downsampling, PoissonNoise
        from ..physics.base import replace

        sampler = Downsampling(img_size=hr_shape, factor=self.scale_factor, filter="bicubic",
                               device=self.device)
        if noise_gain > 0:
            sampler = replace(sampler, noise_model=PoissonNoise(
                gain=noise_gain, clip_positive=True, device=self.device))
        return sampler if direction == "down" else sampler.A_adjoint

    def forward(self, y, physics, **kwargs):
        color_lr, pan = y[0], y[1]
        f2 = physics.factor ** 2
        up = physics.downsampling.A_adjoint(color_lr) * f2
        lr_hp_up = physics.downsampling.A_adjoint(self.highpass(color_lr)) * f2
        h = F.relu(self.head(torch.cat([lr_hp_up, self.highpass(pan)], dim=1)))
        for c1, c2 in self.blocks:
            h = h + c2(F.relu(c1(h)))
        return up + self.tail(h)
