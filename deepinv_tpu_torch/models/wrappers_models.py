"""Model adapters (port of deepinv_tpu/models/wrappers_models.py): the
input-convex network, the default learned potential of
:class:`~deepinv_tpu_torch.optim.Bregman_ICNN`. The file's other wrappers
(``GSDRUNet``, ``EquivariantDenoiser``, the time and complex adapters,
``MMSE``, the noise-level estimators) belong to ROADMAP queue 1 item 1.8e."""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .layers import Conv2d

__all__ = ["ICNN"]


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
