"""Augmentation-based self-supervised losses (port of
deepinv_tpu/loss/augmentation.py): :class:`AugmentConsistencyLoss`,
:class:`EquivariantSplittingLoss` and :class:`ReducedResolutionLoss`."""

from __future__ import annotations

import torch
from torch import nn

from .base import Loss
from .metric import MSE

__all__ = ["AugmentConsistencyLoss", "EquivariantSplittingLoss", "ReducedResolutionLoss"]


def _transformed_physics(physics, transform, params):
    """``A T^-1`` with adjoint ``T A^T`` (augmentation.py:31)."""
    from ..physics.base import LinearPhysics

    return LinearPhysics(A=lambda x: physics.A(transform.inverse(x, **params)),
                         A_adjoint=lambda y: transform.transform(physics.A_adjoint(y), **params))


class AugmentConsistencyLoss(Loss):
    r"""Data-augmentation consistency (augmentation.py:40, VORTEX):
    ``metric(T_e x_net, R(A T_e^-1 T_e A^T T_i y))``: the model is to be
    invariant to the measurement-domain action ``T_i`` and equivariant to the
    image-domain action ``T_e``.

    :param T_i: invariant transform of ``y`` (default: the identity).
    :param T_e: equivariant transform (default: ``Shift() * Rotate(15, 15)``).
    :param no_grad: no gradient through the unaugmented branch.
    """

    def __init__(self, T_i=None, T_e=None, metric=None, no_grad: bool = True):
        from ..transform import Identity, Rotate, Shift

        self.metric = metric if metric is not None else MSE()
        self.T_i = T_i if T_i is not None else Identity()
        self.T_e = T_e if T_e is not None else (Shift() * Rotate(multiples=15.0, limits=15.0))
        self.no_grad = no_grad

    def __call__(self, x_net=None, y=None, physics=None, model=None, generator=None,
                 e_params=None, i_params=None, **kwargs):
        """``e_params``, ``i_params``: the two transforms' parameters, drawn
        from ``generator`` in that order if None."""
        if self.no_grad:
            x_net = x_net.detach()
        if e_params is None:
            e_params = self.T_e.get_params(x_net, generator)
        if i_params is None:
            i_params = self.T_i.get_params(y, generator)
        y_i = self.T_i.transform(y, **i_params)
        x_aug = self.T_e.transform(physics.A_adjoint(y_i), **e_params)
        phys2 = _transformed_physics(physics, self.T_e, e_params)
        x_aug_net = model(phys2.A(x_aug), phys2)
        return self.metric(self.T_e.transform(x_net, **e_params), x_aug_net)


class EquivariantSplittingLoss(Loss):
    r"""Equivariant splitting (augmentation.py:73): the problem is moved by
    a random ``T_g``, its measurements split by a Bernoulli mask, the model
    reconstructs from the kept part, and the loss is the consistency on the
    kept part plus the prediction of the rest, each normalised by its share.
    The model should be equivariant
    (:class:`~deepinv_tpu_torch.models.EquivariantReconstructor`).

    :param transform: ``T_g`` (default: 90-degree rotations).
    :param split_ratio: the share of measurements kept as input.
    """

    def __init__(self, transform=None, metric=None, split_ratio: float = 0.9,
                 pixelwise: bool = True):
        from ..transform import Rotate

        self.metric = metric if metric is not None else MSE()
        self.transform = transform if transform is not None else Rotate(multiples=90.0)
        self.split_ratio = split_ratio
        self.pixelwise = pixelwise

    def _mask(self, y, generator):
        shape = list(y.shape)
        if self.pixelwise and len(shape) > 2:
            shape[1] = 1
        dev = generator.device if generator is not None else y.device
        m = (torch.rand(shape, generator=generator, device=dev) < self.split_ratio)
        return m.to(y.device, y.dtype).broadcast_to(y.shape)

    def __call__(self, x_net=None, y=None, physics=None, model=None, generator=None,
                 params=None, mask=None, **kwargs):
        """``params``: ``T_g``'s parameters; ``mask``: the split; each drawn
        from ``generator`` in that order if None."""
        from ..physics.base import LinearPhysics

        if params is None:
            params = self.transform.get_params(physics.A_adjoint(y), generator)
        phys_g = _transformed_physics(physics, self.transform, params)
        mask = (self._mask(y, generator) if mask is None else
                torch.as_tensor(mask, dtype=y.dtype, device=y.device))
        phys1 = LinearPhysics(A=lambda x: mask * phys_g.A(x),
                              A_adjoint=lambda v: phys_g.A_adjoint(mask * v))
        yhat = phys_g.A(model(mask * y, phys1))
        consistency = self.metric(mask * yhat, mask * y) / max(self.split_ratio, 1e-6)
        prediction = self.metric((1 - mask) * yhat, (1 - mask) * y) / max(
            1 - self.split_ratio, 1e-6)
        return consistency + prediction


class ReducedResolutionLoss(Loss):
    r"""Reduced-resolution loss (augmentation.py:122, Wald's protocol):
    ``metric(R(A y), y)``; the adapted model reconstructs from the
    measurement degraded again, so the loss is ``metric(x_net, y)``.

    :param physics: the degradation, by default the training physics.
    """

    class ReducedResolutionModel(nn.Module):
        """The Wald-protocol wrapper (augmentation.py:130): in training
        (``nn.Module``'s mode, the JAX wrapper's ``training`` flag) the model
        takes ``physics(y)``; in evaluation ``y``."""

        def __init__(self, model, physics=None):
            super().__init__()
            self.model = model
            self.physics = physics

        def forward(self, y, physics, **kwargs):
            if self.training:
                phys = self.physics if self.physics is not None else physics
                return self.model(phys(y), phys)
            return self.model(y, physics)

    def __init__(self, metric=None, physics=None):
        self.metric = metric if metric is not None else MSE()
        self.physics = physics

    def adapt_model(self, model):
        """Wrap ``model`` in :class:`ReducedResolutionModel`
        (augmentation.py:152)."""
        if isinstance(model, ReducedResolutionLoss.ReducedResolutionModel):
            return model
        return self.ReducedResolutionModel(model, self.physics)

    def __call__(self, x_net=None, y=None, physics=None, model=None, generator=None, **kwargs):
        return self.metric(x_net, y)
