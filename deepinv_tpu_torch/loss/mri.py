"""MRI self-supervised losses (port of deepinv_tpu/loss/mri.py):
:class:`WeightedSplittingLoss`, :class:`RobustSplittingLoss`,
:class:`Phase2PhaseLoss`, :class:`Artifact2ArtifactLoss` and
:class:`ENSURELoss`.

The k-space weight of the weighted losses and ENSURE's density come from a
generator's Monte-Carlo mean (:meth:`PhysicsGenerator.average`), made at
construction as in the JAX package; the port averages its draws in batches
of 100 (the JAX package draws one a step), and each can be handed in
(``weight=``, ``density=``).
"""

from __future__ import annotations

import torch
import torch.autograd.forward_ad as fwAD

from ..ops.kernels.conv_chain import fused_chains_disabled
from .base import Loss
from .measplit import SplittingModel, sample_split_mask, split
from .metric import MSE

__all__ = ["WeightedSplittingLoss", "RobustSplittingLoss", "Phase2PhaseLoss",
           "Artifact2ArtifactLoss", "ENSURELoss"]

_AVERAGE_BATCH = 100


class WeightedSplittingLoss(Loss):
    r"""K-weighted Noisier2Noise-SSDU (mri.py:25): the split residual is
    weighted in k-space by ``(1 - K)^{-1/2}``, ``K = (1 - P~ P)^{-1} (1 -
    P)`` of the 1-D sampling densities ``P`` (acceleration masks) and
    ``P~`` (splitting masks).

    :param weight: the weight itself, ``(1, W)``; computed from the two
        generators (:meth:`compute_weight`) if None and a
        ``physics_generator`` is given, else 1.
    """

    def __init__(self, mask_generator, physics_generator=None, metric=None, eps: float = 1e-9,
                 weight=None):
        self.mask_generator = mask_generator
        self.physics_generator = physics_generator
        self.metric = metric if metric is not None else MSE()
        self.eps = eps
        if weight is not None:
            self.weight = torch.as_tensor(weight)
        elif physics_generator is not None:
            self.weight = self.compute_weight(mask_generator, physics_generator, eps=eps)
        else:
            self.weight = torch.tensor(1.0)

    @staticmethod
    def compute_weight(mask_generator, physics_generator, eps: float = 1e-9, img_size=None,
                       n: int = 2000, generator=None, P=None, P_tilde=None):
        """``(1 - K)^{-1/2}`` as ``(1, W)`` (mri.py:50): the densities are the
        generators' means over ``n`` draws (or ``P`` and ``P_tilde`` as
        given), reduced to their first row."""
        kwargs = {} if img_size is None else {"img_size": img_size}
        if P is None:
            P = physics_generator.average(n=n, batch_size=_AVERAGE_BATCH, generator=generator,
                                          **kwargs)["mask"]
        if P_tilde is None:
            P_tilde = mask_generator.average(n=n, batch_size=_AVERAGE_BATCH,
                                             generator=generator, **kwargs)["mask"]
        P, P_tilde = torch.as_tensor(P), torch.as_tensor(P_tilde)
        if P.shape[-2:] != P_tilde.shape[-2:]:
            raise ValueError("physics_generator and mask_generator should produce same size "
                             "masks.")
        while P.dim() > 1:
            P, P_tilde = P[0], P_tilde[0]
        P_tilde = torch.minimum(P_tilde, torch.tensor(1 - eps, dtype=P_tilde.dtype))
        k_weight = (1 - P) / torch.clamp(1 - P_tilde * P, min=eps)
        return torch.clamp(1 - k_weight[None], min=eps) ** (-0.5)

    def _forward(self, y, physics, model, generator, mask=None):
        """One split and model pass: ``(x1, mask1)`` (mri.py:70)."""
        if isinstance(model, SplittingModel):
            return model(y, physics, generator=generator, train=True, return_mask=True,
                         masks=None if mask is None else [mask])
        if mask is None:
            mask = sample_split_mask(y, physics, generator, 0.6, True, self.mask_generator)
        y1, p1 = split(mask, y, physics)
        return model(y1, p1), mask

    def _recon_loss(self, x1, mask1, y, physics):
        base_mask = getattr(physics, "mask", None)
        base = base_mask if base_mask is not None else 1.0
        w = self.weight.to(y.device) * (base - mask1 * base)
        return self.metric(w * physics.A(x1), w * y)

    def __call__(self, x_net=None, y=None, physics=None, model=None, generator=None, mask=None,
                 **kwargs):
        """``mask``: the split's mask, drawn from ``generator`` if None."""
        x1, mask1 = self._forward(y, physics, model, generator, mask)
        return self._recon_loss(x1, mask1, y, physics)

    def adapt_model(self, model):
        """The splitting wrapper; evaluation on the whole input
        (mri.py:98)."""
        if isinstance(model, SplittingModel):
            return model
        return SplittingModel(model, mask_generator=self.mask_generator, eval_n_samples=1,
                              eval_split_input=False, pixelwise=True)


class RobustSplittingLoss(WeightedSplittingLoss):
    r"""Robust-SSDU (mri.py:111): weighted splitting on a further-noised
    split input (std ``alpha sigma``) plus the Noisier2Noise term
    ``||(1 + 1/alpha^2) M_1 M (A(x_net) - y)||^2``."""

    def __init__(self, mask_generator, physics_generator=None, noise_model=None,
                 alpha: float = 0.75, metric=None, weight=None):
        from ..physics.noise import GaussianNoise

        super().__init__(mask_generator, physics_generator, metric, weight=weight)
        if noise_model is None:
            noise_model = GaussianNoise(0.1, device="cpu")
        self.alpha = alpha
        self.noise_model = noise_model.update(sigma=noise_model.sigma * alpha)

    def __call__(self, x_net=None, y=None, physics=None, model=None, generator=None, mask=None,
                 **kwargs):
        x1, mask1 = self._forward(y, physics, model, generator, mask)
        recon_loss = self._recon_loss(x1, mask1, y, physics)
        base_mask = getattr(physics, "mask", None)
        base = base_mask if base_mask is not None else 1.0
        resid = (1 + 1 / self.alpha ** 2) * mask1 * base * (physics.A(x1) - y)
        return recon_loss + (resid.abs().reshape(y.shape[0], -1) ** 2).mean(1)

    def adapt_model(self, model):
        """The splitting wrapper that noises its split input in training
        (mri.py:146)."""
        if isinstance(model, SplittingModel):
            return model
        return SplittingModel(model, mask_generator=self.mask_generator, eval_n_samples=1,
                              eval_split_input=False, pixelwise=True,
                              noise_model=self.noise_model)


class Phase2PhaseLoss(Loss):
    r"""Phase2Phase for dynamic MRI (mri.py:160): the even frames predict
    the odd ones.

    :param device: where the splitting masks are made; the CUDA device by
        default.
    """

    def __init__(self, img_size, metric=None, device=None):
        from ..physics.generator import Phase2PhaseSplittingMaskGenerator

        self.generator = Phase2PhaseSplittingMaskGenerator(img_size, device=device)
        self.metric = metric if metric is not None else MSE()

    def __call__(self, x_net=None, y=None, physics=None, model=None, generator=None, mask=None,
                 **kwargs):
        """``mask``: the split (frames in), drawn from ``generator`` if None."""
        base_mask = getattr(physics, "mask", 1.0)
        if isinstance(model, SplittingModel):
            x1, sp = model(y, physics, generator=generator, train=True, return_mask=True,
                           masks=None if mask is None else [mask])
            m2 = base_mask - sp
        else:
            sp = (torch.as_tensor(mask, device=y.device) if mask is not None else
                  self.generator.step(y.shape[0], generator=generator)["mask"].to(y.device))
            m1 = sp * base_mask
            m2 = (1 - sp) * base_mask
            x1 = model(m1 * y, physics.update(mask=m1))
        return self.metric(m2 * physics.update(mask=m2).A(x1), m2 * y)

    def adapt_model(self, model):
        """The frame-splitting wrapper; evaluation on the whole input
        (mri.py:186)."""
        if isinstance(model, SplittingModel):
            return model
        return SplittingModel(model, mask_generator=self.generator, eval_n_samples=1,
                              eval_split_input=False, pixelwise=True)


class Artifact2ArtifactLoss(Phase2PhaseLoss):
    r"""Artifact2Artifact (mri.py:199): a random chunk of ``split_size``
    frames in, another scored."""

    def __init__(self, img_size, split_size: int = 2, metric=None, device=None):
        from ..physics.generator import Artifact2ArtifactSplittingMaskGenerator

        self.generator = Artifact2ArtifactSplittingMaskGenerator(img_size, split_size,
                                                                 device=device)
        self.metric = metric if metric is not None else MSE()


class ENSURELoss(Loss):
    r"""ENSURE (mri.py:210): SURE with a forward-mode JVP divergence (the
    model run with the kernel gates closed, as in ``SureGaussianLoss``) and
    the residual weighted by ``W^{-1/2}``, ``W = E[mask]`` over the
    physics generator.

    :param density: ``W`` itself; the generator's mean if None.
    """

    def __init__(self, sigma: float, physics_generator=None, tau: float = 1e-2, density=None):
        self.sigma = sigma
        self.physics_generator = physics_generator
        self.tau = tau
        if density is None and physics_generator is not None:
            density = physics_generator.average(batch_size=_AVERAGE_BATCH)["mask"]
        self.dsqrti = (None if density is None else
                       1.0 / torch.sqrt(torch.clamp(torch.as_tensor(density), min=1e-8)))

    def __call__(self, x_net=None, y=None, physics=None, model=None, generator=None,
                 probe=None, **kwargs):
        """``probe``: the N(0, I) probe, drawn from ``generator`` if None."""
        b = (torch.as_tensor(probe, dtype=y.dtype, device=y.device) if probe is not None else
             torch.randn(y.shape, generator=generator, device=y.device, dtype=y.dtype))
        with fused_chains_disabled(), fwAD.dual_level():
            y1, jvp_b = fwAD.unpack_dual(physics.A(model(fwAD.make_dual(y, b), physics)))
        div = 2 * self.sigma ** 2 * (b * jvp_b).reshape(y.shape[0], -1).mean(1)
        resid = y1 - y
        if self.dsqrti is not None:
            resid = resid * self.dsqrti.to(y.device)
        return (resid ** 2).reshape(y.shape[0], -1).mean(1) + div - self.sigma ** 2
