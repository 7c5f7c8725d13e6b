"""SURE's divergence estimators (port of deepinv_tpu/loss/sure.py): the
exact, Hutchinson and Monte-Carlo divergence of ``y -> A(f(y))``, normalised
by the pixels of a batch element.

:func:`exact_div` and :func:`hutch_div` differentiate the model (a Jacobian,
a forward-mode JVP as ``jax.jvp`` there). The kernel ops have no
forward-mode rule and no second derivative (``first_order_only``), so both
run the model with the kernel gates closed (``fused_chains_disabled()``), as
``GSPnP`` does: DnCNN's and DRUNet's chains run as layers here.
:func:`mc_div` is a finite difference and keeps the kernels.
"""

from __future__ import annotations

import torch
import torch.autograd.forward_ad as fwAD

from ..ops.kernels.conv_chain import fused_chains_disabled

__all__ = ["exact_div", "hutch_div", "mc_div"]


def _bmean(t):
    return t.reshape(t.shape[0], -1).mean(1)


def _normal(y, generator):
    return torch.randn(y.shape, generator=generator, device=y.device, dtype=y.dtype)


def exact_div(y, physics, model):
    """Exact pixel-normalised divergence of ``y -> A(model(y, physics))``,
    the Jacobian's trace over the pixels of a sample (sure.py:27); small
    images only. Differentiable where grad mode is on."""
    n = y.numel()
    with fused_chains_disabled():
        J = torch.autograd.functional.jacobian(lambda v: physics.A(model(v, physics)), y,
                                               create_graph=torch.is_grad_enabled())
    return torch.trace(J.reshape(n, n)) / (n // y.shape[0])


def hutch_div(y, physics, f, mc_iter: int = 1, generator=None, probes=None):
    """Hutchinson estimate ``E_b[mean(b * J b)]`` with N(0, I) probes, per
    sample, averaged over ``mc_iter`` probes (sure.py:37), each ``J b`` a
    forward-mode JVP.

    :param probes: the ``mc_iter`` probes; drawn from ``generator`` if None.
    """
    out = 0.0
    for i in range(mc_iter):
        b = probes[i] if probes is not None else _normal(y, generator)
        b = torch.as_tensor(b, dtype=y.dtype, device=y.device)
        with fused_chains_disabled(), fwAD.dual_level():
            _, jvp_b = fwAD.unpack_dual(physics.A(f(fwAD.make_dual(y, b), physics)))
        out = out + _bmean(b * jvp_b)
    return out / mc_iter


def mc_div(y1, y, f, physics, tau: float, precond=lambda x: x, generator=None, probe=None):
    """Monte-Carlo divergence ``mean(b * (A f(y + tau b) - y1)) / tau`` per
    sample (sure.py:49), ``y1 = A(f(y))``.

    :param probe: the N(0, I) probe ``b``; drawn from ``generator`` if None.
    """
    b = probe if probe is not None else _normal(y, generator)
    b = torch.as_tensor(b, dtype=y.dtype, device=y.device)
    y2 = physics.A(f(y + b * tau, physics))
    return _bmean(precond(b) * precond(y2 - y1) / tau)
