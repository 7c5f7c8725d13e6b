"""Bregman potentials of mirror descent (port of deepinv_tpu/optim/bregman.py)."""

from __future__ import annotations

import torch

from .potential import Potential

__all__ = ["Bregman", "BregmanL2", "BurgEntropy", "NegEntropy", "Bregman_ICNN"]


class Bregman(Potential):
    """Base Bregman potential ``h`` (deepinv_tpu/optim/bregman.py:13): ``grad``
    and ``grad_conj``, the inverse of ``grad``. ``Bregman(phi=callable)``
    wraps a plain potential; its ``grad`` is autograd, ``grad_conj`` must be
    supplied by a subclass."""

    def __init__(self, phi=None):
        super().__init__(fn=phi)

    def grad_conj(self, xi, *args, **kwargs):
        raise NotImplementedError

    def div(self, x, y):
        """The Bregman divergence ``h(x) - h(y) - <grad h(y), x - y>``, summed
        over the batch (bregman.py:24)."""
        d = (self.grad(y) * (x - y)).sum()
        return self.fn(x).sum() - self.fn(y).sum() - (d.real if d.is_complex() else d)

    def MD_step(self, x, grad, *args, gamma: float = 1.0, **kwargs):
        """One mirror-descent step ``grad_conj(grad(x) - gamma grad)``
        (bregman.py:32)."""
        return self.grad_conj(self.grad(x, *args, **kwargs) - gamma * grad)


class BregmanL2(Bregman):
    """``h(x) = 1/2 ||x||^2``: mirror descent is gradient descent (bregman.py:38)."""

    def fn(self, x, *args, **kwargs):
        return 0.5 * (x.reshape(x.shape[0], -1) ** 2).sum(1)

    def grad(self, x, *args, **kwargs):
        return x

    def grad_conj(self, xi, *args, **kwargs):
        return xi


class BurgEntropy(Bregman):
    """``h(x) = -sum log x``, the geometry of the positive orthant
    (bregman.py:51)."""

    def fn(self, x, *args, **kwargs):
        return -torch.log(x.reshape(x.shape[0], -1)).sum(1)

    def grad(self, x, *args, **kwargs):
        return -1.0 / x

    def grad_conj(self, xi, *args, **kwargs):
        return -1.0 / xi


class NegEntropy(Bregman):
    """``h(x) = sum x log x``, the geometry of the simplex (bregman.py:77)."""

    def fn(self, x, *args, **kwargs):
        v = x.reshape(x.shape[0], -1)
        return (v * torch.log(v.clamp_min(1e-30))).sum(1)

    def grad(self, x, *args, **kwargs):
        return torch.log(x.clamp_min(1e-30)) + 1

    def grad_conj(self, xi, *args, **kwargs):
        return torch.exp(xi - 1)


class Bregman_ICNN(Bregman):
    """A learned Bregman potential, an input-convex network (bregman.py:91).
    ``grad_conj`` solves ``grad h(x) = xi`` by ``max_iter`` fixed-point steps
    ``x <- x - lr (grad h(x) - xi)`` from ``xi``.

    :param icnn: the network; :class:`~deepinv_tpu_torch.models.wrappers_models.ICNN`
        on ``device`` (the CUDA device by default) where None.
    """

    def __init__(self, icnn=None, device=None):
        super().__init__()
        if icnn is None:
            from ..models.wrappers_models import ICNN

            icnn = ICNN(device=device)
        self.icnn = icnn

    def fn(self, x, *args, **kwargs):
        return self.icnn.fn(x)

    def grad(self, x, *args, **kwargs):
        return self.icnn.grad(x)

    def grad_conj(self, xi, *args, max_iter: int = 50, lr: float = 0.5, **kwargs):
        x = xi
        for _ in range(max_iter):
            x = x - lr * (self.grad(x) - xi)
        return x
