"""Data-fidelity terms ``f(x) = d(A x, y)`` (port of
deepinv_tpu/optim/data_fidelity.py). The measurement-space distance ``d`` is
written into each subclass as ``d_fn``/``d_grad``; the JAX package's separate
``Distance`` classes (optim/distance.py) wait for their slices."""

from __future__ import annotations

from .potential import Potential

__all__ = ["DataFidelity", "L2"]


class DataFidelity(Potential):
    r"""``f(x) = d(A(x), y)`` with the chain rule through the physics
    (deepinv_tpu/optim/data_fidelity.py:43)."""

    def d_fn(self, u, y):
        raise NotImplementedError

    def d_grad(self, u, y):
        raise NotImplementedError

    def fn(self, x, y, physics, *args, **kwargs):
        return self.d_fn(physics.A(x), y)

    def grad(self, x, y, physics, *args, **kwargs):
        return physics.A_vjp(x, self.d_grad(physics.A(x), y))

    def prox(self, x, y, physics, *args, gamma=1.0, stepsize_inter=1.0,
             max_iter_inter: int = 50, **kwargs):
        """Prox by inner gradient descent (data_fidelity.py:69)."""
        u = x
        for _ in range(max_iter_inter):
            u = u - stepsize_inter * (gamma * self.grad(u, y, physics) + (u - x))
        return u


class L2(DataFidelity):
    r"""``f(x) = 1/(2 sigma^2) ||Ax - y||^2`` (data_fidelity.py:122); its prox
    is ``physics.prox_l2`` at ``gamma / sigma^2`` (:148)."""

    def __init__(self, sigma: float = 1.0):
        super().__init__()
        self.sigma = sigma
        self.norm = 1 / sigma ** 2

    def d_fn(self, u, y):
        return 0.5 * self.norm * (u - y).abs().pow(2).reshape(u.shape[0], -1).sum(1)

    def d_grad(self, u, y):
        return (u - y) * self.norm

    def prox(self, x, y, physics, *args, gamma=1.0, **kwargs):
        return physics.prox_l2(x, y, self.norm * gamma, **kwargs)
