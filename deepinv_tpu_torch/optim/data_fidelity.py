"""Data-fidelity terms ``f(x) = d(A x, y)`` (port of
deepinv_tpu/optim/data_fidelity.py). The measurement-space distance ``d`` is
written into each subclass as ``d_fn``/``d_grad``; the JAX package's separate
``Distance`` classes (optim/distance.py) wait for their slices. A stacked
physics' measurements are a :class:`~deepinv_tpu_torch.core.TensorList`: the
distance sums over its members (data_fidelity.py:49-61)."""

from __future__ import annotations

import contextlib

from ..core import TensorList
from .potential import Potential

__all__ = ["DataFidelity", "StackedPhysicsDataFidelity", "L2"]


class DataFidelity(Potential):
    r"""``f(x) = d(A(x), y)`` with the chain rule through the physics
    (deepinv_tpu/optim/data_fidelity.py:43)."""

    def d_fn(self, u, y):
        raise NotImplementedError

    def d_grad(self, u, y):
        raise NotImplementedError

    def d_prox(self, u, y, gamma=1.0):
        """``prox_{gamma d(., y)}(u)``, the distance's prox (the JAX package's
        ``Distance.prox``, optim/distance.py)."""
        raise NotImplementedError

    _measurement = None  # (y, physics, A^T y or None) inside fixed_measurement

    @contextlib.contextmanager
    def fixed_measurement(self, y, physics):
        """Scope of one reconstruction of ``y`` through ``physics``: inside
        it, :meth:`adjoint_measurement` computes ``A^T y`` once. XLA hoists
        this loop invariant out of the JAX package's ``lax.scan``
        (data_fidelity.py:153-160); an eager Python loop would compute it in
        every iteration."""
        self._measurement = (y, physics, None)
        try:
            yield
        finally:
            self._measurement = None

    def adjoint_measurement(self, y, physics):
        """``physics.A_adjoint(y)``, computed once per :meth:`fixed_measurement`
        scope of this ``y`` and ``physics``."""
        m = self._measurement
        if m is None or m[0] is not y or m[1] is not physics:
            return physics.A_adjoint(y)
        if m[2] is None:
            self._measurement = m = (y, physics, physics.A_adjoint(y))
        return m[2]

    def fn(self, x, y, physics, *args, **kwargs):
        Ax = physics.A(x)
        if isinstance(Ax, TensorList):
            return sum(self.d_fn(a, b) for a, b in zip(Ax, y))
        return self.d_fn(Ax, y)

    def grad(self, x, y, physics, *args, **kwargs):
        Ax = physics.A(x)
        if isinstance(Ax, TensorList):
            return physics.A_vjp(x, TensorList([self.d_grad(a, b) for a, b in zip(Ax, y)]))
        return physics.A_vjp(x, self.d_grad(Ax, y))

    def prox(self, x, y, physics, *args, gamma=1.0, stepsize_inter=1.0,
             max_iter_inter: int = 50, **kwargs):
        """Prox by inner gradient descent (data_fidelity.py:69)."""
        u = x
        for _ in range(max_iter_inter):
            u = u - stepsize_inter * (gamma * self.grad(u, y, physics) + (u - x))
        return u

    def prox_d(self, u, y, *args, gamma=1.0, **kwargs):
        """Prox of the measurement-space distance alone (data_fidelity.py:66)."""
        return self.d_prox(u, y, gamma=gamma)

    def prox_conjugate(self, x, y, physics, *args, gamma=1.0, lamb=1.0, **kwargs):
        """Prox of the conjugate of the whole fidelity ``f = d(A., y)`` by the
        Moreau identity on :meth:`prox` (data_fidelity.py:83); the
        Chambolle-Pock iterator's dual step."""
        return x - gamma * self.prox(x / gamma, y, physics, *args, gamma=lamb / gamma, **kwargs)

    def prox_d_conjugate(self, x, y, *args, gamma=1.0, lamb=1.0, **kwargs):
        """The Moreau identity on the distance ``d`` alone (data_fidelity.py:92)."""
        return x - gamma * self.prox_d(x / gamma, y, *args, gamma=lamb / gamma, **kwargs)


class StackedPhysicsDataFidelity(DataFidelity):
    r"""``f(x) = sum_i f_i(A_i x, y_i)`` over the members of a stacked physics,
    each with its own fidelity (data_fidelity.py:97). Its prox is the base
    class's inner gradient descent."""

    def __init__(self, data_fidelity_list):
        super().__init__()
        self.data_fidelity_list = list(data_fidelity_list)

    def fn(self, x, y, physics, *args, **kwargs):
        return sum(f.fn(x, yi, p)
                   for f, yi, p in zip(self.data_fidelity_list, y, physics.physics_list))

    def grad(self, x, y, physics, *args, **kwargs):
        return sum(f.grad(x, yi, p)
                   for f, yi, p in zip(self.data_fidelity_list, y, physics.physics_list))


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

    def d_prox(self, u, y, gamma=1.0):
        """``(u + norm gamma y) / (1 + gamma norm)`` (optim/distance.py:60)."""
        return (u + self.norm * gamma * y) / (1 + gamma * self.norm)

    def prox(self, x, y, physics, *args, gamma=1.0, **kwargs):
        return physics.prox_l2(x, y, self.norm * gamma, **kwargs)

    def grad(self, x, y, physics, *args, **kwargs):
        """``A^T(Ax - y) / sigma^2``; split into ``A_adjoint_A(x) - A^T y``
        when the physics has a fast normal operator (data_fidelity.py:151-160)."""
        if getattr(physics, "fast_normal", False):
            return (physics.A_adjoint_A(x) - self.adjoint_measurement(y, physics)) * self.norm
        return super().grad(x, y, physics, *args, **kwargs)
