"""Data-fidelity terms ``f(x) = d(A x, y)`` (port of
deepinv_tpu/optim/data_fidelity.py). The measurement-space distance ``d`` is a
:class:`~deepinv_tpu_torch.optim.distance.Distance`; ``d_fn``/``d_grad``/
``d_prox`` route through it. A stacked physics' measurements are a
:class:`~deepinv_tpu_torch.core.TensorList`: the distance sums over its
members (data_fidelity.py:49-61)."""

from __future__ import annotations

import contextlib
import math

import torch

from ..core import TensorList
from ..ops.kernels.tv import fwd_diff_nd, fwd_diff_nd_adjoint
from ..utils.profiling import DATA_FIDELITY
from .distance import (AmplitudeLossDistance, IndicatorL2Distance, L1Distance, L2Distance,
                       LogPoissonLikelihoodDistance, PoissonLikelihoodDistance, ZeroDistance)
from .potential import Potential

__all__ = ["DataFidelity", "StackedPhysicsDataFidelity", "L2", "IndicatorL2",
           "PoissonLikelihood", "L1", "AmplitudeLoss", "LogPoissonLikelihood", "ZeroFidelity",
           "ItohFidelity"]


class DataFidelity(Potential):
    r"""``f(x) = d(A(x), y)`` with the chain rule through the physics
    (deepinv_tpu/optim/data_fidelity.py:43).

    :param d: the distance, :class:`~deepinv_tpu_torch.optim.distance.L2Distance`
        by default (:46).
    """

    span_name = DATA_FIDELITY

    def __init__(self, d=None):
        super().__init__()
        self.d = d if d is not None else L2Distance()

    def d_fn(self, u, y):
        return self.d.fn(u, y)

    def d_grad(self, u, y):
        return self.d.grad(u, y)

    def grad_d(self, u, y, *args, **kwargs):
        """The distance's gradient in its first argument (data_fidelity.py:63)."""
        return self.d.grad(u, y, *args, **kwargs)

    def d_prox(self, u, y, gamma=1.0):
        """``prox_{gamma d(., y)}(u)``, the distance's prox."""
        return self.d.prox(u, y, gamma=gamma)

    _measurement = None  # (y, physics, {name: loop invariant}) inside fixed_measurement

    @contextlib.contextmanager
    def fixed_measurement(self, y, physics):
        """Scope of one reconstruction of ``y`` through ``physics``: inside
        it, :meth:`loop_invariant` computes each named invariant once (``A^T
        y``, MLEM's sensitivity, SIRT's row and column sums). XLA hoists these
        out of the JAX package's ``lax.scan`` (data_fidelity.py:151-160,
        iterators.py:332-365); an eager Python loop would compute them in
        every iteration."""
        self._measurement = (y, physics, {})
        try:
            yield
        finally:
            self._measurement = None

    def loop_invariant(self, name: str, y, physics, compute):
        """``compute()``, made once per :meth:`fixed_measurement` scope of this
        ``y`` and ``physics`` and kept under ``name``; outside such a scope,
        made at every call."""
        m = self._measurement
        if m is None or m[0] is not y or m[1] is not physics:
            return compute()
        if name not in m[2]:
            m[2][name] = compute()
        return m[2][name]

    def adjoint_measurement(self, y, physics):
        """``physics.A_adjoint(y)``, a loop invariant (:meth:`loop_invariant`)."""
        return self.loop_invariant("A^T y", y, physics, lambda: physics.A_adjoint(y))

    def fn(self, x, y, physics, *args, **kwargs):
        Ax = physics.A(x)
        if isinstance(Ax, TensorList):
            return sum(self.d.fn(a, b) for a, b in zip(Ax, y))
        return self.d.fn(Ax, y, *args, **kwargs)

    def grad(self, x, y, physics, *args, **kwargs):
        Ax = physics.A(x)
        if isinstance(Ax, TensorList):
            return physics.A_vjp(x, TensorList([self.d.grad(a, b) for a, b in zip(Ax, y)]))
        return physics.A_vjp(x, self.d.grad(Ax, y, *args, **kwargs))

    def prox(self, x, y, physics, *args, gamma=1.0, stepsize_inter=1.0,
             max_iter_inter: int = 50, **kwargs):
        """Prox by inner gradient descent (data_fidelity.py:69)."""
        u = x
        for _ in range(max_iter_inter):
            u = u - stepsize_inter * (gamma * self.grad(u, y, physics) + (u - x))
        return u

    def prox_d(self, u, y, *args, gamma=1.0, **kwargs):
        """Prox of the measurement-space distance alone (data_fidelity.py:66)."""
        return self.d.prox(u, y, *args, gamma=gamma, **kwargs)

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
        self.d = None
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
        super().__init__(d=L2Distance(sigma=sigma))
        self.sigma = sigma
        self.norm = 1 / sigma ** 2

    def prox(self, x, y, physics, *args, gamma=1.0, **kwargs):
        return physics.prox_l2(x, y, self.norm * gamma, **kwargs)

    def grad(self, x, y, physics, *args, **kwargs):
        """``A^T(Ax - y) / sigma^2``; split into ``A_adjoint_A(x) - A^T y``
        when the physics has a fast normal operator (data_fidelity.py:151-160)."""
        if getattr(physics, "fast_normal", False):
            return (physics.A_adjoint_A(x) - self.adjoint_measurement(y, physics)) * self.norm
        return super().grad(x, y, physics, *args, **kwargs)


class IndicatorL2(DataFidelity):
    r"""The indicator of ``||Ax - y|| <= radius`` (data_fidelity.py:164)."""

    def __init__(self, radius: float = 0.0):
        super().__init__(d=IndicatorL2Distance(radius=radius))
        self.radius = radius

    def prox(self, x, y, physics, *args, radius=None, gamma=None, stepsize=None,
             crit_conv=1e-5, max_iter: int = 100, **kwargs):
        """The projection onto ``{x : ||Ax - y|| <= radius}`` (data_fidelity.py:171):
        the ball projection itself where ``A`` is the identity (``Denoising``),
        else ``max_iter`` steps of the dual forward-backward algorithm, its dual
        update by the Moreau identity ``u <- u_ - step proj(u_ / step)``, at
        step ``1 / ||A||^2`` from 30 power iterations kept out of the graph."""
        from ..physics import Denoising

        radius = self.radius if radius is None else radius
        if isinstance(physics, Denoising):
            return self.d.prox(x, y, radius=radius)
        if stepsize is None:
            with torch.no_grad():
                stepsize = 1.0 / physics.compute_norm(x.detach(), max_iter=30)
        u = physics.A(x)
        for _ in range(max_iter):
            u_ = u + stepsize * physics.A(x - physics.A_adjoint(u))
            u = u_ - stepsize * self.d.prox(u_ / stepsize, y, radius=radius)
        return x - physics.A_adjoint(u)


class PoissonLikelihood(DataFidelity):
    r"""The Poisson negative log-likelihood (data_fidelity.py:204)."""

    def __init__(self, gain: float = 1.0, bkg: float = 0.0, denormalize: bool = True):
        super().__init__(d=PoissonLikelihoodDistance(gain=gain, bkg=bkg,
                                                     denormalize=denormalize))


class L1(DataFidelity):
    r"""``f(x) = ||Ax - y||_1`` (data_fidelity.py:213)."""

    def __init__(self):
        super().__init__(d=L1Distance())

    def prox(self, x, y, physics, *args, gamma=1.0, stepsize=None, max_iter: int = 100,
             **kwargs):
        """The dual forward-backward solver of ``prox`` of ``gamma ||A. - y||_1``
        (data_fidelity.py:219), ``max_iter`` iterations at step ``1 /
        ||A||^2``."""
        if stepsize is None:
            stepsize = 1.0 / physics.compute_norm(x)
        u, t = physics.A(x), x
        for _ in range(max_iter):
            t = x - physics.A_adjoint(u)
            u_ = u + stepsize * physics.A(t)
            u = u_ - stepsize * self.d.prox(u_ / stepsize, y, gamma=gamma / stepsize)
        return t


class AmplitudeLoss(DataFidelity):
    r"""The amplitude loss of phase retrieval (data_fidelity.py:239)."""

    def __init__(self):
        super().__init__(d=AmplitudeLossDistance())


class LogPoissonLikelihood(DataFidelity):
    r"""The log-Poisson negative log-likelihood (data_fidelity.py:246)."""

    def __init__(self, N0: float = 1024.0, mu: float = 1 / 50.0):
        super().__init__(d=LogPoissonLikelihoodDistance(N0=N0, mu=mu))


class ZeroFidelity(DataFidelity):
    r"""Identically zero (data_fidelity.py:253)."""

    def __init__(self):
        super().__init__(d=ZeroDistance())

    def fn(self, x, y, physics, *args, **kwargs):
        return x.new_zeros(x.shape[0])

    def grad(self, x, y, physics, *args, **kwargs):
        return torch.zeros_like(x)

    def prox(self, x, y, physics, *args, gamma=1.0, **kwargs):
        return x


class ItohFidelity(L2):
    r"""Itoh's fidelity of spatial phase unwrapping (data_fidelity.py:269):
    ``1/(2 sigma^2) ||Dx - w_t(Dy)||^2``, ``D`` the forward differences and
    ``w_t`` the wrap to ``[-t/2, t/2]``. For
    :class:`~deepinv_tpu_torch.physics.SpatialUnwrapping`."""

    def __init__(self, sigma: float = 1.0, threshold: float = 1.0):
        super().__init__(sigma=sigma)
        self.threshold = threshold

    def D(self, x):
        """Forward differences over the last two axes, zero at the trailing
        edge, stacked (horizontal, vertical) on a new last axis
        (data_fidelity.py:280)."""
        return fwd_diff_nd(x, x.dim() - 2).flip(-1)

    def D_adjoint(self, v):
        """The adjoint of :meth:`D` (data_fidelity.py:288)."""
        return fwd_diff_nd_adjoint(v.flip(-1), v.dim() - 3)

    def wrap(self, v):
        t = self.threshold
        return v - t * torch.round(v / t)

    def WD(self, y):
        return self.wrap(self.D(y))

    def fn(self, x, y, physics=None, *args, **kwargs):
        return self.d.fn(self.D(x), self.WD(y))

    def grad(self, x, y, physics=None, *args, **kwargs):
        return self.D_adjoint(self.d.grad(self.D(x), self.WD(y)))

    def prox(self, x, y, physics=None, *args, gamma=1.0, **kwargs):
        """The DCT closed form (data_fidelity.py:308): the finite-difference
        normal operator is diagonal in the DCT-II basis, so the prox is a
        forward DCT, a division by the cosine eigenvalues and an inverse DCT;
        ``x=None`` gives the least-squares unwrapping. The eigenvalue at
        ``(0, 0)`` is pinned to 1, as in the JAX package."""
        from ..ops import dct2, idct2

        psi = self.D_adjoint(self.WD(y))
        if x is not None:
            psi = psi + (gamma / 2) * x
        M, N = psi.shape[-2], psi.shape[-1]
        ci = torch.cos(math.pi * torch.arange(M, dtype=psi.dtype, device=psi.device) / M)[:, None]
        cj = torch.cos(math.pi * torch.arange(N, dtype=psi.dtype, device=psi.device) / N)[None, :]
        denom = 2 * (2 - (ci + cj)) if x is None else 2 * ((gamma / 4) + 2 - (ci + cj))
        denom = denom.clone()
        denom[0, 0] = 1.0
        return idct2(dct2(psi) / denom)

    def D_dagger(self, y, **kwargs):
        """The DCT least-squares unwrapping (data_fidelity.py:331)."""
        return self.prox(None, y, physics=None, gamma=None)
