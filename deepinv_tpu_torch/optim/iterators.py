"""Optimization iterators (port of deepinv_tpu/optim/iterators.py).

An iterator maps the state ``X = {"est": (x, z), "it": k}`` to the next one,
given the data fidelity, the prior, this iteration's parameters
(``stepsize``, ``g_param``, ``lambda``, ``beta``), ``y`` and the physics:
GD, PGD, FISTA, HQS, ADMM, DRS, Chambolle-Pock, mirror descent (MD), proximal
mirror descent (PMD), the spectral method (SM), SIRT and MLEM.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.linalg import tree_map

__all__ = ["OptimIterator", "GDIteration", "HQSIteration", "PGDIteration", "FISTAIteration",
           "ADMMIteration", "DRSIteration", "CPIteration", "MDIteration", "PMDIteration",
           "SMIteration", "SIRTIteration", "MLEMIteration", "objective_function"]


def objective_function(x, data_fidelity, prior, params, y, physics):
    """``F(x) = f(x) + lambda g(x)`` per sample, ``g`` counted only for a prior
    with a cost (``explicit_prior``; iterators.py:41)."""
    F = data_fidelity.fn(x, y, physics)
    if prior is not None and getattr(prior, "explicit_prior", False):
        F = F + params["lambda"] * prior.fn(x, params.get("g_param"))
    return F


class OptimIterator(nn.Module):
    """One step of a splitting algorithm (deepinv_tpu/optim/iterators.py:49)."""

    def __init__(self, g_first: bool = False):
        super().__init__()
        self.g_first = g_first

    def init_state(self, x_init, y, physics):
        return {"est": (x_init, x_init), "it": 0}

    def get_output(self, X):
        return X["est"][0]

    def relaxation(self, u, v, beta):
        return beta * u + (1 - beta) * v

    relaxation_step = relaxation

    def forward(self, X, data_fidelity, prior, params, y, physics):
        raise NotImplementedError


class GDIteration(OptimIterator):
    r"""Gradient descent (iterators.py:82):
    ``x = x - stepsize (grad f(x) + lambda grad g(x))``."""

    def forward(self, X, data_fidelity, prior, params, y, physics):
        x = X["est"][0]
        grad = data_fidelity.grad(x, y, physics) + params["lambda"] * prior.grad(
            x, params.get("g_param"))
        x_new = x - params["stepsize"] * grad
        return {"est": (x_new, x_new), "it": X["it"] + 1}


class HQSIteration(OptimIterator):
    r"""Half-quadratic splitting (iterators.py:147):
    ``z = prox_{stepsize f}(x)``, ``x = prox_g(z)`` at denoiser level
    ``g_param`` (the order swaps with ``g_first``), then relaxation by ``beta``."""

    def forward(self, X, data_fidelity, prior, params, y, physics):
        x = X["est"][0]
        gamma = params["lambda"] * params["stepsize"]
        if not self.g_first:
            z = data_fidelity.prox(x, y, physics, gamma=params["stepsize"])
            x_new = prior.prox(z, params.get("g_param"), gamma=gamma)
        else:
            z = prior.prox(x, params.get("g_param"), gamma=gamma)
            x_new = data_fidelity.prox(z, y, physics, gamma=params["stepsize"])
        x_new = self.relaxation(x_new, x, params.get("beta", 1.0))
        return {"est": (x_new, z), "it": X["it"] + 1}


class PGDIteration(OptimIterator):
    r"""Proximal gradient (iterators.py:97): a gradient step on f at
    ``stepsize``, then the prox of g at denoiser level ``g_param``. With
    ``g_first``, a gradient step on g and then the prox of f. Then
    relaxation by ``beta``."""

    def forward(self, X, data_fidelity, prior, params, y, physics):
        x = X["est"][0]
        if not self.g_first:
            z = x - params["stepsize"] * data_fidelity.grad(x, y, physics)
            x_new = prior.prox(z, params.get("g_param"),
                               gamma=params["lambda"] * params["stepsize"])
        else:
            z = x - params["lambda"] * params["stepsize"] * prior.grad(x, params.get("g_param"))
            x_new = data_fidelity.prox(z, y, physics, gamma=params["stepsize"])
        x_new = self.relaxation(x_new, x, params.get("beta", 1.0))
        return {"est": (x_new, z), "it": X["it"] + 1}


class FISTAIteration(OptimIterator):
    r"""FISTA with the Chambolle-Dossal momentum ``(k + a - 1) / (k + a)``
    (iterators.py:121): a PGD step from the extrapolated point ``z``
    (with ``g_first``, a gradient step on g and then the prox of f), then
    ``z = x + alpha (x - x_prev)``."""

    def forward(self, X, data_fidelity, prior, params, y, physics):
        x_prev, z_prev = X["est"]
        k = X["it"]
        a = params.get("a", 3.0)
        alpha = (k + a - 1) / (k + a)
        if not self.g_first:
            u = z_prev - params["stepsize"] * data_fidelity.grad(z_prev, y, physics)
            x = prior.prox(u, params.get("g_param"), gamma=params["lambda"] * params["stepsize"])
        else:
            u = z_prev - params["lambda"] * params["stepsize"] * prior.grad(
                z_prev, params.get("g_param"))
            x = data_fidelity.prox(u, y, physics, gamma=params["stepsize"])
        z = x + alpha * (x - x_prev)
        return {"est": (x, z), "it": k + 1}


class ADMMIteration(OptimIterator):
    r"""ADMM (iterators.py:169): ``u = prox_f(x - z)``, ``x = prox_g(u + z)``,
    ``z = z + beta (u - x)``. The state starts at ``(x0, x0)``, as the JAX
    package seeds it (:175-182). With ``g_first`` both steps flip the dual's
    sign, ``u = prox_g(x - z)``, ``x = prox_f(u + z)`` (:186-190)."""

    def forward(self, X, data_fidelity, prior, params, y, physics):
        x, z = X["est"]
        gamma_g = params["lambda"] * params["stepsize"]
        if self.g_first:
            u = prior.prox(x - z, params.get("g_param"), gamma=gamma_g)
            x_new = data_fidelity.prox(u + z, y, physics, gamma=params["stepsize"])
        else:
            u = data_fidelity.prox(x - z, y, physics, gamma=params["stepsize"])
            x_new = prior.prox(u + z, params.get("g_param"), gamma=gamma_g)
        z = z + params.get("beta", 1.0) * (u - x_new)
        return {"est": (x_new, z), "it": X["it"] + 1}


class DRSIteration(OptimIterator):
    r"""Douglas-Rachford splitting (iterators.py:204): ``u = prox_f(z)``,
    ``x = prox_g(2u - z)``, ``z = z + beta (x - u)`` (f and g swap with
    ``g_first``)."""

    def forward(self, X, data_fidelity, prior, params, y, physics):
        x, z = X["est"]
        gamma_g = params["lambda"] * params["stepsize"]
        if self.g_first:
            u = prior.prox(z, params.get("g_param"), gamma=gamma_g)
            x_new = data_fidelity.prox(2 * u - z, y, physics, gamma=params["stepsize"])
        else:
            u = data_fidelity.prox(z, y, physics, gamma=params["stepsize"])
            x_new = prior.prox(2 * u - z, params.get("g_param"), gamma=gamma_g)
        z = z + params.get("beta", 1.0) * (x_new - u)
        return {"est": (x_new, z), "it": X["it"] + 1}


class CPIteration(OptimIterator):
    r"""Chambolle-Pock primal-dual (iterators.py:229). The state is
    ``(x, xbar, u)``: primal, extrapolated primal, dual.

    ``K``/``K_adjoint`` are an explicit splitting operator (identity by
    default, as in the JAX package: the physics then enters through the whole
    fidelity's :meth:`~deepinv_tpu_torch.optim.DataFidelity.prox_conjugate`).
    Without ``g_first``: dual ascent ``u = prox_{sigma f^*}(u + sigma K xbar)``,
    then ``x = prox_{tau lambda g}(x - tau K^T u)``. With ``g_first`` the roles
    swap, with the JAX package's documented deviation from upstream
    (:269-280): the dual prox of ``(lambda g)^*`` at ``gamma = sigma``, so both
    orders solve the same objective.
    """

    def __init__(self, g_first: bool = False, K=None, K_adjoint=None):
        super().__init__(g_first=g_first)
        self.K = K
        self.K_adjoint = K_adjoint

    def _ops(self):
        if self.K is not None:
            return self.K, self.K_adjoint
        return (lambda v: v), (lambda v: v)

    def init_state(self, x_init, y, physics):
        """The dual starts at the measurement when ``K x`` has its shape, as
        the JAX package seeds it (:250-261); at zeros otherwise."""
        Kx = self._ops()[0](x_init)
        u0 = y if tuple(Kx.shape) == tuple(y.shape) else Kx.new_zeros(Kx.shape)
        return {"est": (x_init, x_init, u0), "it": 0}

    def forward(self, X, data_fidelity, prior, params, y, physics):
        x, xbar, u = X["est"]
        Kf, Kt = self._ops()
        sigma = params.get("stepsize_dual", 1.0)
        tau = params["stepsize"]
        lam = params.get("lambda", 1.0)
        if self.g_first:
            u = prior.prox_conjugate(u + sigma * Kf(xbar), params.get("g_param"), gamma=sigma,
                                     lamb=lam)
            x_new = data_fidelity.prox(x - tau * Kt(u), y, physics, gamma=tau)
        else:
            u = data_fidelity.prox_conjugate(u + sigma * Kf(xbar), y, physics, gamma=sigma)
            x_new = prior.prox(x - tau * Kt(u), params.get("g_param"), gamma=tau * lam)
        xbar = x_new + params.get("beta", 1.0) * (x_new - x)
        return {"est": (x_new, xbar, u), "it": X["it"] + 1}


class MDIteration(OptimIterator):
    r"""Mirror descent in the geometry of a Bregman potential ``h``
    (iterators.py:305): ``x = grad h^*(grad h(x) - stepsize (grad f(x) +
    lambda grad g(x)))``.

    :param bregman_potential: ``h``; :class:`~deepinv_tpu_torch.optim.BregmanL2`
        (gradient descent) by default.
    """

    def __init__(self, bregman_potential=None, g_first: bool = False):
        super().__init__(g_first=g_first)
        if bregman_potential is None:
            from .bregman import BregmanL2

            bregman_potential = BregmanL2()
        self.bregman_potential = bregman_potential

    def forward(self, X, data_fidelity, prior, params, y, physics):
        x = X["est"][0]
        v = data_fidelity.grad(x, y, physics) + params["lambda"] * prior.grad(
            x, params.get("g_param"))
        xi = self.bregman_potential.grad(x) - params["stepsize"] * v
        x_new = self.bregman_potential.grad_conj(xi)
        return {"est": (x_new, x_new), "it": X["it"] + 1}


class PMDIteration(MDIteration):
    r"""Proximal mirror descent (iterators.py:371): ``u = grad h^*(grad h(x) -
    stepsize grad f(x))``, then ``x`` the Bregman prox of ``stepsize lambda g``
    at ``u``. With the default ``BregmanL2`` it is PGD."""

    def forward(self, X, data_fidelity, prior, params, y, physics):
        x = X["est"][0]
        grad = params["stepsize"] * data_fidelity.grad(x, y, physics)
        u = self.bregman_potential.grad_conj(self.bregman_potential.grad(x) - grad)
        x_new = prior.bregman_prox(u, self.bregman_potential, params.get("g_param"),
                                   gamma=params["stepsize"] * params.get("lambda", 1.0))
        return {"est": (x_new, x_new), "it": X["it"] + 1}


class SMIteration(OptimIterator):
    r"""One step of the spectral method of phase retrieval (iterators.py:392):
    a power-iteration step on ``B^H diag(T(y / mean y)) B + lamb I``, the
    prior's prox, and a normalization per sample. ``physics`` is a phase
    retrieval operator (its ``B``).

    :param lamb: the shift ``lamb I``.
    :param preprocessing: ``T``; ``max(1 - 1 / max(u, 1e-6), -5)`` by default.
    """

    def __init__(self, lamb: float = 10.0, preprocessing=None, g_first: bool = False):
        super().__init__(g_first=g_first)
        self.lamb = lamb
        self.preprocessing = preprocessing if preprocessing is not None else (
            lambda u: torch.clamp(1 - 1 / u.clamp_min(1e-6), min=-5.0))

    def forward(self, X, data_fidelity, prior, params, y, physics):
        x = X["est"][0]
        dims = tuple(range(1, y.dim()))
        diag = self.preprocessing(y / y.mean(dim=dims, keepdim=True))
        v = physics.B.A_adjoint(diag * physics.B.A(x)) + self.lamb * x
        v = prior.prox(v, params.get("g_param"), gamma=params.get("stepsize", 1.0))
        norm = torch.sqrt((v.abs() ** 2).sum(dim=tuple(range(1, v.dim())), keepdim=True))
        x_new = v / norm.clamp_min(1e-12)
        return {"est": (x_new, x_new), "it": X["it"] + 1}


class SIRTIteration(OptimIterator):
    r"""The Simultaneous Iterative Reconstruction Technique (iterators.py:328):
    ``x = x + stepsize V A^T W (y - A x)``, ``W`` and ``V`` the inverse row
    and column sums of ``A`` (``A 1`` and ``A^T 1``, clamped at ``eps``). The
    sums are loop invariants, made once a reconstruction
    (:meth:`~deepinv_tpu_torch.optim.DataFidelity.loop_invariant`)."""

    def forward(self, X, data_fidelity, prior, params, y, physics, eps: float = 1e-10):
        x = X["est"][0]
        W = data_fidelity.loop_invariant(
            "SIRT row sums", y, physics,
            lambda: tree_map(lambda r: 1.0 / r.clamp_min(eps),
                             physics.A(tree_map(torch.ones_like, x))))
        col_sum = data_fidelity.loop_invariant(
            "SIRT column sums", y, physics,
            lambda: physics.A_adjoint(tree_map(torch.ones_like, y)).clamp_min(eps))
        resid = tree_map(torch.sub, y, physics.A(x))
        upd = physics.A_adjoint(tree_map(torch.mul, W, resid))
        x_new = x + params["stepsize"] * upd / col_sum
        return {"est": (x_new, x_new), "it": X["it"] + 1}


class MLEMIteration(OptimIterator):
    r"""Maximum-likelihood expectation maximization for Poisson data
    (iterators.py:345): ``x = x A^T(y / A x) / (A^T 1 + lambda grad g(x'))``,
    ``x'`` the numerator, ``g`` left out for the ``Zero`` prior. The
    sensitivity ``A^T 1`` is a loop invariant, made once a reconstruction
    (:meth:`~deepinv_tpu_torch.optim.DataFidelity.loop_invariant`)."""

    def forward(self, X, data_fidelity, prior, params, y, physics, eps: float = 1e-15):
        from .prior import Zero

        x = X["est"][0]
        sensitivity = data_fidelity.loop_invariant(
            "MLEM sensitivity", y, physics,
            lambda: physics.A_adjoint(tree_map(torch.ones_like, y)))
        ratio = tree_map(lambda yi, ai: yi / ai.clamp_min(eps), y, physics.A(x))
        x_new = x * physics.A_adjoint(ratio)
        denom = sensitivity
        if prior is not None and not isinstance(prior, Zero):
            denom = sensitivity + params["lambda"] * prior.grad(x_new, params.get("g_param"))
        x_new = x_new / denom.clamp_min(eps)
        return {"est": (x_new, x_new), "it": X["it"] + 1}
