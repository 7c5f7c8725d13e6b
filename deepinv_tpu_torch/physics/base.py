"""Forward-operator classes (port of deepinv_tpu/physics/base.py).

Every physics is an ``nn.Module``: operator parameters (filters, masks) are
buffers, so ``physics.to(device)`` moves them. Parameter changes are
functional, as in the JAX package (core/module.py:104-122):
``physics.update(filter=...)`` returns a new physics and leaves the old one
as it was. A linear physics without a closed form solves its ``prox_l2`` and
``A_dagger`` by the Krylov solvers of :mod:`~deepinv_tpu_torch.optim.linear`
(its ``solver``, ``max_iter`` and ``tol``). Physics compose
(:func:`compose`, ``p1 * p2``) and stack (:func:`stack`, measurements a
:class:`~deepinv_tpu_torch.core.TensorList`).
"""

from __future__ import annotations

import copy
from typing import Callable, Optional, Sequence

import torch
from torch import nn

from ..core import (CHECK_EVERY, TensorList, device_while, linear_transpose, power_method,
                    tree_map, tree_norm, tree_real_vdot, tree_sub)

__all__ = ["Physics", "LinearPhysics", "DecomposablePhysics", "Denoising", "ComposedPhysics",
           "ComposedLinearPhysics", "StackedPhysics", "StackedLinearPhysics", "compose", "stack",
           "replace", "update", "adjoint_function"]


def replace(module: nn.Module, **changes) -> nn.Module:
    """Shallow copy of ``module`` with the given attributes replaced
    (deepinv_tpu/core/module.py:104). Buffers, parameters and submodules are
    copied by reference, so the original keeps its own."""
    new = copy.copy(module)
    new._parameters = dict(module._parameters)
    new._buffers = dict(module._buffers)
    new._modules = dict(module._modules)
    for k, v in changes.items():
        if k in new._buffers:
            old = new._buffers[k]
            if not isinstance(v, torch.Tensor) and old is not None:
                v = torch.as_tensor(v, dtype=old.dtype, device=old.device)
            new._buffers[k] = v
        elif k in new._parameters or k in new._modules or k in new.__dict__:
            setattr(new, k, v)
        else:
            raise AttributeError(f"{type(module).__name__} has no attribute {k!r}")
    return new


def _known(module: nn.Module, k: str) -> bool:
    return (k in module.__dict__ or k in module._buffers
            or k in module._parameters or k in module._modules)


def update(module: nn.Module, **params) -> nn.Module:
    """Functional update (deepinv_tpu/core/module.py:114): replace the
    attributes ``module`` has; unknown keys and ``None`` values are ignored,
    as the JAX package's generators expect."""
    known = {k: v for k, v in params.items() if v is not None and _known(module, k)}
    return replace(module, **known) if known else module


class Physics(nn.Module):
    """Generic forward operator ``y = sensor(noise(A(x)))``
    (deepinv_tpu/physics/base.py:55).

    :param solver: how :meth:`A_dagger` inverts ``A`` (gradient descent
        here; a Krylov solver for :class:`LinearPhysics`).
    :param max_iter: iterations of that solver.
    :param tol: its stopping tolerance.
    """

    def __init__(self, A: Optional[Callable] = None, noise_model: Optional[nn.Module] = None,
                 sensor_model: Optional[Callable] = None, solver: str = "gradient_descent",
                 max_iter: int = 50, tol: float = 1e-4):
        super().__init__()
        self.fwd_fn = A
        self.noise_model = noise_model
        self.sensor_model = sensor_model
        self.solver = solver
        self.max_iter = max_iter
        self.tol = tol

    def A(self, x, **params):
        phys = self.update(**params) if params else self
        return phys.fwd_fn(x) if phys.fwd_fn is not None else x

    def sensor(self, y):
        return self.sensor_model(y) if self.sensor_model is not None else y

    def noise(self, y, generator=None):
        if self.noise_model is None:
            return y
        return self.noise_model(y, generator=generator)

    def forward(self, x, generator=None, **params):
        return self.sensor(self.noise(self.A(x, **params), generator=generator))

    def update(self, **params) -> "Physics":
        """New physics with operator AND noise-model parameters updated
        (base.py:160): keys the noise model knows (``sigma``, ...) go to it."""
        new = update(self, **params)
        nm = new.noise_model
        if nm is not None and hasattr(nm, "update"):
            nm2 = nm.update(**params)
            if nm2 is not nm:
                new = replace(new, noise_model=nm2)
        return new

    def A_dagger(self, y, x_init=None, check_every: int = CHECK_EVERY, **params):
        """Pseudo-inverse of a nonlinear ``A`` by gradient descent on
        ``1/2 ||A(x) - y||^2`` at step 0.1 from ``A_adjoint(y)`` (or ``y``),
        until the gradient's norm falls below ``tol`` or ``max_iter``
        iterations (base.py:110)."""
        phys = self.update(**params) if params else self
        if x_init is None:
            x_init = phys.A_adjoint(y) if hasattr(phys, "A_adjoint") else y

        def grad(x):
            with torch.enable_grad():
                u = tree_map(lambda v: v.detach().requires_grad_(), x)
                r = tree_sub(phys.A(u), y)
                loss = 0.5 * tree_real_vdot(r, r)
                return torch.autograd.grad(loss, u)[0]

        def body(s):
            g = grad(s[0])
            return tree_map(lambda a, b: a - 0.1 * b, s[0], g), tree_norm(g)

        inf = torch.full((), float("inf"), device=x_init.device)
        (x, _), _ = device_while(lambda s: s[1] > self.tol, body, (x_init, inf), self.max_iter,
                                 check_every)
        return x

    def A_vjp(self, x, v):
        """``v^T (dA/dx)`` at ``x`` by autograd (base.py:140)."""
        with torch.enable_grad():
            u = x.detach().requires_grad_()
            return torch.autograd.grad(self.A(u), u, v)[0]

    def A_jvp(self, x, v):
        """``(dA/dx) v`` at ``x`` by forward-mode autodiff (base.py:146)."""
        return torch.func.jvp(lambda u: self.A(u), (x,), (v,))[1]

    def compute_norm(self, x0, max_iter: int = 100, tol: float = 1e-6):
        """Squared spectral norm of the Jacobian at ``x0``: power iteration on
        ``v -> J^T J v`` (base.py:151)."""
        return power_method(lambda v: self.A_vjp(x0, self.A_jvp(x0, v)), x0, max_iter=max_iter,
                            tol=tol)

    def __mul__(self, other: "Physics") -> "Physics":
        """``(p1 * p2).A(x) == p1.A(p2.A(x))`` (base.py:207)."""
        return compose(other, self)

    def stack(self, other: "Physics") -> "StackedPhysics":
        """``stack(self, other)`` (base.py:211)."""
        return stack(self, other)


def adjoint_function(A: Callable, input_shape, dtype=torch.float32) -> Callable:
    """The exact adjoint of a linear callable ``A`` on inputs of
    ``input_shape`` and ``dtype`` (deepinv_tpu/physics/base.py:215): the
    autograd transpose (:func:`~deepinv_tpu_torch.core.linear_transpose`), a
    vector-Jacobian product at a zero primal. For a complex ``A`` autograd
    gives ``A^H y``, the adjoint, where ``jax.linear_transpose`` gives the
    transpose; the two agree on real maps."""
    shape = tuple(int(s) for s in input_shape)

    def A_adj(y):
        return linear_transpose(A, y, shape, dtype=dtype)

    return A_adj


class LinearPhysics(Physics):
    """Linear operator with an adjoint (deepinv_tpu/physics/base.py:243)."""

    def __init__(self, A: Optional[Callable] = None, A_adjoint: Optional[Callable] = None,
                 noise_model=None, sensor_model=None, solver: str = "CG", max_iter: int = 50,
                 tol: float = 1e-4):
        super().__init__(A=A, noise_model=noise_model, sensor_model=sensor_model, solver=solver,
                         max_iter=max_iter, tol=tol)
        self.adj_fn = A_adjoint

    def A_adjoint(self, y, **params):
        phys = self.update(**params) if params else self
        if phys.adj_fn is None:
            raise NotImplementedError(f"{type(self).__name__} defines no A_adjoint")
        return phys.adj_fn(y)

    def A_vjp(self, x, v):
        """``v^T (dA/dx)``: ``A_adjoint(v)`` for linear A (base.py:303)."""
        return self.A_adjoint(v)

    def A_adjoint_A(self, x, **params):
        """``A^T A x`` (base.py:310). A physics with a faster normal operator
        overrides it and sets :attr:`fast_normal`."""
        return self.A_adjoint(self.A(x, **params), **params)

    def A_A_adjoint(self, y, **params):
        """``A A^T y`` (base.py:307)."""
        return self.A(self.A_adjoint(y, **params), **params)

    @property
    def fast_normal(self) -> bool:
        """Whether :meth:`A_adjoint_A` is faster than ``A_adjoint(A(x))``; the
        L2 gradient then splits into ``A_adjoint_A(x) - A_adjoint(y)``
        (deepinv_tpu/optim/data_fidelity.py:151-160)."""
        return False

    def adjointness_test(self, u, generator=None):
        """``<A u, v> - <u, A^T v>`` for a random v (base.py:321)."""
        if generator is None:
            generator = torch.Generator(device=u.device).manual_seed(17)
        Au = self.A(u)
        v = torch.randn(Au.shape, generator=generator, device=Au.device, dtype=Au.dtype)
        return torch.vdot(Au.flatten(), v.flatten()) - torch.vdot(
            u.flatten(), self.A_adjoint(v).flatten())

    def compute_norm(self, x0, max_iter: int = 100, tol: float = 1e-6):
        """Squared operator norm ``||A||_2^2`` by power iteration on ``A^T A``
        (base.py:314)."""
        return power_method(self.A_adjoint_A, x0, max_iter=max_iter, tol=tol)

    def condition_number(self, x0, max_iter: int = 500, tol: float = 1e-8):
        """``sqrt(lambda_max / lambda_min)`` of ``A^T A``, the smallest
        eigenvalue by the power method on ``lambda_max I - A^T A``
        (base.py:332)."""
        lmax = power_method(self.A_adjoint_A, x0, max_iter, tol)
        lshift = power_method(lambda v: tree_map(lambda a, b: lmax * a - b, v,
                                                 self.A_adjoint_A(v)), x0, max_iter, tol)
        return torch.sqrt(lmax / (lmax - lshift).clamp_min(1e-30))

    def prox_l2(self, z, y, gamma, solver=None, max_iter=None, tol=None, **kwargs):
        """``argmin_x gamma/2 ||Ax - y||^2 + 1/2 ||x - z||^2`` by the Krylov
        solver ``solver`` from ``z``, with the implicit backward (base.py:345).
        ``z`` None or a number fills ``A^T y``'s shape; ``gamma`` a number or a
        per-sample tensor (B,)."""
        from ..optim.linear import least_squares

        if z is None or isinstance(z, (int, float)):
            fill = 0.0 if z is None else float(z)
            z = tree_map(lambda a: torch.full_like(a, fill), self.A_adjoint(y))
        return least_squares(self.A, self.A_adjoint, y, solver=solver or self.solver,
                             gamma=gamma, z=z, init=z, physics=self,
                             max_iter=max_iter or self.max_iter, tol=tol or self.tol, **kwargs)

    def A_dagger(self, y, solver=None, max_iter=None, tol=None, **kwargs):
        """Least-squares pseudo-inverse by the Krylov solver ``solver``
        (base.py:367)."""
        from ..optim.linear import least_squares

        return least_squares(self.A, self.A_adjoint, y, solver=solver or self.solver,
                             gamma=kwargs.pop("gamma", None), max_iter=max_iter or self.max_iter,
                             tol=tol or self.tol, **kwargs)


def _inv_gamma_mul(gamma, x):
    """``x / gamma`` with a scalar or per-sample gamma (base.py:486)."""
    g = torch.as_tensor(gamma, device=x.device)
    if 0 < g.dim() < x.dim():
        g = g.reshape(g.shape + (1,) * (x.dim() - g.dim()))
    return x / g


def _add_inv_gamma(m2, gamma):
    """``m2 + 1/gamma`` with gamma broadcast over ``m2`` (base.py:493), on
    ``m2``'s device, or on gamma's where ``m2`` is a number."""
    if isinstance(m2, torch.Tensor):
        g = torch.as_tensor(gamma, device=m2.device)
    else:
        g = torch.as_tensor(gamma)
        m2 = torch.as_tensor(m2, device=g.device)
    if g.dim() > 0 and m2.dim() > g.dim():
        g = g.reshape(g.shape + (1,) * (m2.dim() - g.dim()))
    return m2 + 1.0 / g


class DecomposablePhysics(LinearPhysics):
    """SVD-form operator ``A = U diag(mask) V^*`` with closed-form prox
    (deepinv_tpu/physics/base.py:395). Subclasses override ``U``,
    ``U_adjoint``, ``V``, ``V_adjoint`` (identity by default); ``mask`` is a
    float or a tensor (kept as a buffer)."""

    def __init__(self, mask=1.0, **kwargs):
        super().__init__(**kwargs)
        if isinstance(mask, torch.Tensor):
            self.register_buffer("mask", mask)
        else:
            self.mask = mask

    def U(self, x):
        return x

    def U_adjoint(self, y):
        return y

    def V(self, x):
        return x

    def V_adjoint(self, x):
        return x

    def A(self, x, **params):
        phys = self.update(**params) if params else self
        return phys.U(phys._mask_mul(phys.V_adjoint(x)))

    def A_adjoint(self, y, **params):
        phys = self.update(**params) if params else self
        return phys.V(phys._mask_mul(phys.U_adjoint(y), conj=True))

    def _mask_mul(self, x, conj: bool = False):
        m = self.mask
        if conj and isinstance(m, torch.Tensor) and m.is_complex():
            m = m.conj()
        return x * m

    def prox_l2(self, z, y, gamma, **kwargs):
        """Closed-form ``argmin_x gamma/2 ||Ax-y||^2 + 1/2 ||x-z||^2`` by the
        SVD (base.py:453)."""
        if z is None or isinstance(z, (int, float)):
            z = torch.full_like(self.A_adjoint(y), 0.0 if z is None else float(z))
        b = self.A_adjoint(y) + _inv_gamma_mul(gamma, z)
        m = self.mask
        m2 = m ** 2 if isinstance(m, (int, float)) else (m.conj() * m).real
        vb = self.V_adjoint(b)
        return self.V(vb / _add_inv_gamma(m2, gamma))

    def A_dagger(self, y, **kwargs):
        """Closed-form pseudo-inverse (base.py:471)."""
        m = self.mask
        if isinstance(m, (int, float)):
            return self.V(self.U_adjoint(y) * (0.0 if abs(m) <= 1e-5 else 1.0 / m))
        big = m.abs() > 1e-5
        minv = torch.where(big, 1.0 / torch.where(big, m, torch.ones_like(m)),
                           torch.zeros_like(m))
        return self.V(self.U_adjoint(y) * minv)


class Denoising(DecomposablePhysics):
    """Identity forward operator with a noise model (base.py:501)."""

    def __init__(self, noise_model=None, **kwargs):
        super().__init__(mask=1.0, noise_model=noise_model, **kwargs)


# -- composition and stacking (base.py:513-640) ---------------------------------


class ComposedPhysics(Physics):
    """``A = A_k o ... o A_1``, ``physics_list[0]`` applied first; the noise
    and sensor of the last one (base.py:513)."""

    def __init__(self, physics_list: Sequence[Physics], **kwargs):
        super().__init__(**kwargs)
        self.physics_list = nn.ModuleList(physics_list)
        self.noise_model = physics_list[-1].noise_model
        self.sensor_model = physics_list[-1].sensor_model

    def A(self, x, **params):
        for p in self.physics_list:
            x = p.A(x, **params)
        return x

    def A_dagger(self, y, **params):
        for p in reversed(self.physics_list):
            y = p.A_dagger(y, **params)
        return y


class ComposedLinearPhysics(ComposedPhysics, LinearPhysics):
    """Composition of linear physics (base.py:537): the adjoint runs the
    adjoints backwards; ``A_dagger`` and ``prox_l2`` solve the composed
    least-squares problem by the Krylov solver (a product's pseudo-inverse is
    not the product of the pseudo-inverses)."""

    def A_adjoint(self, y, **params):
        for p in reversed(self.physics_list):
            y = p.A_adjoint(y, **params)
        return y

    def A_dagger(self, y, **params):
        return LinearPhysics.A_dagger(self, y, **params)

    def prox_l2(self, z, y, gamma, **kwargs):
        return LinearPhysics.prox_l2(self, z, y, gamma, **kwargs)


def _flatten(physics, cls) -> list:
    flat = []
    for p in physics:
        flat.extend(p.physics_list if isinstance(p, cls) else [p])
    return flat


def compose(*physics: Physics, **kwargs) -> Physics:
    """``compose(p1, p2).A(x) == p2.A(p1.A(x))`` (base.py:557); linear when
    every member is."""
    flat = _flatten(physics, ComposedPhysics)
    if all(isinstance(p, LinearPhysics) for p in flat):
        return ComposedLinearPhysics(flat, **kwargs)
    return ComposedPhysics(flat, **kwargs)


class StackedPhysics(Physics):
    """``A(x) = [A_1(x), ..., A_k(x)]``, a TensorList, each member with its
    own noise and sensor (base.py:571)."""

    def __init__(self, physics_list: Sequence[Physics], **kwargs):
        super().__init__(**kwargs)
        self.physics_list = nn.ModuleList(physics_list)

    def A(self, x, **params):
        return TensorList([p.A(x, **params) for p in self.physics_list])

    def noise(self, y, generator=None):
        return TensorList([p.noise(yi, generator=generator)
                           for p, yi in zip(self.physics_list, y)])

    def sensor(self, y):
        return TensorList([p.sensor(yi) for p, yi in zip(self.physics_list, y)])

    def __getitem__(self, i):
        return self.physics_list[i]

    def __len__(self):
        return len(self.physics_list)


class StackedLinearPhysics(StackedPhysics, LinearPhysics):
    """Stacked linear physics: the adjoint sums the members' adjoints
    (base.py:599)."""

    def A_adjoint(self, y, **params):
        outs = [p.A_adjoint(yi, **params) for p, yi in zip(self.physics_list, y)]
        tot = outs[0]
        for o in outs[1:]:
            tot = tree_map(torch.add, tot, o)
        return tot


def stack(*physics: Physics, **kwargs) -> StackedPhysics:
    """Stack physics into one operator whose measurements are a TensorList
    (base.py:616); linear when every member is."""
    flat = _flatten(physics, StackedPhysics)
    if all(isinstance(p, LinearPhysics) for p in flat):
        return StackedLinearPhysics(flat, **kwargs)
    return StackedPhysics(flat, **kwargs)
