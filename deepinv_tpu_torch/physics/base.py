"""Forward-operator classes (port of deepinv_tpu/physics/base.py).

Every physics is an ``nn.Module``: operator parameters (filters, masks) are
buffers, so ``physics.to(device)`` moves them. Parameter changes are
functional, as in the JAX package (core/module.py:104-122):
``physics.update(filter=...)`` returns a new physics and leaves the old one
as it was.
"""

from __future__ import annotations

import copy
from typing import Callable, Optional

import torch
from torch import nn

__all__ = ["Physics", "LinearPhysics", "DecomposablePhysics", "Denoising", "replace", "update"]


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
    (deepinv_tpu/physics/base.py:55)."""

    def __init__(self, A: Optional[Callable] = None, noise_model: Optional[nn.Module] = None,
                 sensor_model: Optional[Callable] = None):
        super().__init__()
        self.fwd_fn = A
        self.noise_model = noise_model
        self.sensor_model = sensor_model

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


class LinearPhysics(Physics):
    """Linear operator with an adjoint (deepinv_tpu/physics/base.py:243)."""

    def __init__(self, A: Optional[Callable] = None, A_adjoint: Optional[Callable] = None,
                 noise_model=None, sensor_model=None):
        super().__init__(A=A, noise_model=noise_model, sensor_model=sensor_model)
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

    def prox_l2(self, z, y, gamma, **kwargs):
        raise NotImplementedError(
            "the Krylov prox_l2 of a general LinearPhysics (optim/linear.py) waits "
            "for ROADMAP queue 1 item 8")


def _inv_gamma_mul(gamma, x):
    """``x / gamma`` with a scalar or per-sample gamma (base.py:486)."""
    g = torch.as_tensor(gamma, device=x.device)
    if 0 < g.dim() < x.dim():
        g = g.reshape(g.shape + (1,) * (x.dim() - g.dim()))
    return x / g


def _add_inv_gamma(m2, gamma):
    """``m2 + 1/gamma`` with gamma broadcast over ``m2`` (base.py:493)."""
    m2 = torch.as_tensor(m2)
    g = torch.as_tensor(gamma, device=m2.device)
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
