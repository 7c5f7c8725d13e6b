"""Operator-parallel physics (port of deepinv_tpu/parallel/physics.py).

A stack of structurally identical operators (same classes, same tensor names,
shapes and dtypes: k blurs with different PSFs, k MRI masks) is placed in
contiguous blocks over the mesh's ``op`` axis, as ``shard_map(P("op"))``
places the JAX package's batched operator (physics.py:56-172): with ``n``
operators on ``k`` devices, device ``j`` holds operators ``j*b`` to
``(j+1)*b - 1``, ``b = ceil(n / k)``.

- ``A``: ``x`` goes to each device, each applies its operators, and the
  measurements come back to the axis' first device stacked on a leading
  operator axis, ``(n, B, C, ...)``;
- ``A_adjoint``: each device sums its operators' adjoints in order, and the
  partial sums are moved to the first device and added in device order: the
  JAX package's ``psum`` (physics.py:249-274);
- the norm, the pseudo-inverse and the prox run the port's power method and
  conjugate gradient (:mod:`~deepinv_tpu_torch.core.linalg`,
  :mod:`~deepinv_tpu_torch.optim.linear`) on those two.

The JAX package pads an operator count that does not divide the axis by
repeating the last operator and feeds the pads zero measurements (:136-147,
:256-260): their adjoints add exactly zero, so the port runs no pad. Stacks of
differing operators are evaluated one operator after another where each
lives and give a :class:`~deepinv_tpu_torch.core.TensorList`. Operators may
come from a factory ``f(index, device, factory_kwargs)``, called once an index
with the mesh device of its block.
"""

from __future__ import annotations

import copy
import itertools
import math
from typing import Optional, Sequence

import torch

from ..core import TensorList, power_method
from ..physics.base import LinearPhysics, Physics
from .context import DistributedContext, replica

__all__ = ["DistributedStackedPhysics", "DistributedStackedLinearPhysics", "stack_homogeneous"]

_STATIC = (str, bool, type(None))


def _tensors(module) -> dict:
    return dict(itertools.chain(module.named_parameters(), module.named_buffers()))


def _signature(module) -> tuple:
    """What makes two operators stack: every submodule's class and its string
    and flag attributes (the JAX package's static fields), every parameter's
    and buffer's name, shape and dtype (its leaves)."""
    mods = tuple((name, type(m), tuple(sorted((k, v) for k, v in vars(m).items()
                                              if not k.startswith("_") and isinstance(v, _STATIC))))
                 for name, m in module.named_modules())
    return mods + tuple((k, tuple(t.shape), t.dtype) for k, t in _tensors(module).items())


def _homogeneous(physics_list) -> bool:
    sigs = [_signature(p) for p in physics_list]
    return all(s == sigs[0] for s in sigs[1:])


def stack_homogeneous(physics_list: Sequence[Physics]) -> Physics:
    """Stack structurally identical physics into one physics whose every
    parameter and buffer has a leading operator axis (physics.py:56); raises
    ``ValueError`` where they differ. It is there for the JAX package's API:
    the port's stacks do not use it, each device applying the operators of
    its block one after another."""
    if not physics_list or not _homogeneous(physics_list):
        raise ValueError("operators are not structurally identical; use StackedPhysics")
    out = copy.deepcopy(physics_list[0])
    for name in _tensors(out):
        owner, _, leaf = name.rpartition(".")
        mod = out.get_submodule(owner) if owner else out
        value = torch.stack([_tensors(p)[name].detach() for p in physics_list])
        if leaf in mod._parameters:
            mod._parameters[leaf] = torch.nn.Parameter(value, requires_grad=False)
        else:
            mod._buffers[leaf] = value
    return out


def _seeds(generator, n: int) -> list:
    """One seed an operator, from ``generator`` (a CPU generator seeded 0 if
    None): the split of the JAX key into one key an operator (physics.py:179)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return torch.randint(0, 2 ** 62, (n,), generator=generator,
                         device=generator.device).tolist()


class DistributedStackedPhysics(Physics):
    """A stack of (possibly nonlinear) operators over the ``op`` mesh axis
    (physics.py:82).

    :param physics: a list of physics, or a factory ``f(index, device,
        factory_kwargs) -> Physics``.
    :param ctx: :class:`DistributedContext` with an ``op_axis`` axis.
    :param num_operators: the stack's size (required with a factory).
    :param op_axis: the mesh axis.
    :param gather_strategy: ``"naive"``, ``"concatenated"`` or
        ``"broadcast"``, checked and ignored (see :mod:`~deepinv_tpu_torch.parallel`).
    :param factory_kwargs: the dict handed to the factory.

    ``batched`` is the operators of a homogeneous stack in their blocks,
    ``[(device, [physics, ...]), ...]``, and None for a heterogeneous stack,
    whose operators stay where they are, in ``physics_list``.
    """

    def __init__(self, physics, ctx: DistributedContext, num_operators: Optional[int] = None,
                 op_axis: str = "op", gather_strategy: str = "concatenated",
                 factory_kwargs: Optional[dict] = None):
        if gather_strategy not in ("naive", "concatenated", "broadcast"):
            raise ValueError(f"gather_strategy must be naive/concatenated/broadcast, got "
                             f"{gather_strategy!r}")
        super().__init__()
        self.ctx = ctx
        self.op_axis = op_axis
        devs = ctx.axis_devices(op_axis)
        if isinstance(physics, (list, tuple)):
            ops = list(physics)
        elif callable(physics) and not isinstance(physics, Physics):
            if num_operators is None:
                raise ValueError("when passing a factory callable, num_operators is required "
                                 "(reference distribute.py:77)")
            per = math.ceil(num_operators / len(devs))
            ops = [physics(i, devs[i // per], factory_kwargs) for i in range(num_operators)]
        else:
            raise ValueError(f"cannot build an operator stack from {type(physics)}")
        self.n_ops = len(ops)
        self.n_pad = (-self.n_ops) % len(devs)
        self.device = devs[0]
        if _homogeneous(ops):
            per = (self.n_ops + self.n_pad) // len(devs)
            self.batched = [(dev, [replica(p, dev) for p in ops[j * per:(j + 1) * per]])
                            for j, dev in enumerate(devs) if ops[j * per:(j + 1) * per]]
            self.physics_list = [p for _, block in self.batched for p in block]
        else:
            self.batched = None
            self.physics_list = ops

    def _gather(self, outs) -> torch.Tensor:
        return torch.stack([o.to(self.device, non_blocking=True) for o in outs])

    def A(self, x, **params):
        """``(n_ops, B, C, ...)`` on the axis' first device for a homogeneous
        stack, a TensorList otherwise."""
        if self.batched is None:
            return TensorList([p.A(x, **params) for p in self.physics_list])
        outs = []
        for dev, block in self.batched:
            xd = x.to(dev, non_blocking=True)
            outs += [p.A(xd, **params) for p in block]
        return self._gather(outs)

    def forward(self, x, generator=None, **params):
        """``N(A(x))``, each operator's noise from a generator of its own
        device seeded from ``generator``."""
        seeds = iter(_seeds(generator, self.n_ops))
        if self.batched is None:
            return TensorList([p(x, generator=torch.Generator(device=x.device).manual_seed(
                next(seeds)), **params) for p in self.physics_list])
        outs = []
        for dev, block in self.batched:
            xd = x.to(dev, non_blocking=True)
            outs += [p(xd, generator=torch.Generator(device=dev).manual_seed(next(seeds)),
                       **params) for p in block]
        return self._gather(outs)

    def _adjoint_sum(self, y) -> torch.Tensor:
        """``sum_i A_i^T y_i``: each device's operators in order, then the
        devices' partial sums on the first device in device order."""
        if isinstance(y, TensorList):
            y = torch.stack(list(y))
        total, i = None, 0
        for dev, block in self.batched:
            part = None
            for p in block:
                a = p.A_adjoint(y[i].to(dev, non_blocking=True))
                part = a if part is None else part + a
                i += 1
            part = part.to(self.device, non_blocking=True)
            total = part if total is None else total + part
        return total

    def A_dagger(self, y, x_init=None, max_iter: int = 50, lr: float = 1e-1):
        """Pseudo-inverse of the nonlinear stack by ``max_iter`` gradient
        steps of size ``lr`` on ``1/2 sum_i ||A_i(x) - y_i||^2``
        (physics.py:199), from ``x_init`` or, for operators with an adjoint,
        from the summed adjoints."""
        if x_init is None:
            if self.batched is None or not hasattr(self.physics_list[0], "A_adjoint"):
                raise ValueError("x_init required for nonlinear A_dagger")
            x_init = self._adjoint_sum(y)
        x = x_init.detach()
        for _ in range(max_iter):
            with torch.enable_grad():
                u = x.requires_grad_()
                r = self.A(u)
                loss = 0.5 * sum(((a - b).abs() ** 2).sum() for a, b in zip(r, y))
                g = torch.autograd.grad(loss, u)[0]
            x = (x - lr * g).detach()
        return x


class DistributedStackedLinearPhysics(DistributedStackedPhysics, LinearPhysics):
    """A stack of structurally identical linear operators over the ``op``
    mesh axis (physics.py:224): the summed adjoint, its normal operator, the
    power method, the conjugate-gradient pseudo-inverse and ``prox_l2``."""

    def __init__(self, physics, ctx: DistributedContext, **kwargs):
        super().__init__(physics, ctx, **kwargs)
        if self.batched is None:
            raise ValueError("DistributedStackedLinearPhysics needs structurally identical "
                             "operators; use StackedLinearPhysics for heterogeneous stacks")

    def A_adjoint(self, y, **params):
        """``sum_i A_i^T y_i`` of stacked ``(n_ops, ...)`` measurements or a
        TensorList (what ``StackedPhysics.A`` gives), so serial and
        distributed stacks interchange."""
        return self._adjoint_sum(y)

    def A_adjoint_A(self, x, **params):
        return self.A_adjoint(self.A(x))

    def A_vjp(self, x, v):
        return self.A_adjoint(v)

    def compute_norm(self, x0, max_iter: int = 50, tol: float = 1e-6):
        """``||A||^2`` by the power method on the summed normal operator
        (physics.py:282)."""
        return power_method(self.A_adjoint_A, x0, max_iter=max_iter, tol=tol)

    def A_dagger(self, y, max_iter: int = 100, tol: float = 1e-6, **kwargs):
        """Conjugate gradient on the normal equations (physics.py:288)."""
        from ..optim.linear import conjugate_gradient

        return conjugate_gradient(self.A_adjoint_A, self.A_adjoint(y), max_iter=max_iter, tol=tol)

    def prox_l2(self, z, y, gamma, max_iter: int = 100, tol: float = 1e-6, **kwargs):
        """``argmin_x gamma/2 sum_i ||A_i x - y_i||^2 + 1/2 ||x - z||^2`` by
        conjugate gradient from ``z`` (physics.py:297); ``gamma`` a number or
        a per-sample tensor."""
        from ..optim.linear import _gmul, conjugate_gradient

        b = _gmul(gamma, self.A_adjoint(y)) + z
        return conjugate_gradient(lambda v: _gmul(gamma, self.A_adjoint_A(v)) + v, b, init=z,
                                  max_iter=max_iter, tol=tol)
