"""``distribute()`` (port of deepinv_tpu/parallel/distribute.py): one entry
point that wraps an object for the mesh.

- a list or stack of physics, or a factory ``f(index, device,
  factory_kwargs)``: :class:`DistributedStackedLinearPhysics` (all linear) or
  :class:`DistributedStackedPhysics`;
- a data fidelity (one, a list, or a factory): :class:`DistributedDataFidelity`;
- a denoiser or any other callable: :class:`DistributedProcessing`.

``type_object`` (``"auto"``, ``"physics"``, ``"linear_physics"``,
``"data_fidelity"``, ``"denoiser"``) settles what a factory builds; the
other keywords go to the wrapper that takes them (distribute.py:119-198).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..optim.data_fidelity import DataFidelity
from ..physics.base import LinearPhysics, Physics, StackedLinearPhysics, StackedPhysics
from .context import DistributedContext
from .physics import DistributedStackedLinearPhysics, DistributedStackedPhysics
from .processing import DistributedProcessing

__all__ = ["distribute", "DistributedDataFidelity"]


class DistributedDataFidelity(DataFidelity):
    """A data fidelity summed over a distributed operator stack
    (distribute.py:37): ``f(x) = sum_i d_i(A_i x, y_i)`` and its gradient
    ``sum_i A_i^T grad d_i(A_i x, y_i)``, the sum taken by the stack's
    adjoint. On any other physics it is ``data_fidelity`` itself.

    :param data_fidelity: one :class:`DataFidelity` for every operator, a
        list of one an operator, or a factory ``f(index, device,
        factory_kwargs)``, called once an index (with device None, as the JAX
        package calls it).
    :param ctx: the :class:`DistributedContext`.
    :param num_operators: required with a factory.
    """

    def __init__(self, data_fidelity, ctx: DistributedContext,
                 num_operators: Optional[int] = None, factory_kwargs: Optional[dict] = None):
        if isinstance(data_fidelity, (list, tuple)):
            fidelity_list = list(data_fidelity)
        elif isinstance(data_fidelity, DataFidelity):
            fidelity_list = None
        elif callable(data_fidelity):
            if num_operators is None:
                raise ValueError("factory data_fidelity needs num_operators "
                                 "(reference distribute.py:195)")
            fidelity_list = [data_fidelity(i, None, factory_kwargs) for i in range(num_operators)]
        else:
            raise ValueError(f"cannot distribute {type(data_fidelity)}")
        first = fidelity_list[0] if fidelity_list is not None else data_fidelity
        super().__init__(d=first.d)
        self.fidelity_list = fidelity_list
        self.data_fidelity = first
        self.ctx = ctx

    def _per_op(self, method: str, Ax, y):
        """A distance method of each operator's fidelity on its measurements,
        stacked on a leading operator axis."""
        fids = self.fidelity_list or [self.data_fidelity] * len(Ax)
        return torch.stack([getattr(f.d, method)(Ax[i], y[i]) for i, f in enumerate(fids)])

    def fn(self, x, y, physics, *args, **kwargs):
        if isinstance(physics, DistributedStackedLinearPhysics):
            return self._per_op("fn", physics.A(x), y).sum(0)
        return self.data_fidelity.fn(x, y, physics, *args, **kwargs)

    def grad(self, x, y, physics, *args, **kwargs):
        if isinstance(physics, DistributedStackedLinearPhysics):
            return physics.A_adjoint(self._per_op("grad", physics.A(x), y))
        return self.data_fidelity.grad(x, y, physics, *args, **kwargs)

    def forward(self, x, y, physics, *args, **kwargs):
        return self.fn(x, y, physics, *args, **kwargs)


def _is_physics_spec(obj) -> bool:
    if isinstance(obj, StackedPhysics):
        return True
    return (isinstance(obj, (list, tuple)) and len(obj) > 0
            and all(isinstance(p, Physics) for p in obj))


def _all_linear(obj) -> bool:
    if isinstance(obj, StackedLinearPhysics):
        return True
    members = obj.physics_list if isinstance(obj, StackedPhysics) else obj
    return all(isinstance(p, LinearPhysics) for p in members)


def distribute(obj, ctx: DistributedContext = None, *, num_operators: Optional[int] = None,
               type_object: str = "auto", gather_strategy: str = "concatenated",
               tiling_strategy: str = "overlap_tiling", tiling_dims=None, patch_size: int = None,
               overlap: int = 8, max_batch_size: Optional[int] = None,
               factory_kwargs: Optional[dict] = None, **kwargs):
    """Wrap ``obj`` for the mesh (distribute.py:119).

    :param obj: a list or stack of physics, a physics factory, a data
        fidelity (or a list or factory of them), or a denoiser.
    :param ctx: the :class:`DistributedContext` (default: every CUDA device
        on one axis).
    :param type_object: ``"auto"`` or what to build; a bare callable is a
        denoiser unless this says otherwise.
    """
    if ctx is None:
        ctx = DistributedContext()
    if type_object == "auto":
        if _is_physics_spec(obj):
            type_object = "linear_physics" if _all_linear(obj) else "physics"
        elif isinstance(obj, DataFidelity) or (
                isinstance(obj, (list, tuple)) and len(obj) > 0
                and all(isinstance(f, DataFidelity) for f in obj)):
            type_object = "data_fidelity"
        elif callable(obj):
            type_object = "denoiser"
        else:
            raise ValueError(f"cannot distribute object of type {type(obj)}")
    if isinstance(obj, StackedPhysics):
        obj = list(obj.physics_list)
    if type_object in ("linear_physics", "physics"):
        cls = (DistributedStackedLinearPhysics if type_object == "linear_physics"
               else DistributedStackedPhysics)
        return cls(obj, ctx, num_operators=num_operators, gather_strategy=gather_strategy,
                   factory_kwargs=factory_kwargs, **kwargs)
    if type_object == "data_fidelity":
        return DistributedDataFidelity(obj, ctx, num_operators=num_operators,
                                       factory_kwargs=factory_kwargs)
    if type_object == "denoiser":
        return DistributedProcessing(obj, ctx, overlap=overlap, tiling_strategy=tiling_strategy,
                                     tiling_dims=tiling_dims, max_batch_size=max_batch_size,
                                     patch_size=patch_size, **kwargs)
    raise ValueError(f"unknown type_object {type_object!r}")
