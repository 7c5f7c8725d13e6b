"""Reconstruction algorithms (port of deepinv_tpu/optim/optimizers.py).

``optim_builder("PGD", data_fidelity, prior, params_algo, max_iter)`` returns a
:class:`BaseOptim`, a reconstructor ``model(y, physics) -> x``. Each entry of
``params_algo`` is a scalar (the same every iteration) or a list/tensor with
one value per iteration; it is stored as a ``(max_iter, ...)`` buffer, so
``model.to(device)`` moves the schedule with the denoiser.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..models.base import Reconstructor
from .data_fidelity import L2
from .fixed_point import FixedPoint
from .iterators import HQSIteration, OptimIterator, PGDIteration
from .prior import Zero

__all__ = ["BaseOptim", "optim_builder", "create_iterator"]

_ITERATORS = {"HQS": HQSIteration, "PGD": PGDIteration}

# The JAX package's other iterators (iterators.py) and the ROADMAP item that ports each.
_WAITING = {name: "ROADMAP queue 1 item 8 (slice 6)"
            for name in ("GD", "FISTA", "ADMM", "DRS", "CP", "MD", "PMD", "SM", "SIRT", "MLEM")}

_DEFAULT_PARAMS = {
    "stepsize": 1.0,
    "g_param": 0.05,
    "lambda": 1.0,
    "beta": 1.0,
    "stepsize_dual": 1.0,
    "a": 3.0,
}


def create_iterator(iteration, g_first: bool = False) -> OptimIterator:
    """Map an iteration name to an iterator (optimizers.py:89)."""
    if isinstance(iteration, OptimIterator):
        return iteration
    name = str(iteration).upper()
    if name in _WAITING:
        raise NotImplementedError(f"the {name} iterator waits for {_WAITING[name]}")
    if name not in _ITERATORS:
        raise ValueError(f"unknown iteration {iteration!r}; choose from "
                         f"{sorted(set(_ITERATORS) | set(_WAITING))}")
    return _ITERATORS[name](g_first=g_first)


class BaseOptim(Reconstructor):
    """Optimization-algorithm reconstructor (deepinv_tpu/optim/optimizers.py:118).

    :param iterator: iterator or iteration name.
    :param data_fidelity: default :class:`~deepinv_tpu_torch.optim.L2`.
    :param prior: default :class:`~deepinv_tpu_torch.optim.prior.Zero`.
    :param params_algo: dict of scalars or per-iteration sequences.
    :param max_iter: number of iterations.
    :param custom_init: ``f(y, physics) -> x0`` (default ``A_adjoint(y)``).
    :param g_first: prior step first.
    """

    def __init__(self, iterator, data_fidelity=None, prior=None, params_algo: dict = None,
                 max_iter: int = 100, custom_init: Optional[Callable] = None,
                 g_first: bool = False, early_stop: bool = False,
                 anderson_acceleration: bool = False, backtracking: bool = False):
        super().__init__()
        if early_stop or anderson_acceleration or backtracking:
            raise NotImplementedError(
                "early stopping, Anderson acceleration and backtracking wait for "
                "ROADMAP queue 1 item 8 (slice 6)")
        self.iterator = create_iterator(iterator, g_first=g_first)
        self.data_fidelity = data_fidelity if data_fidelity is not None else L2()
        self.prior = prior if prior is not None else Zero()
        self.max_iter = max_iter
        self.custom_init = custom_init
        pa = dict(_DEFAULT_PARAMS)
        pa.update(params_algo or {})
        self._param_names = tuple(pa)
        for k, v in pa.items():
            self.register_buffer(f"param_{k}", self._stack_param(v, max_iter))
        self.fixed_point = FixedPoint(self.iterator, max_iter=max_iter)

    @property
    def params_algo(self) -> dict:
        """``{name: (max_iter, ...) tensor}``, the per-iteration schedule."""
        return {k: getattr(self, f"param_{k}") for k in self._param_names}

    @staticmethod
    def _stack_param(v, max_iter: int) -> torch.Tensor:
        """Per-iteration schedule (optimizers.py:181): a scalar repeats, a
        shorter list cycles."""
        if isinstance(v, (list, tuple)):
            v = torch.as_tensor(v, dtype=torch.float32)
            if v.shape[0] != max_iter:
                v = v.repeat(-(-max_iter // v.shape[0]))[:max_iter]
            return v
        v = torch.as_tensor(v, dtype=torch.float32)
        if v.dim() == 0:
            return v.expand(max_iter).clone()
        if v.shape[0] == max_iter:
            return v.clone()
        return v[None].expand((max_iter,) + tuple(v.shape)).clone()

    def init_iterate(self, y, physics, x_init=None):
        """``x0 = A_adjoint(y)`` unless given (optimizers.py:196)."""
        if x_init is not None:
            return x_init
        if self.custom_init is not None:
            return self.custom_init(y, physics)
        if hasattr(physics, "A_adjoint"):
            return self.data_fidelity.adjoint_measurement(y, physics)
        return y

    def forward(self, y, physics, x_init=None, **kwargs):
        # A^T y is computed once for the whole reconstruction (the initial
        # iterate and every gradient step share it)
        with self.data_fidelity.fixed_measurement(y, physics):
            x0 = self.init_iterate(y, physics, x_init)
            X = self.fixed_point(x0, self.data_fidelity, self.prior, self.params_algo, y,
                                 physics)
        return self.iterator.get_output(X)


def optim_builder(iteration, data_fidelity=None, prior=None, params_algo=None,
                  max_iter: int = 100, **kwargs) -> BaseOptim:
    """Build a reconstruction algorithm (optimizers.py:325)."""
    return BaseOptim(iteration, data_fidelity=data_fidelity, prior=prior,
                     params_algo=params_algo, max_iter=max_iter, **kwargs)
