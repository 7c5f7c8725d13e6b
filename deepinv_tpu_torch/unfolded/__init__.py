"""Unfolded and deep-equilibrium networks (port of deepinv_tpu/unfolded/).

An unfolded network is a :class:`~deepinv_tpu_torch.optim.BaseOptim` whose
schedule is a set of ``nn.Parameter``s (``unfold=True``): training it
backpropagates through the ``max_iter`` iterations, and the prior's denoiser
trains with it. A deep-equilibrium network runs one iteration map to its
fixed point and differentiates it implicitly (:func:`deq_fixed_point`).
"""

from __future__ import annotations

from torch import nn

from ..optim.data_fidelity import L2
from ..optim.optimizers import BaseOptim, create_iterator
from . import deq
from .deq import deq_fixed_point

__all__ = ["unfolded_builder", "DEQ_builder", "BaseUnfold", "BaseDEQ", "deq_fixed_point",
           "BaseOptim", "create_iterator", "L2"]


class BaseUnfold(BaseOptim):
    """Unfolded optimization network (deepinv_tpu/unfolded/__init__.py:27):
    :class:`BaseOptim` with its schedule trainable."""


def unfolded_builder(iteration, data_fidelity=None, prior=None, params_algo=None,
                     max_iter: int = 5, trainable_params=("stepsize", "g_param", "lambda"),
                     **kwargs) -> BaseUnfold:
    """Build an unfolded network (unfolded/__init__.py:35): every entry of
    the schedule an ``nn.Parameter`` (``unfold=True``); ``trainable_params``
    is accepted and not used, as in the JAX package, which trains every
    entry; the rest are :class:`BaseOptim`'s arguments (``device`` the CUDA
    device by default)."""
    return BaseUnfold(iteration, data_fidelity=data_fidelity, prior=prior,
                      params_algo=params_algo, max_iter=max_iter, unfold=True, **kwargs)


class BaseDEQ(BaseOptim):
    """Deep-equilibrium reconstructor (unfolded/__init__.py:78): the
    iterator's map at the schedule's last values, run to its fixed point by
    :func:`deq_fixed_point` (``max_iter`` maps at most, to the relative
    tolerance ``thres_conv``), its gradient by the adjoint fixed point
    (``max_iter_backward`` products at most). The schedule is a set of
    ``nn.Parameter``s; its last values and the prior's parameters take the
    gradient, as the JAX package's
    ``{"prior", "params"}`` trainables do; the data fidelity's do not.
    ``anderson_acceleration`` is accepted and not used, as in JAX.

    After a call, :attr:`last_run` holds :func:`deq_fixed_point`'s ``stats``.
    """

    def __init__(self, *args, max_iter_backward: int = 30, anderson_acceleration: bool = False,
                 **kwargs):
        super().__init__(*args, unfold=True, **kwargs)
        self.max_iter_backward = max_iter_backward
        self.last_run = None

    def forward(self, y, physics, x_init=None, **kwargs):
        cur = self.update_params_fn(-1)
        names = list(cur)
        prior = self.prior if isinstance(self.prior, nn.Module) else None
        params = [cur[k] for k in names] + (
            [p for p in prior.parameters() if p.requires_grad] if prior is not None else [])

        def T(params, x):
            c = dict(zip(names, params[:len(names)]))
            X = self.iterator({"est": (x, x), "it": 0}, self.data_fidelity, self.prior, c, y,
                              physics)
            return X["est"][0]

        self.last_run = stats = {}
        with self.data_fidelity.fixed_measurement(y, physics):
            x0 = self.init_iterate(y, physics, x_init)
            return deq_fixed_point(T, params, x0, max_iter=self.max_iter,
                                   tol=self.fixed_point.thres_conv,
                                   backward_iter=self.max_iter_backward, stats=stats)


def DEQ_builder(iteration, data_fidelity=None, prior=None, params_algo=None, max_iter: int = 50,
                max_iter_backward: int = 30, **kwargs) -> BaseDEQ:
    """Build a DEQ network (unfolded/__init__.py:112)."""
    return BaseDEQ(iteration, data_fidelity=data_fidelity, prior=prior, params_algo=params_algo,
                   max_iter=max_iter, max_iter_backward=max_iter_backward, **kwargs)
