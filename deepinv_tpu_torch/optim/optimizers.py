"""Reconstruction algorithms (port of deepinv_tpu/optim/optimizers.py).

``optim_builder("PGD", data_fidelity, prior, params_algo, max_iter)`` returns a
:class:`BaseOptim`, a reconstructor ``model(y, physics) -> x``. Each entry of
``params_algo`` is a scalar (the same every iteration) or a list/tensor with
one value per iteration; it is stored as a ``(max_iter, ...)`` buffer, or, with
``unfold=True``, as an ``nn.Parameter``, so that an unfolded network trains its
schedule as the JAX package trains the schedule's pytree leaves
(optimizers.py:11-15). The reconstructor, with its prior and denoiser, is put
on ``device``: the CUDA device unless the caller passes another. The named
builders (``PGD``, ``FISTA``, ``ADMM``, ``DRS``, ``CP``, ``GD``, ``HQS``,
``MD``, ``PMD``, ``SIRT``, ``MLEM``) and ``PDCP`` are ``optim_builder`` with the
iteration fixed. Early stop, Anderson acceleration, backtracking and ``remat``
are :class:`FixedPoint`'s.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ..device import resolve_device
from ..models.base import Reconstructor
from ..utils.profiling import RECON, span
from .data_fidelity import L2
from .fixed_point import FixedPoint
from .iterators import (ADMMIteration, CPIteration, DRSIteration, FISTAIteration, GDIteration,
                        HQSIteration, MDIteration, MLEMIteration, OptimIterator, PGDIteration,
                        PMDIteration, SIRTIteration, SMIteration, objective_function)
from .prior import Zero

__all__ = ["BaseOptim", "optim_builder", "create_iterator", "PGD", "FISTA", "ADMM", "DRS", "CP",
           "GD", "HQS", "MD", "PMD", "SIRT", "MLEM", "PDCP"]

_ITERATORS = {"GD": GDIteration, "PGD": PGDIteration, "FISTA": FISTAIteration,
              "HQS": HQSIteration, "ADMM": ADMMIteration, "DRS": DRSIteration, "CP": CPIteration,
              "MD": MDIteration, "PMD": PMDIteration, "SM": SMIteration, "SIRT": SIRTIteration,
              "MLEM": MLEMIteration}

_DEFAULT_PARAMS = {
    "stepsize": 1.0,
    "g_param": 0.05,
    "lambda": 1.0,
    "beta": 1.0,
    "stepsize_dual": 1.0,
    "a": 3.0,
}


def create_iterator(iteration, *, g_first: bool = False, K=None, K_adjoint=None,
                    bregman_potential=None, lamb: float = 10.0,
                    preprocessing=None) -> OptimIterator:
    """Map an iteration name to an iterator (optimizers.py:89). ``K`` and
    ``K_adjoint`` are Chambolle-Pock's explicit splitting operator
    (:107-114), ``bregman_potential`` the geometry of MD and PMD (:98-99),
    ``lamb`` and ``preprocessing`` the spectral method's (:100-105). They
    are keywords: JAX's positional ``prior`` and ``cost_fn``, which it does
    not use, are not taken, so a JAX positional call raises here."""
    if isinstance(iteration, OptimIterator):
        return iteration
    name = str(iteration).upper()
    if name not in _ITERATORS:
        raise ValueError(f"unknown iteration {iteration!r}; choose from {sorted(_ITERATORS)}")
    if (K is not None or K_adjoint is not None) and name != "CP":
        raise ValueError(f"K and K_adjoint belong to the CP iteration, not {name}")
    if bregman_potential is not None and name not in ("MD", "PMD"):
        raise ValueError(f"bregman_potential belongs to the MD and PMD iterations, not {name}")
    if name == "CP":
        return CPIteration(g_first=g_first, K=K, K_adjoint=K_adjoint)
    if name in ("MD", "PMD"):
        return _ITERATORS[name](bregman_potential=bregman_potential, g_first=g_first)
    if name == "SM":
        return SMIteration(lamb=lamb, preprocessing=preprocessing, g_first=g_first)
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
    :param early_stop: stop when the iterate's relative change is below
        ``thres_conv`` (``crit_conv`` names the criterion, ``"residual"``).
    :param anderson_acceleration: Anderson mixing over ``history_size``
        iterates.
    :param backtracking: Armijo backtracking on the stepsize.
    :param remat: recompute each iteration in the backward.
    :param unfold: the schedule as ``nn.Parameter``s (``param_<name>``), each
        of them trainable, as JAX trains every schedule leaf; buffers
        otherwise.
    :param device: where the schedule, the prior and the data fidelity (and
        a denoiser in them) live; the CUDA device by default.
    :param kwargs: ``K``, ``K_adjoint`` for the CP iteration,
        ``bregman_potential`` for MD and PMD, ``lamb`` and ``preprocessing``
        for SM (:func:`create_iterator`).
    """

    def __init__(self, iterator, data_fidelity=None, prior=None, params_algo: dict = None,
                 max_iter: int = 100, early_stop: bool = False, crit_conv: str = "residual",
                 thres_conv: float = 1e-5, custom_init: Optional[Callable] = None,
                 anderson_acceleration: bool = False, history_size: int = 5,
                 g_first: bool = False, unfold: bool = False, remat: bool = False,
                 backtracking: bool = False, verbose: bool = False, device=None, **kwargs):
        device = resolve_device(device)
        super().__init__()
        self.verbose = verbose
        self.iterator = create_iterator(iterator, g_first=g_first, **kwargs)
        self.data_fidelity = data_fidelity if data_fidelity is not None else L2()
        self.prior = prior if prior is not None else Zero()
        self.max_iter = max_iter
        self.custom_init = custom_init
        self.unfold = unfold
        pa = dict(_DEFAULT_PARAMS)
        pa.update(params_algo or {})
        self._param_names = tuple(pa)
        for k, v in pa.items():
            if unfold:
                self.register_parameter(f"param_{k}", nn.Parameter(self._stack_param(v, max_iter)))
            else:
                self.register_buffer(f"param_{k}", self._stack_param(v, max_iter))
        self.fixed_point = FixedPoint(
            self.iterator, max_iter=max_iter, early_stop=early_stop, crit_conv=crit_conv,
            thres_conv=thres_conv, anderson_acceleration=anderson_acceleration,
            history_size=history_size, remat=remat, backtracking=backtracking)
        self.to(device)

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
        with span(RECON, solver=type(self.iterator).__name__.removesuffix("Iteration"),
                  max_iter=self.max_iter):
            # A^T y is computed once for the whole reconstruction (the initial
            # iterate and every gradient step share it)
            with self.data_fidelity.fixed_measurement(y, physics):
                x0 = self.init_iterate(y, physics, x_init)
                X = self.fixed_point(x0, self.data_fidelity, self.prior, self.params_algo, y,
                                     physics)
            return self.iterator.get_output(X)

    def objective(self, x, y, physics):
        """The objective ``F(x)`` per sample at the last iteration's
        parameters (optimizers.py:215)."""
        return objective_function(x, self.data_fidelity, self.prior, self.update_params_fn(-1),
                                  y, physics)

    def update_params_fn(self, it: int) -> dict:
        """The parameters of iteration ``it`` (optimizers.py:222)."""
        return {k: v[it] for k, v in self.params_algo.items()}

    def update_prior_fn(self, it: int):
        """The prior of iteration ``it``: a list of priors cycles
        (optimizers.py:227)."""
        p = self.prior
        return p[it % len(p)] if isinstance(p, (list, tuple, nn.ModuleList)) else p

    def update_data_fidelity_fn(self, it: int):
        """The data fidelity of iteration ``it``: a list cycles
        (optimizers.py:233)."""
        d = self.data_fidelity
        return d[it % len(d)] if isinstance(d, (list, tuple, nn.ModuleList)) else d

    def DEQ_additional_step(self, X, y, physics, **kwargs):
        """One more iteration at the last iteration's parameters
        (optimizers.py:307), the step a DEQ differentiates at its
        equilibrium; a list of priors or data fidelities gives that
        iteration's."""
        it = self.max_iter - 1
        return self.fixed_point.single_iteration(X, self.update_data_fidelity_fn(it),
                                                 self.update_prior_fn(it),
                                                 self.update_params_fn(-1), y, physics, **kwargs)

    def check_conv_fn(self, it: int, X_prev, X) -> bool:
        """Host-side convergence test (optimizers.py:280): the batch mean of
        each sample's ``||x_prev - x|| / (||x|| + 1e-6)`` below ``thres_conv``."""
        xp = self.iterator.get_output(X_prev).flatten(1)
        x = self.iterator.get_output(X).flatten(1)
        crit = float(((xp - x).norm(dim=-1) / (x.norm(dim=-1) + 1e-6)).mean())
        converged = crit < self.fixed_point.thres_conv
        if converged and self.verbose:
            print(f"Iteration {it}, converge crit. = {crit:.2E}")
        return converged

    def backtracking_check_fn(self, X_prev, X, cur_params, y, physics, data_fidelity=None,
                              prior=None):
        """Whether the objective rose from ``X_prev`` to ``X``, a 0-d bool
        tensor: the Armijo test (optimizers.py:295)."""
        df = data_fidelity if data_fidelity is not None else self.data_fidelity
        pr = prior if prior is not None else self.prior
        F_old = objective_function(self.iterator.get_output(X_prev), df, pr, cur_params, y,
                                   physics).sum()
        F_new = objective_function(self.iterator.get_output(X), df, pr, cur_params, y,
                                   physics).sum()
        return F_new > F_old


def optim_builder(iteration, data_fidelity=None, prior=None, params_algo=None,
                  max_iter: int = 100, **kwargs) -> BaseOptim:
    """Build a reconstruction algorithm (optimizers.py:325)."""
    return BaseOptim(iteration, data_fidelity=data_fidelity, prior=prior,
                     params_algo=params_algo, max_iter=max_iter, **kwargs)


def _named(iteration: str):
    def build(data_fidelity=None, prior=None, params_algo=None, max_iter: int = 100, **kwargs):
        return BaseOptim(iteration, data_fidelity=data_fidelity, prior=prior,
                         params_algo=params_algo, max_iter=max_iter, **kwargs)

    build.__name__ = build.__qualname__ = iteration
    build.__doc__ = f"{iteration} reconstructor (optimizers.py:367-393, 47-62)."
    return build


PGD = _named("PGD")
FISTA = _named("FISTA")
ADMM = _named("ADMM")
DRS = _named("DRS")
CP = _named("CP")
GD = _named("GD")
HQS = _named("HQS")
MD = _named("MD")
PMD = _named("PMD")
SIRT = _named("SIRT")
MLEM = _named("MLEM")


def PDCP(data_fidelity=None, prior=None, K=None, K_adjoint=None, params_algo=None,
         max_iter: int = 100, **kwargs) -> BaseOptim:
    """Chambolle-Pock with an explicit linear operator ``K`` (optimizers.py:396);
    with the default identity ``K`` it is ``CP``."""
    return BaseOptim("CP", data_fidelity=data_fidelity, prior=prior, params_algo=params_algo,
                     max_iter=max_iter, K=K, K_adjoint=K_adjoint, **kwargs)
