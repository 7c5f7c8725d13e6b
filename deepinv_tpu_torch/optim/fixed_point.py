"""Fixed-point iteration engine (port of deepinv_tpu/optim/fixed_point.py).

Three runs, as in the JAX package (fixed_point.py:97-111):

- a fixed number of iterations, a Python loop over the per-iteration
  parameters in place of the ``lax.scan`` (:160-200), with Armijo
  backtracking if asked: one host read of the objective's change an
  iteration decides the retry that ``lax.cond`` decides on the TPU;
- early stop (:202): the relative change of the iterate, one number over the
  whole batch (:38-44), below ``thres_conv``, decided on the device
  (:func:`~deepinv_tpu_torch.core.device_while`) with a host read every
  ``check_every`` iterations, so the run stops at the reference's iteration;
- Anderson acceleration (:123-158, :218-258), always the full ``max_iter``
  iterations, its Gram matrix and small solve in f32 with TF32 and autocast
  off.

``remat`` recomputes each iteration in the backward
(``torch.utils.checkpoint``), the JAX package's ``jax.checkpoint``.

Each iteration runs in a ``dinv.iteration`` span (``k`` its index); a
backtracking retry is a second span of the same ``k`` with ``retry=1``, and
under early stop every body the loop evaluates has one, frozen ones
included.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core import CHECK_EVERY, TensorList, device_while
from ..core.linalg import exact_f32, leaves
from ..utils.profiling import ITERATION, span
from .iterators import objective_function

__all__ = ["FixedPoint"]


def _residual(x_new, x_old):
    """``||x_new - x_old|| / ||x_new||`` over every sample at once
    (fixed_point.py:38)."""
    num = sum(((a - b).abs() ** 2).sum() for a, b in zip(leaves(x_new), leaves(x_old)))
    den = sum((a.abs() ** 2).sum() for a in leaves(x_new))
    return torch.sqrt(num) / torch.sqrt(den).clamp_min(1e-12)


class FixedPoint(nn.Module):
    """Iterate ``X_{k+1} = iterator(X_k, ...)`` (deepinv_tpu/optim/fixed_point.py:47).

    :param iterator: an :class:`~deepinv_tpu_torch.optim.iterators.OptimIterator`.
    :param max_iter: iteration budget.
    :param early_stop: stop once the relative change of the iterate is below
        ``thres_conv``.
    :param crit_conv: the criterion's name, ``"residual"`` (the only one the
        early stop reads, as in the JAX package).
    :param thres_conv: convergence threshold.
    :param anderson_acceleration: Anderson mixing over ``history_size``
        iterates, relaxation ``beta_anderson_acc``, Tikhonov term
        ``eps_anderson_acc`` of its least-squares system.
    :param remat: recompute each iteration in the backward.
    :param backtracking: when an iteration raises the objective, take it
        again at ``backtracking_eta`` times the stepsize, a scale kept for
        the later iterations.
    :param check_every: iterations between two host reads of the early
        stop's flag.

    After a run, :attr:`last_run` holds ``{"iterations", "retries"}``: the
    iterations that moved the iterate (a 0-d device tensor under early stop)
    and backtracking's retries.
    """

    def __init__(self, iterator, max_iter: int = 50, early_stop: bool = False,
                 crit_conv: str = "residual", thres_conv: float = 1e-5,
                 anderson_acceleration: bool = False, history_size: int = 5,
                 beta_anderson_acc: float = 1.0, eps_anderson_acc: float = 1e-4,
                 remat: bool = False, backtracking: bool = False, backtracking_eta: float = 0.5,
                 check_every: int = CHECK_EVERY):
        super().__init__()
        self.iterator = iterator
        self.max_iter = max_iter
        self.early_stop = early_stop
        self.crit_conv = crit_conv
        self.thres_conv = thres_conv
        self.anderson_acceleration = anderson_acceleration
        self.history_size = history_size
        self.beta_anderson_acc = beta_anderson_acc
        self.eps_anderson_acc = eps_anderson_acc
        self.remat = remat
        self.backtracking = backtracking
        self.backtracking_eta = backtracking_eta
        self.check_every = check_every
        self.last_run = None

    def forward(self, x_init, data_fidelity, prior, params_iter, y, physics):
        """``params_iter`` maps each name to a tensor whose leading dimension
        is ``max_iter``; iteration k uses slice k."""
        X0 = self.iterator.init_state(x_init, y, physics)
        run = (self._run_anderson if self.anderson_acceleration else
               self._run_while if self.early_stop else self._run_scan)
        return run(X0, data_fidelity, prior, params_iter, y, physics)

    def _step(self, X, cur, data_fidelity, prior, y, physics):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(self.iterator, X, data_fidelity, prior, cur, y, physics,
                              use_reentrant=False)
        return self.iterator(X, data_fidelity, prior, cur, y, physics)

    def single_iteration(self, X, cur_data_fidelity, cur_prior, cur_params, y, physics,
                         **kwargs):
        """One step of the iterator at this iteration's parameters
        (fixed_point.py:115)."""
        return self._step(X, cur_params, cur_data_fidelity, cur_prior, y, physics)

    def _run_scan(self, X0, data_fidelity, prior, params_iter, y, physics):
        """``max_iter`` iterations; with backtracking, an iteration that
        raises the objective is taken again at the stepsize times
        ``backtracking_eta``, and the scale stays (fixed_point.py:160-200)."""
        X, scale, retries = X0, 1.0, 0
        for k in range(self.max_iter):
            cur = {name: v[k] for name, v in params_iter.items()}
            if not self.backtracking:
                with span(ITERATION, k=k):
                    X = self._step(X, cur, data_fidelity, prior, y, physics)
                continue
            cur["stepsize"] = cur["stepsize"] * scale
            with span(ITERATION, k=k):
                X_new = self._step(X, cur, data_fidelity, prior, y, physics)
                F_old = objective_function(X["est"][0], data_fidelity, prior, cur, y,
                                           physics).sum()
                F_new = objective_function(X_new["est"][0], data_fidelity, prior, cur, y,
                                           physics).sum()
                retry = bool(F_new > F_old)
            if retry:
                cur["stepsize"] = cur["stepsize"] * self.backtracking_eta
                with span(ITERATION, k=k, retry=1):
                    X_new = self._step(X, cur, data_fidelity, prior, y, physics)
                scale *= self.backtracking_eta
                retries += 1
            X = X_new
        self.last_run = {"iterations": self.max_iter, "retries": retries}
        return X

    def _run_while(self, X0, data_fidelity, prior, params_iter, y, physics):
        """Iterate until the relative change of the iterate is below
        ``thres_conv`` (fixed_point.py:202), stopped on the device."""
        k = 0

        def body(s):
            nonlocal k
            with span(ITERATION, k=k):
                cur = {name: v[k] for name, v in params_iter.items()}
                X_new = self._step({**X0, "est": s[0], "it": k}, cur, data_fidelity, prior, y,
                                   physics)
                k += 1
                return X_new["est"], _residual(X_new["est"][0], s[0][0]) < self.thres_conv

        converged = torch.zeros((), dtype=torch.bool, device=leaves(X0["est"][0])[0].device)
        (est, _), n = device_while(lambda s: ~s[1], body, (X0["est"], converged), self.max_iter,
                                   self.check_every)
        self.last_run = {"iterations": n, "retries": 0}
        return {**X0, "est": est, "it": n}

    def init_anderson_acceleration(self, x0):
        """Zero histories ``(X_hist, F_hist)`` of shape ``(B, history_size,
        N)`` for the iterate ``x0`` (fixed_point.py:123)."""
        n = sum(v[0].numel() for v in leaves(x0))
        B = leaves(x0)[0].shape[0]
        z = torch.zeros((B, self.history_size, n), device=leaves(x0)[0].device)
        return z, z.clone()

    def anderson_acceleration_step(self, k: int, x_prev_flat, gx_flat, X_hist, F_hist):
        """One Anderson update (fixed_point.py:134): ``(x_k, T(x_k) - x_k)``
        into slot ``k mod history_size`` of the histories, the mixing weights
        from the regularized least-squares system over the filled slots, and
        ``(x_acc_flat, X_hist, F_hist)``; the first iterate is ``T(x_0)``."""
        m = self.history_size
        B = x_prev_flat.shape[0]
        slot = k % m
        with exact_f32(x_prev_flat.device.type):
            x_prev_flat, gx_flat = x_prev_flat.float(), gx_flat.float()
            f = gx_flat - x_prev_flat
            X_hist = torch.cat([X_hist[:, :slot], x_prev_flat[:, None], X_hist[:, slot + 1:]], 1)
            F_hist = torch.cat([F_hist[:, :slot], f[:, None], F_hist[:, slot + 1:]], 1)
            if k + 1 < 2:
                return gx_flat, X_hist, F_hist
            valid = (torch.arange(m, device=f.device) < min(k + 1, m)).to(f.dtype)
            Fv = F_hist * valid[None, :, None]
            G = torch.einsum("bmn,bkn->bmk", Fv, Fv) + self.eps_anderson_acc * torch.eye(
                m, device=f.device)
            sol = torch.linalg.solve_ex(G, valid.expand(B, m)[..., None],
                                        check_errors=False)[0][..., 0]
            alpha = sol * valid / (sol * valid).sum(1, keepdim=True)
            beta = self.beta_anderson_acc
            x_acc = torch.einsum("bm,bmn->bn", alpha,
                                 beta * (X_hist + F_hist) + (1 - beta) * X_hist)
        return x_acc, X_hist, F_hist

    def _run_anderson(self, X0, data_fidelity, prior, params_iter, y, physics):
        """``max_iter`` iterations, each iterate mixed from the last
        ``history_size`` (fixed_point.py:218)."""
        x0 = X0["est"][0]
        shapes = [v.shape for v in leaves(x0)]

        def to_flat(x):
            return torch.cat([v.reshape(v.shape[0], -1) for v in leaves(x)], 1)

        def from_flat(f):
            out, o = [], 0
            for s in shapes:
                n = s[1:].numel()
                out.append(f[:, o:o + n].reshape(s))
                o += n
            return TensorList(out) if isinstance(x0, TensorList) else out[0]

        X_hist, F_hist = self.init_anderson_acceleration(x0)
        X = X0
        for k in range(self.max_iter):
            with span(ITERATION, k=k):
                cur = {name: v[k] for name, v in params_iter.items()}
                x_prev = to_flat(X["est"][0])
                X_new = self._step(X, cur, data_fidelity, prior, y, physics)
                x_acc, X_hist, F_hist = self.anderson_acceleration_step(
                    X["it"], x_prev, to_flat(X_new["est"][0]), X_hist, F_hist)
                X = {**X_new, "est": (from_flat(x_acc),) + tuple(X_new["est"][1:])}
        self.last_run = {"iterations": self.max_iter, "retries": 0}
        return X
