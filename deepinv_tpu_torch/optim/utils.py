"""Optimization utilities (port of deepinv_tpu/optim/utils.py): gradient
descent, the convergence test, and the configuration records of Anderson
acceleration, backtracking and deep equilibrium."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core import CHECK_EVERY, device_while, tree_map, tree_norm
from .iterators import objective_function

__all__ = ["gradient_descent", "check_conv", "objective_function",
           "AndersonAccelerationConfig", "BacktrackingConfig", "DEQConfig"]


def gradient_descent(grad_f, x0, step_size: float = 1.0, max_iter: int = 100, tol: float = 1e-5,
                     check_every: int = CHECK_EVERY):
    """``x <- x - step_size grad_f(x)`` until the gradient's norm is at most
    ``tol`` or ``max_iter`` iterations (utils.py:19), the stop decided on the
    device (:func:`~deepinv_tpu_torch.core.device_while`)."""
    def body(s):
        g = grad_f(s[0])
        return tree_map(lambda a, b: a - step_size * b, s[0], g), tree_norm(g)

    inf = torch.full((), float("inf"), device=x0.device)
    (x, _), _ = device_while(lambda s: s[1] > tol, body, (x0, inf), max_iter, check_every)
    return x


def _est(X):
    return X["est"][0] if isinstance(X, dict) else X


def check_conv(X_prev, X, it, crit_conv: str = "residual", thres_conv: float = 1e-5):
    """Whether the iterate's relative change (``"residual"``) or the cost's
    (``"cost"``, where the states carry one) is below ``thres_conv``
    (utils.py:37). Returns a 0-d bool tensor."""
    if crit_conv == "residual":
        a, b = _est(X_prev), _est(X)
        return tree_norm(a - b) / tree_norm(b).clamp_min(1e-12) < thres_conv
    if crit_conv == "cost":
        ca = X_prev.get("cost") if isinstance(X_prev, dict) else None
        cb = X.get("cost") if isinstance(X, dict) else None
        if ca is None or cb is None:
            return torch.tensor(False)
        return (cb - ca).abs() / cb.abs().clamp_min(1e-12) < thres_conv
    raise ValueError(crit_conv)


@dataclass
class AndersonAccelerationConfig:
    """Anderson acceleration's settings (utils.py:59); the fields are
    :class:`~deepinv_tpu_torch.optim.FixedPoint`'s arguments of these names."""

    history_size: int = 5
    beta_anderson_acc: float = 1.0
    eps_anderson_acc: float = 1e-4


@dataclass
class BacktrackingConfig:
    """Armijo backtracking's settings (utils.py:69): ``eta`` is
    :class:`~deepinv_tpu_torch.optim.FixedPoint`'s ``backtracking_eta``."""

    eta: float = 0.5
    gamma: float = 0.1


@dataclass
class DEQConfig:
    """Deep equilibrium's settings (utils.py:78): ``max_iter_backward`` is
    :func:`~deepinv_tpu_torch.unfolded.DEQ_builder`'s argument of that name."""

    max_iter_backward: int = 50
    anderson_acceleration: bool = False
    history_size: int = 5
