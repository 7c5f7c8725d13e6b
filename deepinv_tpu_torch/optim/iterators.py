"""Optimization iterators (port of deepinv_tpu/optim/iterators.py).

An iterator maps the state ``X = {"est": (x, z), "it": k}`` to the next one,
given the data fidelity, the prior, this iteration's parameters
(``stepsize``, ``g_param``, ``lambda``, ``beta``), ``y`` and the physics.
Only HQS is ported; the other iterators wait for their slices.
"""

from __future__ import annotations

from torch import nn

__all__ = ["OptimIterator", "HQSIteration"]


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

    def forward(self, X, data_fidelity, prior, params, y, physics):
        raise NotImplementedError


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
