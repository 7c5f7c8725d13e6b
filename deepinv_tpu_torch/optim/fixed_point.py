"""Fixed-point iteration engine (port of deepinv_tpu/optim/fixed_point.py),
fixed-iteration mode: a Python loop over the per-iteration parameters, in
place of the JAX package's ``lax.scan`` (fixed_point.py:160-200). Early
stopping, Anderson acceleration and backtracking wait for ROADMAP queue 1
item 8."""

from __future__ import annotations

from torch import nn

__all__ = ["FixedPoint"]


class FixedPoint(nn.Module):
    """Run ``X_{k+1} = iterator(X_k, ...)`` for ``max_iter`` iterations
    (deepinv_tpu/optim/fixed_point.py:47).

    :param iterator: an :class:`~deepinv_tpu_torch.optim.iterators.OptimIterator`.
    :param max_iter: number of iterations.
    """

    def __init__(self, iterator, max_iter: int = 50):
        super().__init__()
        self.iterator = iterator
        self.max_iter = max_iter

    def forward(self, x_init, data_fidelity, prior, params_iter, y, physics):
        """``params_iter`` maps each name to a tensor whose leading dimension
        is ``max_iter``; iteration k uses slice k."""
        X = self.iterator.init_state(x_init, y, physics)
        for k in range(self.max_iter):
            cur = {name: v[k] for name, v in params_iter.items()}
            X = self.iterator(X, data_fidelity, prior, cur, y, physics)
        return X
