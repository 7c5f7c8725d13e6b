"""Group-action transforms (port of deepinv_tpu/transform/base.py).

A transform draws random group parameters (``get_params``, from a
``torch.Generator``), applies the action (``transform(x, **params)``) and can
invert it (``inverse``): the machinery of the equivariant-imaging loss.
"""

from __future__ import annotations

__all__ = ["Transform"]


class Transform:
    """Base class of random group-action transforms (base.py:73).

    :param n_trans: number of transformed versions per call.
    """

    def __init__(self, n_trans: int = 1):
        self.n_trans = n_trans

    def get_params(self, x, generator=None) -> dict:
        raise NotImplementedError

    def invert_params(self, params: dict) -> dict:
        """Negate every parameter (base.py:101)."""
        return {k: -v for k, v in params.items()}

    def transform(self, x, **params):
        raise NotImplementedError

    def __call__(self, x, generator=None):
        return self.transform(x, **self.get_params(x, generator))

    def inverse(self, x, generator=None, **params):
        """The inverse action (base.py:112); fresh parameters are drawn from
        ``generator`` if none are given."""
        if not params:
            params = self.get_params(x, generator)
        return self.transform(x, **self.invert_params(params))

    def _repeat(self, x):
        """The batch tiled ``n_trans`` times (base.py:172)."""
        return x.repeat((self.n_trans,) + (1,) * (x.dim() - 1))
