"""Group-action transforms (port of deepinv_tpu/transform/base.py).

A transform draws random group parameters (``get_params``, from a
``torch.Generator``), applies the action (``transform(x, **params)``) and can
invert it (``inverse``): the machinery of the equivariant-imaging loss.
"""

from __future__ import annotations

from itertools import product

import torch

__all__ = ["Transform"]


class Transform:
    """Base class of random group-action transforms (base.py:73).

    :param n_trans: number of transformed versions per call.
    :param seed: the seed of the generator :meth:`symmetrize` makes when the
        caller gives none.
    """

    def __init__(self, n_trans: int = 1, seed: int = 0):
        self.n_trans = n_trans
        self.seed = seed

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

    def iterate_params(self, params: dict) -> list:
        """Every combination of single parameter values, one dict each, each
        value a 1-element tensor (base.py:124): full-group averaging
        enumerates each element once instead of sampling."""
        keys = list(params)
        values = [torch.as_tensor(params[k]).reshape(-1) for k in keys]
        return [{k: v[i:i + 1] for k, v, i in zip(keys, values, idx)}
                for idx in product(*(range(len(v)) for v in values))]

    def symmetrize(self, f, average: bool = True):
        """``x -> mean_t t^-1(f(t(x)))`` over ``n_trans`` drawn transforms
        (base.py:144); without ``average`` the ``n_trans`` versions stay
        stacked in the batch. The parameters come from the call's
        ``generator``, or one seeded from :attr:`seed` on ``x``'s device."""

        def sym(x, *args, generator=None, **kwargs):
            if generator is None:
                generator = torch.Generator(device=x.device).manual_seed(int(self.seed))
            params = self.get_params(x, generator)
            out = self.inverse(f(self.transform(x, **params), *args, **kwargs), **params)
            if average and self.n_trans > 1:
                out = out.reshape((self.n_trans, x.shape[0]) + tuple(out.shape[1:])).mean(0)
            return out

        return sym

    def _repeat(self, x):
        """The batch tiled ``n_trans`` times (base.py:172)."""
        return x.repeat((self.n_trans,) + (1,) * (x.dim() - 1))
