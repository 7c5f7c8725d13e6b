"""Group-action transforms (port of deepinv_tpu/transform/base.py).

A transform draws random group parameters (``get_params``, from a
``torch.Generator``), applies the action (``transform(x, **params)``) and can
invert it (``inverse``): the machinery of the equivariant-imaging losses.
Transforms compose as in the JAX package (base.py:162-169): ``t1 * t2``
chains the actions (``t2`` first), ``t1 + t2`` stacks their outputs along the
batch and ``t1 | t2`` applies one of the two, drawn at each
``get_params``.
"""

from __future__ import annotations

from itertools import product

import torch

from ..utils.mixins import TimeMixin

__all__ = ["Transform", "Identity", "TransformParam"]


def _device(x, generator):
    return generator.device if generator is not None else x.device


class TransformParam:
    """A parameter with its own negation (base.py:27): ``-p`` applies
    ``neg`` (plain negation by default), e.g. the reciprocal of a zoom
    factor. :meth:`Transform.invert_params` inverts the port's own
    parameters; this wrapper carries a custom inverse in user code.

    :param p: the parameter, a tensor or a number.
    :param neg: the callable that unary ``-`` applies.
    """

    def __init__(self, p, neg=None):
        self.p = torch.as_tensor(p)
        self._neg = neg if neg is not None else (lambda v: -v)

    def __neg__(self):
        return TransformParam(self._neg(self.p), self._neg)

    def __getitem__(self, idx):
        return TransformParam(self.p[idx], self._neg)

    def __iter__(self):
        return iter(self.p)

    def __len__(self):
        return len(self.p)

    @property
    def shape(self):
        return self.p.shape

    def __repr__(self):
        return f"TransformParam({self.p!r})"


def _value(p):
    return p.p if isinstance(p, TransformParam) else p


class Transform(TimeMixin):
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

    def identity(self, x):
        return x

    def iterate_params(self, params: dict) -> list:
        """Every combination of single parameter values, one dict each, each
        value a 1-element tensor (base.py:124): full-group averaging
        enumerates each element once instead of sampling. A
        :class:`TransformParam` keeps its negation."""
        keys = list(params)
        negs = [params[k]._neg if isinstance(params[k], TransformParam) else None for k in keys]
        values = [torch.as_tensor(_value(params[k])).reshape(-1) for k in keys]
        out = []
        for idx in product(*(range(len(v)) for v in values)):
            d = {}
            for k, v, i, neg in zip(keys, values, idx, negs):
                d[k] = v[i:i + 1] if neg is None else TransformParam(v[i:i + 1], neg)
            out.append(d)
        return out

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

    # -- algebra (base.py:162-169) ----------------------------------------
    def __mul__(self, other: "Transform") -> "Transform":
        return _ChainTransform(self, other)

    def __add__(self, other: "Transform") -> "Transform":
        return _StackTransform(self, other)

    def __or__(self, other: "Transform") -> "Transform":
        return _EitherTransform(self, other)

    def _repeat(self, x):
        """The batch tiled ``n_trans`` times (base.py:172)."""
        return x.repeat((self.n_trans,) + (1,) * (x.dim() - 1))


class Identity(Transform):
    """The identity action (base.py:176)."""

    def get_params(self, x, generator=None):
        return {}

    def invert_params(self, params):
        return {}

    def transform(self, x, **params):
        return x


class _ChainTransform(Transform):
    """``t1 * t2``: ``t2`` then ``t1`` (base.py:187). ``t1``'s parameters
    are drawn for the batch ``t2`` expands; the draws come from the one
    generator, ``t2``'s first (the order of JAX's key split, ``k2`` for
    ``t2``)."""

    def __init__(self, t1: Transform, t2: Transform):
        super().__init__(n_trans=t1.n_trans * t2.n_trans)
        self.t1 = t1
        self.t2 = t2

    def get_params(self, x, generator=None):
        p2 = self.t2.get_params(x, generator)
        return {"p1": self.t1.get_params(self.t2._repeat(x), generator), "p2": p2}

    def invert_params(self, params):
        return {"p1": self.t1.invert_params(params["p1"]),
                "p2": self.t2.invert_params(params["p2"])}

    def transform(self, x, p1=None, p2=None):
        return self.t1.transform(self.t2.transform(x, **p2), **p1)

    def _tile_p2(self, p2):
        """``t2``'s parameters tiled over ``t1``'s copies (base.py:214)."""
        n1 = self.t1.n_trans
        return {k: v.repeat((n1,) + (1,) * (v.dim() - 1)) if isinstance(v, torch.Tensor)
                else self._tile_p2(v) if isinstance(v, dict) else v for k, v in p2.items()}

    def inverse(self, x, p1=None, p2=None):
        return self.t2.inverse(self.t1.inverse(x, **p1), **self._tile_p2(p2))


class _EitherTransform(Transform):
    """``t1 | t2``: one of the two, the choice drawn into the parameters so
    that :meth:`transform` and :meth:`inverse` agree (base.py:227); 1 picks
    ``t1``."""

    def __init__(self, t1: Transform, t2: Transform):
        super().__init__(n_trans=t1.n_trans)
        self.t1 = t1
        self.t2 = t2

    def get_params(self, x, generator=None):
        choice = int(torch.randint(0, 2, (), generator=generator,
                                   device=_device(x, generator)))
        return {"choice": choice, "p1": self.t1.get_params(x, generator),
                "p2": self.t2.get_params(x, generator)}

    def invert_params(self, params):
        return {"choice": params["choice"], "p1": self.t1.invert_params(params["p1"]),
                "p2": self.t2.invert_params(params["p2"])}

    def transform(self, x, choice=0, p1=None, p2=None):
        return self.t1.transform(x, **p1) if int(choice) else self.t2.transform(x, **p2)

    def inverse(self, x, choice=0, p1=None, p2=None):
        return self.t1.inverse(x, **p1) if int(choice) else self.t2.inverse(x, **p2)


class _StackTransform(Transform):
    """``t1 + t2``: both outputs concatenated along the batch (base.py:281)."""

    def __init__(self, t1: Transform, t2: Transform):
        super().__init__(n_trans=t1.n_trans + t2.n_trans)
        self.t1 = t1
        self.t2 = t2

    def get_params(self, x, generator=None):
        return {"p1": self.t1.get_params(x, generator), "p2": self.t2.get_params(x, generator)}

    def transform(self, x, p1=None, p2=None):
        return torch.cat([self.t1.transform(x, **p1), self.t2.transform(x, **p2)], 0)

    def invert_params(self, params):
        return {"p1": self.t1.invert_params(params["p1"]),
                "p2": self.t2.invert_params(params["p2"])}

    def inverse(self, x, p1=None, p2=None):
        n1 = self.t1.n_trans * (x.shape[0] // self.n_trans)
        return torch.cat([self.t1.inverse(x[:n1], **p1), self.t2.inverse(x[n1:], **p2)], 0)
