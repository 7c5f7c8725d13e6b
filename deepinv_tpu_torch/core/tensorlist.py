"""TensorList: a list of tensors with elementwise arithmetic (port of
deepinv_tpu/core/tensorlist.py:27), and :func:`zeros_like`,
:func:`ones_like`, :func:`randn_like`, :func:`rand_like` over a tensor or a
TensorList (tensorlist.py:222-256; the draws take a ``torch.Generator`` in
place of the JAX key).

Stacked physics (:func:`~deepinv_tpu_torch.physics.stack`) measure
``y = [A_1 x, ..., A_k x]`` with members of any shape; the Krylov solvers
(:mod:`~deepinv_tpu_torch.optim.linear`) treat a TensorList as one vector
whose members are its blocks (:mod:`~deepinv_tpu_torch.core.linalg`).
"""

from __future__ import annotations

import operator

import torch

__all__ = ["TensorList", "zeros_like", "ones_like", "randn_like", "rand_like"]


class TensorList:
    """A list of tensors supporting elementwise arithmetic
    (tensorlist.py:27): ``TensorList([a, b]) + TensorList([c, d]) ==
    TensorList([a + c, b + d])``; a number or a tensor broadcasts over the
    members."""

    __slots__ = ("x",)

    def __init__(self, x):
        if isinstance(x, TensorList):
            x = list(x.x)
        elif isinstance(x, torch.Tensor):
            x = [x]
        else:
            x = list(x)
        self.x = x

    def __len__(self):
        return len(self.x)

    def __iter__(self):
        return iter(self.x)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return TensorList(self.x[i])
        return self.x[i]

    def append(self, other):
        """A new TensorList with ``other`` (a tensor, or a TensorList's
        members) after these (tensorlist.py:71)."""
        new = list(self.x)
        if isinstance(other, TensorList):
            new.extend(other.x)
        else:
            new.append(other)
        return TensorList(new)

    @property
    def shape(self):
        return [v.shape for v in self.x]

    @property
    def dtype(self):
        return [v.dtype for v in self.x]

    def flatten(self):
        """All members, each flattened, in one 1D tensor (tensorlist.py:87)."""
        return torch.cat([v.reshape(-1) for v in self.x])

    def _binary(self, other, op):
        if isinstance(other, TensorList):
            if len(other) != len(self):
                raise ValueError("TensorList length mismatch")
            return TensorList([op(a, b) for a, b in zip(self.x, other.x)])
        return TensorList([op(a, other) for a in self.x])

    def _rbinary(self, other, op):
        return TensorList([op(other, a) for a in self.x])

    def __add__(self, o):
        return self._binary(o, operator.add)

    def __radd__(self, o):
        return self._rbinary(o, operator.add)

    def __sub__(self, o):
        return self._binary(o, operator.sub)

    def __rsub__(self, o):
        return self._rbinary(o, operator.sub)

    def __mul__(self, o):
        return self._binary(o, operator.mul)

    def __rmul__(self, o):
        return self._rbinary(o, operator.mul)

    def __truediv__(self, o):
        return self._binary(o, operator.truediv)

    def __rtruediv__(self, o):
        return self._rbinary(o, operator.truediv)

    def __pow__(self, o):
        return self._binary(o, operator.pow)

    def __neg__(self):
        return TensorList([-a for a in self.x])

    def __abs__(self):
        return TensorList([a.abs() for a in self.x])

    def __gt__(self, o):
        return self._binary(o, operator.gt)

    def __lt__(self, o):
        return self._binary(o, operator.lt)

    def abs(self):
        """Member-wise absolute value (tensorlist.py:143)."""
        return abs(self)

    def max(self):
        """A TensorList of each member's maximum (tensorlist.py:147)."""
        return TensorList([a.max() for a in self.x])

    def numpy(self):
        """The members as numpy arrays (tensorlist.py:160)."""
        return [a.detach().cpu().numpy() for a in self.x]

    def isnan(self):
        """Member-wise NaN masks (tensorlist.py:166)."""
        return TensorList([torch.isnan(a) for a in self.x])

    def numel(self):
        """Elements over all members (tensorlist.py:170)."""
        return sum(a.numel() for a in self.x)

    def any(self):
        """True if any member has a true element (tensorlist.py:174)."""
        return any(bool(a.any()) for a in self.x)

    def all(self):
        """True if every element of every member is true (tensorlist.py:178)."""
        return all(bool(a.all()) for a in self.x)

    def squeeze(self, axis=None):
        """Member-wise squeeze (tensorlist.py:189)."""
        return TensorList([a.squeeze() if axis is None else a.squeeze(axis) for a in self.x])

    def unsqueeze(self, axis):
        """Member-wise ``unsqueeze`` (tensorlist.py:196)."""
        return TensorList([a.unsqueeze(axis) for a in self.x])

    def reshape(self, shapes):
        return TensorList([a.reshape(s) for a, s in zip(self.x, shapes)])

    def astype(self, dtype):
        return TensorList([a.to(dtype) for a in self.x])

    def conj(self):
        return TensorList([a.conj() for a in self.x])

    def sum(self):
        """Sum of every element of every member, a 0-d tensor (tensorlist.py:138)."""
        return sum(a.sum() for a in self.x)

    def clone(self):
        """A copy of every member (tensorlist.py:151)."""
        return TensorList([a.clone() for a in self.x])

    def detach(self):
        """The members detached from the autograd graph (tensorlist.py:156)."""
        return TensorList([a.detach() for a in self.x])

    def to(self, *args, **kwargs):
        """Every member through ``Tensor.to`` (a device, a dtype)."""
        return TensorList([a.to(*args, **kwargs) for a in self.x])

    def __repr__(self):
        return f"TensorList({[tuple(v.shape) for v in self.x]})"


def _map(fn, y):
    return TensorList([fn(v) for v in y.x]) if isinstance(y, TensorList) else fn(y)


def zeros_like(y):
    """Zeros shaped like a tensor or a TensorList (tensorlist.py:222)."""
    return _map(torch.zeros_like, y)


def ones_like(y):
    """Ones shaped like a tensor or a TensorList (tensorlist.py:226)."""
    return _map(torch.ones_like, y)


def randn_like(generator, y):
    """Standard normal draws shaped like a tensor or a TensorList, from
    ``generator`` (tensorlist.py:230): a complex member draws its real and
    imaginary parts each of variance 1/2."""
    def draw(v):
        if v.is_complex():
            real = torch.randn((2,) + tuple(v.shape), generator=generator, device=v.device,
                               dtype=v.real.dtype) / 2 ** 0.5
            return torch.complex(real[0], real[1]).to(v.dtype)
        return torch.randn(v.shape, generator=generator, device=v.device, dtype=v.dtype)
    return _map(draw, y)


def rand_like(generator, y):
    """Uniform [0, 1) draws shaped like a tensor or a TensorList (real
    dtypes), from ``generator`` (tensorlist.py:251)."""
    return _map(lambda v: torch.rand(v.shape, generator=generator, device=v.device,
                                      dtype=v.dtype), y)
