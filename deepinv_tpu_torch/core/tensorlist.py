"""TensorList: a list of tensors with elementwise arithmetic (port of
deepinv_tpu/core/tensorlist.py:27).

Stacked physics (:func:`~deepinv_tpu_torch.physics.stack`) measure
``y = [A_1 x, ..., A_k x]`` with members of any shape; the Krylov solvers
(:mod:`~deepinv_tpu_torch.optim.linear`) treat a TensorList as one vector
whose members are its blocks (:mod:`~deepinv_tpu_torch.core.linalg`).
"""

from __future__ import annotations

import operator

import torch

__all__ = ["TensorList"]


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
        return self.x[i]

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

    def __neg__(self):
        return TensorList([-a for a in self.x])

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
