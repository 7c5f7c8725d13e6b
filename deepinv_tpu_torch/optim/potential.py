"""Potential base class (port of deepinv_tpu/optim/potential.py)."""

from __future__ import annotations

import torch
from torch import nn

from ..utils.profiling import traced

__all__ = ["Potential"]


def _reaches_other_leaf(out, u) -> bool:
    """Whether the graph of ``out`` reaches a tensor that requires grad other
    than ``u`` (a parameter, or a value made from one)."""
    seen, stack = set(), [out.grad_fn]
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        var = getattr(node, "variable", None)
        if var is not None and var is not u:
            return True
        stack.extend(f for f, _ in node.next_functions)
    return False


def autograd_grad(fn, x):
    """``grad_x sum(fn(x))``, the JAX package's ``jax.grad`` of a summed
    potential. With grad mode on, the gradient keeps its graph
    (``create_graph``) where ``x`` requires grad (``x`` is then not
    detached) or the potential reaches another tensor that does: a loss
    through the gradient then differentiates again, as ``jax.grad`` of
    ``jax.grad`` does, so an unfolded network trains through a prior's
    autodiff gradient. Otherwise the gradient carries no graph. A potential
    constant in ``x`` has a zero gradient, as in JAX."""
    grad_mode = torch.is_grad_enabled()
    keep = grad_mode and x.requires_grad
    with torch.enable_grad():
        u = x if keep else x.detach().requires_grad_()
        out = fn(u).sum()
        if not out.requires_grad:
            return torch.zeros_like(x)
        create = grad_mode and (keep or _reaches_other_leaf(out, u))
        (g,) = torch.autograd.grad(out, u, create_graph=create, allow_unused=True)
    return torch.zeros_like(x) if g is None else g


class Potential(nn.Module):
    """Anything with ``fn``/``grad``/``prox`` (deepinv_tpu/optim/potential.py:19).
    ``Potential(fn=callable)`` wraps a plain function. ``grad`` defaults to
    autograd of ``fn``; ``prox`` and ``bregman_prox`` to inner gradient
    descent; ``grad_conj`` to autograd of ``conjugate``.

    A subclass that names a layer in ``span_name`` (the data fidelity, the
    prior) has its ``prox`` and ``grad``, and those of every subclass below
    it, run in that layer's span (``op`` the method's name), the outermost
    call only (:func:`~deepinv_tpu_torch.utils.profiling.traced`)."""

    span_name = None

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        if cls.span_name is None:
            return
        for op in ("prox", "grad"):
            fn = cls.__dict__.get(op)
            if fn is None and "span_name" in cls.__dict__:
                fn = getattr(cls, op)   # the layer's root spans what it inherits
            if fn is not None and getattr(fn, "span_name", None) != cls.span_name:
                setattr(cls, op, traced(cls.span_name, op=op)(fn))

    def __init__(self, fn=None):
        super().__init__()
        self._custom_fn = fn

    def fn(self, x, *args, **kwargs):
        if self._custom_fn is not None:
            return self._custom_fn(x, *args, **kwargs)
        raise NotImplementedError

    def forward(self, x, *args, **kwargs):
        return self.fn(x, *args, **kwargs)

    def grad(self, x, *args, **kwargs):
        """Gradient of the potential by autograd (potential.py:36), with its
        graph kept in grad mode (:func:`autograd_grad`)."""
        return autograd_grad(lambda u: self.fn(u, *args, **kwargs), x)

    def prox(self, x, *args, gamma=1.0, stepsize_inter=1.0, max_iter_inter: int = 50, **kwargs):
        """``prox_{gamma f}(x)`` by inner gradient descent (potential.py:41)."""
        u = x
        for _ in range(max_iter_inter):
            u = u - stepsize_inter * (gamma * self.grad(u, *args, **kwargs) + (u - x))
        return u

    def conjugate(self, x, *args, **kwargs):
        """The convex conjugate ``f^*`` (potential.py:55); none by default."""
        raise NotImplementedError

    def grad_conj(self, x, *args, **kwargs):
        """Gradient of the convex conjugate (potential.py:58): autograd of
        :meth:`conjugate`; for a convex differentiable potential the inverse
        of :meth:`grad`."""
        return autograd_grad(lambda u: self.conjugate(u, *args, **kwargs), x)

    def prox_conjugate(self, x, *args, gamma=1.0, lamb=1.0, **kwargs):
        r"""``prox_{gamma (lamb f)^*}(x) = x - gamma prox_{lamb f / gamma}(x / gamma)``,
        the Moreau identity (potential.py:66)."""
        return x - gamma * self.prox(x / gamma, *args, gamma=lamb / gamma, **kwargs)

    def bregman_prox(self, x, bregman_potential, *args, gamma=1.0, **kwargs):
        """Bregman proximal operator (potential.py:71): 50 steps of gradient
        descent at step 1 on ``gamma f(u) + h(u) - <u, grad h(x)>``, ``h`` the
        Bregman potential."""
        xi = bregman_potential.grad(x)

        def obj(v):
            return (gamma * self.fn(v, *args, **kwargs) + bregman_potential.fn(v)
                    - (v * xi).reshape(v.shape[0], -1).sum(1))

        u = x
        for _ in range(50):
            u = u - autograd_grad(obj, u)
        return u
