"""Deep equilibrium with implicit differentiation (port of
deepinv_tpu/unfolded/deq.py).

The JAX package's ``jax.custom_vjp`` (deq.py:37-90) is a
``torch.autograd.Function`` here:

- forward: ``x_{k+1} = T(x_k)`` without a graph until the relative change
  ``||x_{k+1} - x_k|| / ||x_{k+1}||`` (over the whole batch) is at most
  ``tol`` or ``max_iter`` maps are made, the stop decided on the device and
  read on the host every ``check_every`` iterations
  (:func:`~deepinv_tpu_torch.core.device_while`). The output is the last
  iterate, as in JAX (no extra step);
- backward: one graph step ``T(x*)`` at the equilibrium, then the adjoint
  fixed point ``w = g + J_x^T w`` from ``w = g + J_x^T g``, one
  vector-Jacobian product of that step an iteration, until ``||w - w_prev||``
  is at most ``backward_tol`` or ``backward_iter`` products are made; the
  parameters' cotangents are ``J_theta^T w``. ``x0`` takes no gradient.

The parameters are the Function's inputs, as in the Krylov implicit backward
(``optim/linear.py`` ``_LeastSquaresProx``).
"""

from __future__ import annotations

import torch

from ..core import CHECK_EVERY, device_while
from ..core.linalg import tree_norm, tree_sub
from ..utils.profiling import counters

__all__ = ["deq_fixed_point"]


class _Spec:
    def __init__(self, T, params, max_iter, tol, backward_iter, backward_tol, check_every,
                 stats):
        self.T, self.params = T, params
        self.max_iter, self.tol = max_iter, tol
        self.backward_iter, self.backward_tol = backward_iter, backward_tol
        self.check_every, self.stats = check_every, stats


def _forward(spec, x0):
    """The equilibrium of ``x = T(params, x)`` from ``x0`` (deq.py:37-53)."""
    T, params = spec.T, spec.params

    def cond(s):
        return tree_norm(tree_sub(s[0], s[1])) / tree_norm(s[0]).clamp_min(1e-12) > spec.tol

    bodies = counters["loop.bodies"]
    x1 = T(params, x0)
    (x, _), n = device_while(cond, lambda s: (T(params, s[0]), s[0]), (x1, x0),
                             spec.max_iter - 1, spec.check_every)
    spec.stats["forward_iterations"] = n + 1
    spec.stats["forward_maps"] = 1 + counters["loop.bodies"] - bodies
    return x


class _DEQ(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spec, x0, *params):
        x_star = _forward(spec, x0)
        ctx.spec = spec
        ctx.save_for_backward(x_star)
        return x_star

    @staticmethod
    def backward(ctx, g):
        spec = ctx.spec
        (x_star,) = ctx.saved_tensors
        g = g.detach()
        with torch.enable_grad():
            x = x_star.detach().requires_grad_()
            Tx = spec.T(spec.params, x)

        def vjp(w):
            return torch.autograd.grad(Tx, x, w, retain_graph=True)[0]

        def cond(s):
            return tree_norm(tree_sub(s[0], s[1])) > spec.backward_tol

        bodies = counters["loop.bodies"]
        w1 = g + vjp(g)
        (w, _), n = device_while(cond, lambda s: (g + vjp(s[0]), s[0]), (w1, g),
                                 spec.backward_iter - 1, spec.check_every)
        want = [i for i, p in enumerate(spec.params) if p.requires_grad]
        spec.stats["backward_iterations"] = n + 1
        spec.stats["backward_products"] = 1 + counters["loop.bodies"] - bodies + bool(want)
        grads = [None] * len(spec.params)
        if want:
            got = torch.autograd.grad(Tx, [spec.params[i] for i in want], w, allow_unused=True)
            for i, d in zip(want, got):
                grads[i] = d
        return (None, None, *grads)


def deq_fixed_point(T, params, x0, max_iter: int = 50, tol: float = 1e-4,
                    backward_iter: int = 30, backward_tol: float = 1e-6,
                    check_every: int = CHECK_EVERY, stats: dict = None):
    """The differentiable equilibrium of ``x = T(params, x)``
    (deepinv_tpu/unfolded/deq.py:25).

    :param T: the map ``T(params, x) -> x``.
    :param params: the tensors ``T`` depends on that take a gradient (a
        sequence; ``T`` gets it back as its first argument). A tensor ``T``
        reaches some other way (a module's weight) gets its gradient only if
        it is listed here.
    :param x0: the first iterate.
    :param check_every: iterations between two host reads of a loop's stop.
    :param stats: a dict that receives ``forward_iterations`` (the maps the
        reference's loop makes, a 0-d device tensor) and ``forward_maps`` (the
        maps evaluated, with the frozen ones past the stop that
        ``check_every`` lets run) and, after a backward,
        ``backward_iterations`` (the adjoint's vector-Jacobian products, a 0-d
        device tensor) and ``backward_products`` (those evaluated, frozen ones
        and the parameters' cotangents included).
    """
    params = list(params)
    spec = _Spec(T, params, max_iter, tol, backward_iter, backward_tol, check_every,
                 stats if stats is not None else {})
    return _DEQ.apply(spec, x0, *params)
