"""Vector-space operations on tensors and TensorLists, the power method, and
the loop whose stop the device decides (port of deepinv_tpu/core/linalg.py).

The JAX package defines its tree ops on any pytree (linalg.py:30-69); the
port's vectors are a tensor or a :class:`~deepinv_tpu_torch.core.TensorList`
(stacked measurements), whose members are the blocks of one vector.

The JAX package runs every iterative solver as one ``lax.while_loop``
(linalg.py:98-112, optim/linear.py:108-127): the stop is a value on the
device and no iteration waits for the host. :func:`device_while` keeps that
in an eager loop: the stop is a sticky flag on the device, every update is
taken through ``torch.where(done, old, new)`` so the state freezes exactly
where the reference's loop ends, and the host reads the flag only every
``check_every`` iterations. Past the stop the loop runs frozen iterations
whose results are discarded, so the result is the same bits for every
``check_every``.
"""

from __future__ import annotations

import contextlib

import torch

from ..utils.profiling import counters
from .tensorlist import TensorList

__all__ = ["tree_map", "tree_add", "tree_sub", "tree_scale", "tree_axpy", "tree_vdot",
           "tree_real_vdot", "tree_norm", "tree_zeros_like", "tree_conj", "tree_where",
           "power_method", "device_while", "LoopStats", "loop_stats", "CHECK_EVERY",
           "linear_transpose", "exact_f32"]

# iterations between two host reads of a loop's stop flag. The CT prox of the
# ADMM bench problem stops after 2-3 CG iterations (PERF.md, "ADMM on CT"): a
# read every 2 wastes at most one frozen iteration there.
CHECK_EVERY = 2


def leaves(a) -> list:
    """The tensors of a tensor or a TensorList."""
    return list(a.x) if isinstance(a, TensorList) else [a]


def tree_map(fn, a, *rest):
    """``fn`` member by member over tensors or TensorLists of one structure."""
    if isinstance(a, TensorList):
        return TensorList([fn(*vs) for vs in zip(a.x, *(r.x for r in rest))])
    return fn(a, *rest)


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_sub(a, b):
    return tree_map(torch.sub, a, b)


def tree_scale(alpha, a):
    return tree_map(lambda x: alpha * x, a)


def tree_axpy(alpha, x, y):
    """``y + alpha * x`` member by member (``alpha`` a scalar)."""
    return tree_map(lambda xi, yi: yi + alpha * xi, x, y)


def tree_vdot(a, b):
    """``sum_i <a_i, b_i>``, conjugating ``a`` (``jnp.vdot``; linalg.py:47)."""
    return sum(torch.vdot(x.reshape(-1), y.reshape(-1)) for x, y in zip(leaves(a), leaves(b)))


def tree_real_vdot(a, b):
    """The real part of :func:`tree_vdot`, the Hilbert-space pairing (linalg.py:54)."""
    v = tree_vdot(a, b)
    return v.real if v.is_complex() else v


def tree_norm(a):
    return torch.sqrt(tree_real_vdot(a, a))


def tree_zeros_like(a):
    return tree_map(torch.zeros_like, a)


def tree_conj(a):
    return tree_map(torch.conj, a)


def tree_where(done, old, new):
    """``old`` where the 0-d bool ``done`` holds, else ``new``, over tensors,
    TensorLists and tuples of them."""
    if isinstance(old, tuple):
        return tuple(tree_where(done, o, n) for o, n in zip(old, new))
    return tree_map(lambda o, n: torch.where(done, o, n), old, new)


class LoopStats:
    """The iterations that moved the state in the loops of
    :func:`device_while` since :meth:`reset`, summed on the device and read
    only when asked (:attr:`iterations`). The loops' host-side counts are in
    ``profiling.counters``: ``loop.loops`` (loops run), ``loop.host_reads``
    (reads of their stop flag) and ``loop.bodies`` (bodies evaluated, frozen
    ones included)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._iterations = None

    def _record(self, count):
        self._iterations = count if self._iterations is None else (
            self._iterations + count.to(self._iterations.device))

    @property
    def iterations(self) -> int:
        """Iterations that moved the state, summed over the loops (reads the
        device)."""
        return 0 if self._iterations is None else int(self._iterations)


# the moved iterations of every device_while loop in the process
loop_stats = LoopStats()


def device_while(cond, body, state, max_iter: int, check_every: int = CHECK_EVERY):
    """``while it < max_iter and cond(state): state = body(state)``, the
    JAX package's ``lax.while_loop`` (e.g. optim/linear.py:127), with the stop
    decided on the device.

    ``cond(state)`` is a 0-d bool tensor. The loop carries ``done``, sticky,
    and takes each new state through :func:`tree_where`; the host reads
    ``done`` before the iterations ``check_every``, ``2 check_every``, ...
    and leaves the loop once it holds. ``state`` is a tensor, a TensorList
    or a tuple of them. Returns ``(state, iterations)``, the latter a 0-d
    int32 device tensor: the iterations the reference's loop runs."""
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    done = ~cond(state)
    count = torch.zeros((), dtype=torch.int32, device=done.device)
    counters["loop.loops"] += 1
    for i in range(max_iter):
        if i and i % check_every == 0:
            counters["loop.host_reads"] += 1
            if bool(done):
                break
        new = body(state)
        counters["loop.bodies"] += 1
        count = count + ~done
        state = tree_where(done, state, new)
        done = done | ~cond(state)
    loop_stats._record(count)
    return state, count


@contextlib.contextmanager
def exact_f32(device_type: str):
    """f32 products without TF32 and outside any autocast region: the
    closed forms that rely on an exact orthogonal transform (a Hadamard
    ``V(V_adjoint(x)) = x``), the dense sensing matrices and Anderson's small
    solve run in it whatever precision the caller set."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.autocast(device_type, enabled=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def linear_transpose(fwd, y, x_shape, create_graph: bool = False, dtype=None):
    """The transpose of the linear map ``fwd`` applied to ``y``: the autograd
    vector-Jacobian product of ``fwd`` at a zero primal of ``x_shape`` (and
    ``y``'s dtype), the JAX package's ``jax.linear_transpose`` of a forward
    map. ``y`` may be a tuple when ``fwd`` returns one. The graph is kept when
    ``y`` or ``create_graph`` asks for it, so a gradient reaches the
    cotangent and the forward's parameters (the implicit Krylov backward
    differentiates through an adjoint). ``dtype`` sets the primal's where it
    differs from ``y``'s (a real image under a complex measurement).

    The JAX package's ``transpose_primal`` (linalg.py:116), the primal's shape
    and dtype for ``jax.linear_transpose`` under ``shard_map``, has no
    counterpart: the port has no varying-manual-axes types, and the zero
    primal here is a plain tensor."""
    ys = y if isinstance(y, tuple) else (y,)
    create_graph = create_graph or any(v.requires_grad for v in ys)
    with torch.enable_grad():
        x = ys[0].new_zeros(x_shape, dtype=dtype).requires_grad_()
        out = fwd(x)
        outs = out if isinstance(out, tuple) else (out,)
        (xt,) = torch.autograd.grad(outs, x, ys, create_graph=create_graph)
    return xt


def power_method(op, x0, max_iter: int = 100, tol: float = 1e-6,
                 check_every: int = CHECK_EVERY):
    """Largest eigenvalue of a PSD operator ``op`` by power iteration
    (linalg.py:71): stops when the estimate changes by less than ``tol``
    relative, or after ``max_iter`` iterations. A zero seed falls back to
    ones. Returns a 0-d tensor."""
    n_seed = tree_norm(x0)
    x0 = tree_map(lambda v: torch.where(n_seed > 0, v, torch.ones_like(v)), x0)
    x0 = op(x0)
    n0 = tree_norm(x0).clamp_min(1e-30)
    x0 = tree_map(lambda v: v / n0, x0)
    dev = leaves(x0)[0].device
    lam0 = torch.zeros((), device=dev)
    inf = torch.full((), float("inf"), device=dev)

    def cond(s):
        _, lam, lam_prev = s
        return (lam - lam_prev).abs() / lam.abs().clamp_min(1e-30) > tol

    def body(s):
        x, lam, _ = s
        y = op(x)
        lam_new = tree_real_vdot(x, y).to(lam.dtype)
        ny = tree_norm(y).clamp_min(1e-30)
        return tree_map(lambda v: v / ny, y), lam_new, lam

    (_, lam, _), _ = device_while(cond, body, (x0, lam0, inf), max_iter, check_every)
    return lam
