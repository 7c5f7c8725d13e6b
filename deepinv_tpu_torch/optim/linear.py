"""Krylov least-squares solvers with the implicit backward (port of
deepinv_tpu/optim/linear.py).

The solvers act on a tensor or a :class:`~deepinv_tpu_torch.core.TensorList`
(stacked measurements) and are batched over dimension 0: each batch element
has its own step sizes (linear.py:9-12). Inner products are the real part of
``conj(a) b`` (linear.py:41), so complex k-space works. Each loop is a
:func:`~deepinv_tpu_torch.core.device_while`: the stop is decided on the
device as the JAX package's ``lax.while_loop`` decides it, the host reads it
every ``check_every`` iterations, and the result is the same bits for every
``check_every``.

:func:`least_squares` with a physics and a ``gamma`` takes the implicit
backward of the JAX package's ``custom_vjp`` (linear.py:363-418) as a
``torch.autograd.Function``: the forward solve keeps no graph, and the
backward is one CG solve of the adjoint system and one vector-Jacobian
product of the normal operator, so memory stays O(1) in the iteration count.
Gradients reach ``y``, ``z``, ``gamma`` and the physics' floating-point
tensors that require grad (its filters and masks are buffers).
"""

from __future__ import annotations

import torch

from ..core.linalg import (CHECK_EVERY, device_while, leaves, tree_add, tree_map, tree_sub,
                           tree_zeros_like)
from ..core.tensorlist import TensorList

__all__ = ["conjugate_gradient", "bicgstab", "minres", "lsqr", "least_squares"]


# -- batched inner products (batch = dimension 0 of every member) -------------


def _bdot(a, b):
    """Per-batch-element real inner product ``Re <a, b>``, shape (B,)
    (linear.py:41)."""
    tot = None
    for x, y in zip(leaves(a), leaves(b)):
        s = torch.linalg.vecdot(x.reshape(x.shape[0], -1), y.reshape(y.shape[0], -1))
        s = s.real if s.is_complex() else s
        tot = s if tot is None else tot + s
    return tot


def _bcast(alpha, leaf):
    return alpha.reshape(alpha.shape + (1,) * (leaf.dim() - 1))


def _bscale(alpha, x):
    """``alpha * x`` with a per-batch ``alpha`` (B,) (linear.py:53)."""
    return tree_map(lambda v: _bcast(alpha, v).to(v.real.dtype) * v, x)


def _baxpy(alpha, x, y):
    """``y + alpha * x`` with a per-batch ``alpha`` (B,) (linear.py:62)."""
    return tree_map(lambda xi, yi: torch.addcmul(yi, _bcast(alpha, xi).to(xi.dtype), xi), x, y)


def _safe_div(num, den, eps: float = 1e-30):
    """``num / den`` with ``|den| <= eps`` replaced by ``+-eps`` (linear.py:71)."""
    return num / torch.where(den.abs() > eps, den, torch.where(den >= 0, eps, -eps))


def _bselect(mask, a, b):
    """``a`` where the per-batch ``mask`` (B,) holds, else ``b`` (linear.py:75)."""
    return tree_map(lambda ai, bi: torch.where(_bcast(mask, ai), ai, bi), a, b)


def _gmul(gamma, leaf):
    """``gamma * leaf`` with a scalar or per-sample gamma (linear.py:342)."""
    if isinstance(gamma, torch.Tensor) and 0 < gamma.dim() < leaf.dim():
        gamma = gamma.reshape(gamma.shape + (1,) * (leaf.dim() - gamma.dim()))
    return gamma * leaf


# -- the solvers ----------------------------------------------------------------


def conjugate_gradient(H, b, init=None, max_iter: int = 100, tol: float = 1e-5,
                       check_every: int = CHECK_EVERY):
    """Batched CG for a symmetric positive definite ``H`` (linear.py:89):
    stops when every batch element's recurrence residual is below ``tol``
    relative to ``b``, or after ``max_iter`` iterations.

    Returns the **best iterate** by recurrence residual, per batch element,
    not the last (linear.py:95-100): on a singular consistent system CG
    converges and then drifts in the null space once rounding builds up."""
    x0 = tree_zeros_like(b) if init is None else init
    r0 = tree_sub(b, H(x0))
    rs0 = _bdot(r0, r0)
    b_norm = _bdot(b, b).clamp_min(1e-30)
    tol2 = tol ** 2

    def cond(s):
        return (s[3] / b_norm).max() > tol2

    def body(s):
        x, r, p, rs, x_best, rs_best = s
        Hp = H(p)
        alpha = _safe_div(rs, _bdot(p, Hp))
        x = _baxpy(alpha, p, x)
        r = _baxpy(-alpha, Hp, r)
        rs_new = _bdot(r, r)
        beta = _safe_div(rs_new, rs)
        p = _baxpy(beta, p, r)
        better = rs_new < rs_best
        return (x, r, p, rs_new, _bselect(better, x, x_best),
                torch.where(better, rs_new, rs_best))

    s, _ = device_while(cond, body, (x0, r0, r0, rs0, x0, rs0), max_iter, check_every)
    return s[4]


def bicgstab(H, b, init=None, max_iter: int = 100, tol: float = 1e-5,
             check_every: int = CHECK_EVERY):
    """Batched BiCGStab for a general square ``H`` (linear.py:136), with the
    best iterate kept as in :func:`conjugate_gradient`. The residual norm the
    stop reads is carried in the state (the reference computes the same
    value in its loop condition)."""
    x0 = tree_zeros_like(b) if init is None else init
    r0 = tree_sub(b, H(x0))
    rhat = r0
    b_norm = _bdot(b, b).clamp_min(1e-30)
    rs0 = _bdot(r0, r0)
    ones = torch.ones_like(rs0)
    tol2 = tol ** 2

    def cond(s):
        return (s[7] / b_norm).max() > tol2

    def body(s):
        x, r, p, v, rho, alpha, omega, _, x_best, rs_best = s
        rho_new = _bdot(rhat, r)
        beta = _safe_div(rho_new * alpha, rho * omega)
        p = _baxpy(beta, _baxpy(-omega, v, p), r)   # p = r + beta (p - omega v)
        v = H(p)
        alpha = _safe_div(rho_new, _bdot(rhat, v))
        h = _baxpy(alpha, p, x)
        s_ = _baxpy(-alpha, v, r)
        t = H(s_)
        omega = _safe_div(_bdot(t, s_), _bdot(t, t))
        x = _baxpy(omega, s_, h)
        r = _baxpy(-omega, t, s_)
        rs_new = _bdot(r, r)
        better = rs_new < rs_best
        return (x, r, p, v, rho_new, alpha, omega, rs_new, _bselect(better, x, x_best),
                torch.where(better, rs_new, rs_best))

    zero = tree_zeros_like(b)
    s, _ = device_while(cond, body, (x0, r0, zero, zero, ones, ones, ones, rs0, x0, rs0),
                        max_iter, check_every)
    return s[8]


def minres(H, b, init=None, max_iter: int = 100, tol: float = 1e-5,
           check_every: int = CHECK_EVERY):
    """Batched MINRES for a symmetric (possibly indefinite) ``H`` by Lanczos
    and Givens rotations (linear.py:183)."""
    x0 = tree_zeros_like(b) if init is None else init
    r0 = tree_sub(b, H(x0))
    beta0 = torch.sqrt(_bdot(r0, r0).clamp_min(1e-30))
    b_norm = torch.sqrt(_bdot(b, b).clamp_min(1e-30))
    v = _bscale(_safe_div(torch.ones_like(beta0), beta0), r0)
    zero = tree_zeros_like(b)

    def cond(s):
        return (s[-1] / b_norm).max() > tol

    def body(s):
        x, v_old, v_cur, w_old, w_older, eta, s_old, s_cur, c_old, c_cur, beta, _ = s
        Hv = H(v_cur)
        alpha = _bdot(v_cur, Hv)
        v_new = _baxpy(-alpha, v_cur, _baxpy(-beta, v_old, Hv))
        beta_new = torch.sqrt(_bdot(v_new, v_new).clamp_min(1e-30))
        v_new = _bscale(_safe_div(torch.ones_like(beta_new), beta_new), v_new)
        delta = c_cur * alpha - c_old * s_cur * beta
        rho1 = torch.sqrt(delta ** 2 + beta_new ** 2)
        rho2 = s_cur * alpha + c_old * c_cur * beta
        rho3 = s_old * beta
        c_new = _safe_div(delta, rho1)
        s_new = _safe_div(beta_new, rho1)
        w_new = _bscale(_safe_div(torch.ones_like(rho1), rho1),
                        _baxpy(-rho2, w_old, _baxpy(-rho3, w_older, v_cur)))
        x = _baxpy(c_new * eta, w_new, x)
        eta_new = -s_new * eta
        return (x, v_cur, v_new, w_new, w_old, eta_new, s_cur, s_new, c_cur, c_new, beta_new,
                eta_new.abs())

    ones, zeros = torch.ones_like(beta0), torch.zeros_like(beta0)
    s, _ = device_while(cond, body, (x0, zero, v, zero, zero, beta0, zeros, zeros, ones, ones,
                                     zeros, beta0), max_iter, check_every)
    return s[0]


def lsqr(A, A_adjoint, y, init=None, gamma=None, max_iter: int = 100, tol: float = 1e-5,
         check_every: int = CHECK_EVERY):
    """Damped least squares ``min ||Ax - y||^2 + ||x||^2 / gamma`` by
    Golub-Kahan bidiagonalization (linear.py:235; no damping when ``gamma``
    is None), batched over dimension 0, from ``init``."""
    x0 = tree_zeros_like(A_adjoint(y)) if init is None else init
    r0 = tree_sub(y, A(x0))
    beta0 = torch.sqrt(_bdot(r0, r0).clamp_min(1e-30))
    u = _bscale(_safe_div(torch.ones_like(beta0), beta0), r0)
    v0 = A_adjoint(u)
    alpha0 = torch.sqrt(_bdot(v0, v0).clamp_min(1e-30))
    v = _bscale(_safe_div(torch.ones_like(alpha0), alpha0), v0)
    if gamma is None:
        damp = torch.zeros_like(beta0)
    else:
        g = torch.as_tensor(gamma, dtype=beta0.dtype, device=beta0.device)
        damp = _safe_div(torch.ones_like(beta0), torch.sqrt(g.expand(beta0.shape)))

    def cond(s):
        return (s[6].abs() / beta0).max() > tol

    def body(s):
        dx, u, v, w, alpha, beta, phibar, rhobar = s
        u_new = _baxpy(-alpha, u, A(v))
        beta_new = torch.sqrt(_bdot(u_new, u_new).clamp_min(1e-30))
        u_new = _bscale(_safe_div(torch.ones_like(beta_new), beta_new), u_new)
        v_new = _baxpy(-beta_new, v, A_adjoint(u_new))
        alpha_new = torch.sqrt(_bdot(v_new, v_new).clamp_min(1e-30))
        v_new = _bscale(_safe_div(torch.ones_like(alpha_new), alpha_new), v_new)
        rhobar1 = torch.sqrt(rhobar ** 2 + damp ** 2)      # eliminate the damping
        phibar1 = _safe_div(rhobar, rhobar1) * phibar
        rho = torch.sqrt(rhobar1 ** 2 + beta_new ** 2)     # Givens
        c = _safe_div(rhobar1, rho)
        s_ = _safe_div(beta_new, rho)
        theta = s_ * alpha_new
        dx = _baxpy(_safe_div(c * phibar1, rho), w, dx)
        w_new = _baxpy(-_safe_div(theta, rho), w, v_new)
        return dx, u_new, v_new, w_new, alpha_new, beta_new, s_ * phibar1, -c * alpha_new

    s, _ = device_while(cond, body, (tree_zeros_like(x0), u, v, v, alpha0, beta0, beta0, alpha0),
                        max_iter, check_every)
    return tree_add(x0, s[0])


# -- least squares, with the implicit backward ---------------------------------


_SOLVERS = {"cg": conjugate_gradient, "bicgstab": bicgstab, "minres": minres}


def _solve_normal(A, A_adjoint, y, gamma, z, init, solver, max_iter, tol, ATA=None, AAT=None,
                  check_every: int = CHECK_EVERY):
    """The forward solve (linear.py:298): with ``gamma`` the system
    ``(gamma A^T A + I) x = gamma A^T y + z`` (LSQR on the shifted variable
    ``x - z``), without it the pseudo-inverse through the smaller normal
    system."""
    if ATA is None:
        ATA = lambda v: A_adjoint(A(v))   # noqa: E731
    if AAT is None:
        AAT = lambda u: A(A_adjoint(u))   # noqa: E731
    solver = solver.lower()
    kw = dict(max_iter=max_iter, tol=tol, check_every=check_every)
    fn = _SOLVERS.get(solver, conjugate_gradient)
    if gamma is not None:
        if solver == "lsqr":
            dx = lsqr(A, A_adjoint, tree_sub(y, A(z)), gamma=gamma, **kw)
            return tree_add(z, dx)

        def H(v):
            return tree_map(lambda a, c: _gmul(gamma, a) + c, ATA(v), v)

        b = tree_map(lambda a, c: _gmul(gamma, a) + c, A_adjoint(y), z)
        return fn(H, b, init=init, **kw)
    if solver == "lsqr":
        return lsqr(A, A_adjoint, y, init=init, **kw)
    Aty = A_adjoint(y)
    if sum(v.numel() for v in leaves(Aty)) <= sum(v.numel() for v in leaves(y)):
        return fn(ATA, Aty, init=init, **kw)          # overdetermined: A^T A x = A^T y
    return A_adjoint(fn(AAT, y, **kw))                # underdetermined: A^T (A A^T)^-1 y


def _physics_solve(physics, y, z, gamma, solver, max_iter, tol, check_every):
    """The prox's forward solve from ``z`` with the physics' own normal
    operator (linear.py:364-370; Tomography's is the Toeplitz one)."""
    return _solve_normal(physics.A, physics.A_adjoint, y, gamma, z, z, solver, max_iter, tol,
                         ATA=physics.A_adjoint_A, AAT=getattr(physics, "A_A_adjoint", None),
                         check_every=check_every)


def _grad_tensors(physics):
    """The physics' floating-point parameters and buffers that require grad."""
    seen, out = set(), []
    for t in list(physics.parameters()) + list(physics.buffers()):
        if t.is_floating_point() and t.requires_grad and id(t) not in seen:
            seen.add(id(t))
            out.append(t)
    return out


def _rebuild(flat, n, as_list):
    return TensorList(list(flat[:n])) if as_list else flat[0]


class _LeastSquaresProx(torch.autograd.Function):
    """``argmin_x gamma/2 ||Ax - y||^2 + 1/2 ||x - z||^2`` with the implicit
    backward of linear.py:373-418. Inputs: a spec (the physics, the solver's
    settings, the layout of the tensors), then y's and z's tensors, gamma if
    a tensor, and the physics' tensors that require grad."""

    @staticmethod
    def forward(ctx, spec, *tensors):
        y, z, gamma, _ = spec.unpack(tensors)
        x = _physics_solve(spec.physics, y, z, gamma, spec.solver, spec.max_iter, spec.tol,
                           spec.check_every)
        ctx.spec = spec
        ctx.save_for_backward(*tensors, *leaves(x))
        return tuple(leaves(x))

    @staticmethod
    def backward(ctx, *grads):
        spec, saved = ctx.spec, ctx.saved_tensors
        physics = spec.physics
        y, _, gam, thetas = spec.unpack(saved)
        # x is this function's output: detached, the vjp below does not
        # reenter this backward
        x = tree_map(torch.detach, _rebuild(saved[spec.n_in:], len(grads), spec.z_list))
        y = tree_map(torch.detach, y)
        if isinstance(gam, torch.Tensor):
            gam = gam.detach()
        g = _rebuild(grads, len(grads), spec.z_list)

        def H(v):
            return tree_map(lambda a, c: _gmul(gam, a) + c, physics.A_adjoint_A(v), v)

        # the adjoint system (gamma A^T A + I) u = g by CG, whatever the
        # forward's solver (linear.py:385-390)
        u = conjugate_gradient(H, g, max_iter=spec.max_iter, tol=spec.tol,
                               check_every=spec.check_every)
        need = ctx.needs_input_grad[1:]
        out = [None] * spec.n_in
        ny, nz = spec.n_y, spec.n_z
        if any(need[:ny]):
            out[:ny] = leaves(tree_map(lambda a: _gmul(gam, a), physics.A(u)))   # gamma A u
        out[ny:ny + nz] = leaves(u)
        if spec.gamma_input and need[ny + nz]:
            resid = physics.A_adjoint(tree_sub(physics.A(x), y))
            dg = -_bdot(u, resid)                    # -<u, A^T (A x - y)>
            out[ny + nz] = (dg.sum() if gam.dim() == 0 else dg).to(gam.dtype)
        if thetas and any(need[spec.n_in - len(thetas):]):
            # -vjp_theta[A_theta^T (A_theta x - y)](gamma u)
            with torch.enable_grad():
                h = physics.A_adjoint(tree_sub(physics.A(x), y))
                gu = tree_map(lambda a: _gmul(gam, a), u)
                dth = torch.autograd.grad(leaves(h), thetas, leaves(gu), allow_unused=True)
            out[spec.n_in - len(thetas):] = [None if d is None else -d for d in dth]
        return (None, *out)


class _ProxSpec:
    """What :class:`_LeastSquaresProx` needs beside its tensors."""

    def __init__(self, physics, y, z, gamma, thetas, solver, max_iter, tol, check_every):
        self.physics, self.solver = physics, solver
        self.max_iter, self.tol, self.check_every = max_iter, tol, check_every
        self.y_list, self.z_list = isinstance(y, TensorList), isinstance(z, TensorList)
        self.n_y, self.n_z = len(leaves(y)), len(leaves(z))
        self.gamma_input = isinstance(gamma, torch.Tensor)
        self.gamma = None if self.gamma_input else gamma
        self.n_in = self.n_y + self.n_z + self.gamma_input + len(thetas)

    def pack(self, y, z, gamma, thetas):
        return leaves(y) + leaves(z) + ([gamma] if self.gamma_input else []) + list(thetas)

    def unpack(self, tensors):
        ny, nz = self.n_y, self.n_z
        y = _rebuild(tensors[:ny], ny, self.y_list)
        z = _rebuild(tensors[ny:ny + nz], nz, self.z_list)
        gamma = tensors[ny + nz] if self.gamma_input else self.gamma
        return y, z, gamma, list(tensors[ny + nz + self.gamma_input:self.n_in])


def _least_squares_prox(physics, y, z, gamma, solver, max_iter, tol, check_every):
    """The prox solve, through the implicit backward when autograd needs a
    gradient of it (linear.py:350), else the plain forward solve."""
    thetas = _grad_tensors(physics)
    spec = _ProxSpec(physics, y, z, gamma, thetas, solver, max_iter, tol, check_every)
    tensors = spec.pack(y, z, gamma, thetas)
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in tensors)):
        return _physics_solve(physics, y, z, gamma, solver, max_iter, tol, check_every)
    out = _LeastSquaresProx.apply(spec, *tensors)
    return _rebuild(out, len(out), spec.z_list)


def least_squares(A, A_adjoint, y, solver: str = "CG", gamma=None, init=None, z=None, ATA=None,
                  AAT=None, max_iter: int = 100, tol: float = 1e-5, physics=None,
                  implicit_backward: bool = True, check_every: int = CHECK_EVERY, **_):
    """Solve a (regularized) least-squares problem (linear.py:421).

    With ``gamma``: ``argmin_x gamma/2 ||Ax - y||^2 + 1/2 ||x - z||^2``,
    ``gamma`` a number or a per-sample tensor (B,). Without:
    the minimum-norm least-squares solution ``A^dagger y``. ``solver`` is
    ``"CG"``, ``"BiCGStab"``, ``"MINRES"`` or ``"LSQR"``. When ``physics``
    is given, ``gamma`` is set and ``implicit_backward`` is on, gradients
    take the implicit backward (linear.py:466-468).

    All tensors are batch-first: dimension 0 holds independent systems."""
    if z is None and gamma is not None:
        z = tree_zeros_like(A_adjoint(y) if init is None else init)
    if physics is not None and gamma is not None and implicit_backward:
        return _least_squares_prox(physics, y, z, gamma, solver, max_iter, tol, check_every)
    return _solve_normal(A, A_adjoint, y, gamma, z, init, solver, max_iter, tol, ATA, AAT,
                         check_every)
