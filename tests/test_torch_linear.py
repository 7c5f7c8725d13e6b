"""The port's Krylov solvers and least squares against the JAX package's, on
the CPU (``tests/test_optim.py:261-304`` is the model).

CG, BiCGStab, MINRES and LSQR on batched random systems against JAX's and a
float64 numpy solve; ``least_squares`` with a scalar and a per-sample gamma
and the pseudo-inverse in both branches against JAX within 1e-4 relative;
the implicit backward (gradients of y, z, gamma and a ``Blur`` filter)
against ``jax.grad`` of the same function within 1e-3; the loops' host reads
every ``check_every`` iterations with the same bits as every iteration.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepinv_tpu.ops import gaussian_blur as jax_gaussian_blur
from deepinv_tpu.optim import bicgstab as jax_bicgstab
from deepinv_tpu.optim import conjugate_gradient as jax_cg
from deepinv_tpu.optim import least_squares as jax_least_squares
from deepinv_tpu.optim import lsqr as jax_lsqr
from deepinv_tpu.optim import minres as jax_minres
from deepinv_tpu.physics import Blur as JaxBlur
from deepinv_tpu.physics import Physics as JaxPhysics
from deepinv_tpu_torch.core import loop_stats, power_method
from deepinv_tpu_torch.utils.profiling import counters
from deepinv_tpu_torch.optim import bicgstab, conjugate_gradient, least_squares, lsqr, minres
from deepinv_tpu_torch.optim.utils import gradient_descent
from deepinv_tpu_torch.physics import Blur, LinearPhysics, Physics
from test_torch_drunet import DEV

SOLVERS = {"CG": (conjugate_gradient, jax_cg), "BiCGStab": (bicgstab, jax_bicgstab),
           "MINRES": (minres, jax_minres)}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _t(a):
    return torch.from_numpy(np.array(a))


def _spd(n=12, seed=7):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n)).astype(np.float32)
    return (M @ M.T + 5 * np.eye(n)).astype(np.float32), rng


@pytest.mark.parametrize("name", list(SOLVERS))
def test_square_solvers_match_jax_and_float64(name):
    """A batch of two systems with one SPD matrix: the port within 1e-4 of
    JAX and of the float64 solution."""
    S, rng = _spd()
    xtrue = rng.standard_normal((2, 12))
    b = (xtrue @ S.T).astype(np.float32)
    fn, jfn = SOLVERS[name]
    St = _t(S)
    got = fn(lambda v: v @ St.T, _t(b), max_iter=200, tol=1e-9).numpy()
    want = np.asarray(jfn(lambda v: v @ jnp.asarray(S).T, jnp.asarray(b), max_iter=200, tol=1e-9))
    exact = np.linalg.solve(S.astype(np.float64), b.astype(np.float64).T).T
    assert _rel(got, want) <= 1e-4 and _rel(got, exact) <= 1e-4


def test_lsqr_matches_jax_and_float64():
    """Overdetermined least squares, three right-hand sides, damped and not."""
    rng = np.random.default_rng(9)
    A = rng.standard_normal((20, 8)).astype(np.float32)
    y = (rng.standard_normal((3, 8)) @ A.T).astype(np.float32)
    At = _t(A)
    for gamma in (None, 4.0):
        got = lsqr(lambda v: v @ At.T, lambda u: u @ At, _t(y), gamma=gamma, max_iter=100,
                   tol=1e-10).numpy()
        want = np.asarray(jax_lsqr(lambda v: v @ jnp.asarray(A).T, lambda u: u @ jnp.asarray(A),
                                   jnp.asarray(y), gamma=gamma, max_iter=100, tol=1e-10))
        A64 = A.astype(np.float64)
        damp = 0.0 if gamma is None else 1.0 / gamma
        exact = np.linalg.solve(A64.T @ A64 + damp * np.eye(8), A64.T @ y.T.astype(np.float64)).T
        assert _rel(got, want) <= 1e-4 and _rel(got, exact) <= 1e-4


def _matrix_problem(m, n, seed):
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((m, n)) / np.sqrt(n)).astype(np.float32)
    y = rng.standard_normal((2, m)).astype(np.float32)
    z = rng.standard_normal((2, n)).astype(np.float32)
    At, Aj = _t(A), jnp.asarray(A)
    port = (lambda v: v @ At.T, lambda u: u @ At)
    ref = (lambda v: v @ Aj.T, lambda u: u @ Aj)
    return port, ref, y, z


@pytest.mark.parametrize("solver", ["CG", "BiCGStab", "MINRES", "LSQR"])
@pytest.mark.parametrize("gamma", ["scalar", "per-sample"])
def test_least_squares_prox_matches_jax(solver, gamma):
    """``argmin gamma/2 ||Ax - y||^2 + 1/2 ||x - z||^2`` with a scalar and a
    per-sample gamma, from ``z``."""
    port, ref, y, z = _matrix_problem(15, 10, 1)
    g = 2.5 if gamma == "scalar" else np.array([0.5, 3.0], np.float32)
    got = least_squares(*port, _t(y), solver=solver, gamma=g if gamma == "scalar" else _t(g),
                        z=_t(z), init=_t(z), max_iter=100, tol=1e-7).numpy()
    want = jax_least_squares(*ref, jnp.asarray(y), solver=solver, gamma=jnp.asarray(g),
                             z=jnp.asarray(z), init=jnp.asarray(z), max_iter=100, tol=1e-7)
    assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("shape", [(15, 10), (6, 10)], ids=["overdetermined", "underdetermined"])
@pytest.mark.parametrize("solver", ["CG", "LSQR"])
def test_pseudo_inverse_matches_jax(shape, solver):
    """Without gamma: ``A^T A x = A^T y`` when x is the smaller, ``x = A^T
    (A A^T)^-1 y`` when y is (linear.py:326-338), or LSQR."""
    port, ref, y, _ = _matrix_problem(*shape, 2)
    got = least_squares(*port, _t(y), solver=solver, max_iter=200, tol=1e-8).numpy()
    want = jax_least_squares(*ref, jnp.asarray(y), solver=solver, max_iter=200, tol=1e-8)
    assert _rel(got, want) <= 1e-4


def _blur_pair(seed=11):
    rng = np.random.default_rng(seed)
    f = np.array(jax_gaussian_blur(sigma=0.8))
    y, z, w = (rng.standard_normal((2, 1, 8, 8)).astype(np.float32) for _ in range(3))
    return f, y, z, w


@pytest.mark.parametrize("solver", ["CG", "LSQR"])
@pytest.mark.parametrize("gamma", ["scalar", "per-sample"])
def test_implicit_backward_matches_jax_grad(solver, gamma):
    """Gradients of ``sum(w * prox_l2(z, y, gamma))`` with respect to y, z,
    gamma and the Blur filter (a buffer that requires grad) through the
    implicit backward, against ``jax.grad`` through the ``custom_vjp``
    (linear.py:363-418): the backward solves by CG whatever the forward's
    solver. Relative max error <= 1e-3 each."""
    f, y, z, w = _blur_pair()
    g = np.float32(2.0) if gamma == "scalar" else np.array([0.7, 3.0], np.float32)

    def loss(phys, yv, zv, gv):
        out = phys.prox_l2(zv, yv, gv, solver=solver, max_iter=100, tol=1e-7)
        return jnp.sum(out * jnp.asarray(w))

    jp = JaxBlur(filter=jnp.asarray(f), padding="reflect")
    gp, gy, gz, gg = jax.grad(loss, argnums=(0, 1, 2, 3))(jp, jnp.asarray(y), jnp.asarray(z),
                                                          jnp.asarray(g))
    tp = Blur(torch.from_numpy(f), padding="reflect", device=DEV)
    tp.filter.requires_grad_(True)
    ty, tz, tg = (_t(v).requires_grad_(True) for v in (y, z, g))
    out = tp.prox_l2(tz, ty, tg, solver=solver, max_iter=100, tol=1e-7)
    assert type(out.grad_fn).__name__ == "_LeastSquaresProxBackward"   # no graph of the loop
    (out * _t(w)).sum().backward()
    for got, want in ((ty.grad, gy), (tz.grad, gz), (tg.grad, gg), (tp.filter.grad, gp.filter)):
        assert got.shape == tuple(np.shape(want)) and _rel(got.numpy(), want) <= 1e-3


def test_loops_are_the_same_bits_for_every_host_read_interval():
    """Every loop (the four solvers, a Blur's prox through its physics,
    the power method, gradient descent, the nonlinear A_dagger) with the
    stop flag read every iteration and every 8: ``torch.equal`` results, and
    at most one host read per 8 iterations."""
    S, rng = _spd(24, 3)
    b = _t((rng.standard_normal((3, 24)) @ S.T).astype(np.float32))
    St = _t(S)
    H = lambda v: v @ St.T   # noqa: E731
    f, y, z, _ = _blur_pair(4)
    phys = Blur(torch.from_numpy(f), padding="reflect", device=DEV)
    nonlin = Physics(A=lambda v: v + 0.1 * v ** 3)
    runs = {
        **{name: (lambda k, fn=fn: fn(H, b, max_iter=60, tol=1e-7, check_every=k))
           for name, (fn, _) in SOLVERS.items()},
        "LSQR": lambda k: lsqr(H, H, b, max_iter=60, tol=1e-7, check_every=k),
        "prox": lambda k: phys.prox_l2(_t(z), _t(y), 2.0, tol=1e-7, check_every=k),
        "power": lambda k: power_method(H, b, max_iter=200, tol=1e-7, check_every=k),
        "gd": lambda k: gradient_descent(lambda v: H(v) - b, b, step_size=0.01, max_iter=50,
                                         check_every=k),
        "A_dagger": lambda k: nonlin.A_dagger(_t(y), x_init=_t(z), check_every=k),
    }
    for name, run in runs.items():
        res = []
        for k in (1, 8):
            loop_stats.reset()
            counters.reset()
            res.append(run(k))
            n, reads = loop_stats.iterations, counters["loop.host_reads"]
            assert reads <= (n if k == 1 else -(-n // 8)) + 1, (name, k, n, reads)
        assert torch.equal(*res), name


def test_linear_physics_norms_and_pseudo_inverse_match_jax():
    """``compute_norm``, ``condition_number`` and the Krylov ``A_dagger`` of
    a Blur, and the nonlinear ``A_dagger`` (gradient descent), against JAX."""
    f, y, z, _ = _blur_pair(5)
    jp = JaxBlur(filter=jnp.asarray(f), padding="circular")
    tp = Blur(torch.from_numpy(f), padding="circular", device=DEV)
    x0 = z[:1]
    assert _rel(float(tp.compute_norm(_t(x0))), float(jp.compute_norm(jnp.asarray(x0)))) <= 1e-4
    assert _rel(float(tp.condition_number(_t(x0), max_iter=100)),
                float(jp.condition_number(jnp.asarray(x0), max_iter=100))) <= 1e-3
    assert _rel(tp.A_dagger(_t(y)).numpy(), jp.A_dagger(jnp.asarray(y))) <= 1e-4
    jn = JaxPhysics(A=lambda v: v + 0.1 * v ** 3, max_iter=30)
    tn = Physics(A=lambda v: v + 0.1 * v ** 3, max_iter=30)
    assert _rel(tn.A_dagger(_t(y)).numpy(), jn.A_dagger(jnp.asarray(y))) <= 1e-5
    assert _rel(float(tn.compute_norm(_t(x0), max_iter=30)),
                float(jn.compute_norm(jnp.asarray(x0), max_iter=30))) <= 1e-4
    wrapped = LinearPhysics(A=tp.A, A_adjoint=tp.A_adjoint)
    assert _rel(wrapped.prox_l2(None, _t(y), 1.5).numpy(),
                jp.prox_l2(None, jnp.asarray(y), 1.5)) <= 1e-4
