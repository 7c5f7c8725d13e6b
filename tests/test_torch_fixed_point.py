"""The port's fixed-point loop options against the JAX package's, on the CPU:
early stop (the same stopping iteration), Anderson acceleration,
backtracking and ``remat``, on the ``Tikhonov`` inpainting problems of
``tests/test_optim.py`` (:56-62, :104-135, :307-335) and with ``TVPrior`` on
a blurred phantom; f32, within 1e-4 relative max error of JAX. Early stop's
flag is read by the host every ``check_every`` iterations: the run is the
same bits for every ``check_every``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepinv_tpu.ops import gaussian_blur as jax_gaussian_blur
from deepinv_tpu.optim import L2 as JaxL2
from deepinv_tpu.optim import Tikhonov as JaxTikhonov
from deepinv_tpu.optim import TVPrior as JaxTVPrior
from deepinv_tpu.optim import optim_builder as jax_optim_builder
from deepinv_tpu.physics import BlurFFT as JaxBlurFFT
from deepinv_tpu.physics import Inpainting as JaxInpainting
from deepinv_tpu_torch.ops import gaussian_blur
from deepinv_tpu_torch.optim import (L2, AndersonAccelerationConfig, BacktrackingConfig,
                                     Tikhonov, TVPrior, check_conv, objective_function,
                                     optim_builder)
from deepinv_tpu_torch.physics import BlurFFT, Inpainting
from deepinv_tpu_torch.utils.profiling import counters
from test_torch_drunet import DEV

IMSIZE = (1, 16, 16)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


@pytest.fixture(scope="module")
def inpainting():
    """``tests/test_optim.py``'s problem: a uniform image, a 0.7 mask."""
    x = jax.random.uniform(jax.random.key(0), (1,) + IMSIZE)
    jp = JaxInpainting(img_size=IMSIZE, mask=0.7, key=jax.random.key(1))
    tp = Inpainting(IMSIZE, mask=torch.from_numpy(np.array(jp.mask)), device=DEV)
    return np.array(jp.A(x)), jp, tp


@pytest.fixture(scope="module")
def deblur():
    """A blurred, noisy piecewise-constant phantom for ``TVPrior``."""
    rng = np.random.default_rng(3)
    x = np.zeros((1, 1, 24, 24), np.float32)
    x[..., 4:14, 6:20] = 0.8
    x[..., 12:20, 2:10] = 0.4
    jp = JaxBlurFFT(img_size=(1, 24, 24), filter=jax_gaussian_blur(sigma=1.5))
    tp = BlurFFT((1, 24, 24), filter=gaussian_blur(sigma=1.5), device=DEV)
    y = np.array(jp.A(jnp.asarray(x))) + 0.02 * rng.standard_normal(x.shape).astype(np.float32)
    return y, jp, tp


def _both(problem, algo, jprior, tprior, params, max_iter, **kw):
    """The same reconstruction in both packages: (port output, JAX output,
    port model, JAX model)."""
    y, jp, tp = problem
    jm = jax_optim_builder(algo, data_fidelity=JaxL2(), prior=jprior, params_algo=params,
                           max_iter=max_iter, **kw)
    tm = optim_builder(algo, data_fidelity=L2(), prior=tprior, params_algo=params,
                       max_iter=max_iter, device=DEV, **kw)
    want = np.asarray(jax.jit(lambda m, v: m(v, jp))(jm, jnp.asarray(y)))
    with torch.no_grad():
        got = tm(torch.from_numpy(y), tp).numpy()
    return got, want, tm, jm


def _jax_stop_iteration(jm, y, jp):
    """The iteration the JAX package's early-stopped loop ends at."""
    def run(m, v):
        X = m.fixed_point(m.init_iterate(v, jp), m.data_fidelity, m.prior, m.params_algo, v, jp)
        return X["it"]
    return int(jax.jit(run)(jm, jnp.asarray(y)))


@pytest.mark.parametrize("prior", ["tikhonov", "tv"])
def test_early_stop_matches_jax(inpainting, deblur, prior):
    """Early stop at a threshold the run reaches: JAX's output and its
    stopping iteration."""
    if prior == "tikhonov":
        case = (inpainting, "PGD", JaxTikhonov(), Tikhonov(), {"stepsize": 0.9, "lambda": 0.3},
                1000, 1e-6)
    else:
        case = (deblur, "PGD", JaxTVPrior(n_it_max=20), TVPrior(n_it_max=20),
                {"stepsize": 1.0, "lambda": 0.02}, 200, 2e-4)
    problem, algo, jprior, tprior, params, max_iter, thres = case
    got, want, tm, jm = _both(problem, algo, jprior, tprior, params, max_iter,
                              early_stop=True, thres_conv=thres)
    n = int(tm.fixed_point.last_run["iterations"])
    assert 1 < n < max_iter and n == _jax_stop_iteration(jm, problem[0], problem[1])
    assert _rel(got, want) <= 1e-4


def test_early_stop_is_the_same_for_every_host_read_interval(inpainting):
    """The stop flag read every 1 or 8 iterations: the same bits, the same
    stopping iteration; reads at most every 8 iterations."""
    y, _, tp = inpainting
    model = optim_builder("PGD", data_fidelity=L2(), prior=Tikhonov(),
                          params_algo={"stepsize": 0.9, "lambda": 0.3}, max_iter=1000,
                          early_stop=True, thres_conv=1e-6, device=DEV)
    out, stops, reads = [], [], []
    for k in (1, 8):
        model.fixed_point.check_every = k
        counters.reset()
        with torch.no_grad():
            out.append(model(torch.from_numpy(y), tp))
        stops.append(int(model.fixed_point.last_run["iterations"]))
        reads.append(counters["loop.host_reads"])
    assert torch.equal(*out) and stops[0] == stops[1]
    assert reads[0] == stops[0] and reads[1] == -(-stops[0] // 8)


@pytest.mark.parametrize("prior", ["tikhonov", "tv"])
def test_anderson_acceleration_matches_jax(inpainting, deblur, prior):
    """Anderson mixing over 5 iterates: JAX's output; on Tikhonov closer to
    the minimizer than the plain run (tests/test_optim.py:120-135)."""
    if prior == "tikhonov":
        problem, jpr, tpr, params = inpainting, JaxTikhonov(), Tikhonov(), {"stepsize": 0.2,
                                                                            "lambda": 0.3}
    else:
        problem, jpr, tpr, params = deblur, JaxTVPrior(n_it_max=20), TVPrior(n_it_max=20), {
            "stepsize": 1.0, "lambda": 0.02}
    got, want, tm, _ = _both(problem, "PGD", jpr, tpr, params, 8, anderson_acceleration=True)
    assert _rel(got, want) <= 1e-4
    if prior == "tikhonov":
        y, jp, tp = problem
        with torch.no_grad():
            plain = optim_builder("PGD", data_fidelity=L2(), prior=Tikhonov(), params_algo=params,
                                  max_iter=8, device=DEV)(torch.from_numpy(y), tp).numpy()
            star = optim_builder("PGD", data_fidelity=L2(), prior=Tikhonov(),
                                 params_algo={"stepsize": 0.9, "lambda": 0.3}, max_iter=2000,
                                 device=DEV)(torch.from_numpy(y), tp).numpy()
        assert np.abs(got - star).max() < np.abs(plain - star).max()


@pytest.mark.parametrize("algo,prior", [("GD", "tikhonov"), ("PGD", "tv")])
def test_backtracking_matches_jax(inpainting, deblur, algo, prior):
    """A stepsize at which the plain run diverges (2.5 > 2 / L): with
    backtracking the run retries at half the stepsize and matches JAX; the
    plain run ends farther from it."""
    if prior == "tikhonov":
        problem, jpr, tpr, params, n = inpainting, JaxTikhonov(), Tikhonov(), {
            "stepsize": 2.5, "lambda": 0.3}, 60
    else:
        problem, jpr, tpr, params, n = deblur, JaxTVPrior(n_it_max=20), TVPrior(n_it_max=20), {
            "stepsize": 2.5, "lambda": 0.02}, 20
    got, want, tm, _ = _both(problem, algo, jpr, tpr, params, n, backtracking=True)
    assert tm.fixed_point.last_run["retries"] >= 1
    assert _rel(got, want) <= 1e-4
    y, _, tp = problem
    with torch.no_grad():
        div = optim_builder(algo, data_fidelity=L2(), prior=tpr, params_algo=params,
                            max_iter=n, device=DEV)(torch.from_numpy(y), tp).numpy()
    assert np.abs(div - want).max() > 10 * np.abs(got - want).max()


def test_remat_matches_plain_and_jax_gradient(inpainting):
    """``remat=True`` recomputes each iteration in the backward: the same
    output and the same gradient of the stepsize schedule as without it, and
    JAX's gradient (``jax.grad`` through the ``jax.checkpoint`` scan)."""
    y, jp, tp = inpainting
    params = {"stepsize": 0.3, "lambda": 0.3}   # 5 iterations, far from converged
    jm = jax_optim_builder("PGD", data_fidelity=JaxL2(), prior=JaxTikhonov(), params_algo=params,
                           max_iter=5, remat=True)
    g_want = jax.grad(lambda m: jnp.sum(m(jnp.asarray(y), jp) ** 2))(jm).params_algo["stepsize"]
    grads, outs = [], []
    for remat in (True, False):
        tm = optim_builder("PGD", data_fidelity=L2(), prior=Tikhonov(), params_algo=params,
                           max_iter=5, remat=remat, device=DEV)
        tm.param_stepsize.requires_grad_(True)
        out = tm(torch.from_numpy(y), tp)
        (out ** 2).sum().backward()
        grads.append(tm.param_stepsize.grad.numpy())
        outs.append(out.detach())
    assert torch.equal(*outs)
    np.testing.assert_allclose(grads[0], grads[1], rtol=1e-6, atol=1e-7)
    assert np.abs(grads[0]).min() > 1e-2 and _rel(grads[0], g_want) <= 1e-4


def test_host_side_checks_and_configs(inpainting):
    """``check_conv_fn``, ``backtracking_check_fn``, ``check_conv`` and the
    objective against the JAX package's; the config records' defaults."""
    from deepinv_tpu.optim.utils import check_conv as jax_check_conv

    y, jp, tp = inpainting
    params = {"stepsize": 0.9, "lambda": 0.3}
    jm = jax_optim_builder("PGD", data_fidelity=JaxL2(), prior=JaxTikhonov(), params_algo=params,
                           max_iter=3)
    tm = optim_builder("PGD", data_fidelity=L2(), prior=Tikhonov(), params_algo=params,
                       max_iter=3, device=DEV)
    rng = np.random.default_rng(4)
    a, b = (rng.random((1,) + IMSIZE).astype(np.float32) for _ in range(2))
    Xa, Xb = ({"est": (torch.from_numpy(v),)} for v in (a, b))
    Ja, Jb = ({"est": (jnp.asarray(v),)} for v in (a, b))
    cur = {k: v[0] for k, v in tm.params_algo.items()}
    jcur = {k: v[0] for k, v in jm.params_algo.items()}
    for thres in (0.1, 10.0):
        tm.fixed_point.thres_conv = jm.fixed_point.thres_conv = thres
        assert tm.check_conv_fn(0, Xa, Xb) == jm.check_conv_fn(0, Ja, Jb)
        assert bool(check_conv(Xa, Xb, 0, thres_conv=thres)) == bool(
            jax_check_conv(Ja, Jb, 0, thres_conv=thres))
    for X0, X1, J0, J1 in ((Xa, Xb, Ja, Jb), (Xb, Xa, Jb, Ja)):
        assert bool(tm.backtracking_check_fn(X0, X1, cur, torch.from_numpy(y), tp)) == bool(
            jm.backtracking_check_fn(J0, J1, jcur, jnp.asarray(y), jp))
    F = objective_function(torch.from_numpy(a), L2(), Tikhonov(), cur, torch.from_numpy(y), tp)
    from deepinv_tpu.optim.iterators import objective_function as jax_objective

    assert _rel(F.numpy(), jax_objective(jnp.asarray(a), JaxL2(), JaxTikhonov(), jcur,
                                         jnp.asarray(y), jp)) <= 1e-6
    assert (AndersonAccelerationConfig().history_size, BacktrackingConfig().eta) == (5, 0.5)
