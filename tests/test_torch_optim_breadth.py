"""The rest of the port's ``optim/`` against the JAX package's, on the CPU:
``Potential``'s differentiable gradient, the distances, the data fidelities,
the Bregman potentials, the RED and sparsity priors, the MD, PMD, SIRT, MLEM
and SM reconstructions at 32², the DPIR schedule, and the exports of
``optim``, ``unfolded`` and the classic denoisers.

Inputs come from numpy seeds; JAX's random tables (the phase-retrieval
matrix, the ICNN's weights) cross by keyword or ``load_jax_params``. Bounds,
f32, max abs error over the reference's max: closed forms within 1e-5,
autodiff gradients and whole reconstructions within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepinv_tpu.models.classic as JC
import deepinv_tpu.optim as J
import deepinv_tpu.physics as JP
import deepinv_tpu.unfolded as JU
import deepinv_tpu_torch.models as TM
import deepinv_tpu_torch.optim as T
import deepinv_tpu_torch.physics as TP
import deepinv_tpu_torch.unfolded as TU
from deepinv_tpu.models import MedianFilter as JMedian
from deepinv_tpu_torch.models import load_jax_params
from test_torch_drunet import jax_params

DEV = "cpu"


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    dt = np.complex128 if np.iscomplexobj(a) or np.iscomplexobj(b) else np.float64
    a, b = a.astype(dt), b.astype(dt)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _t(a):
    return torch.from_numpy(np.array(a))


def _data(shape=(2, 1, 8, 8), seed=0, low=0.2):
    rng = np.random.default_rng(seed)
    return [(rng.random(shape) + low).astype(np.float32) for _ in range(2)]


# -- Potential -------------------------------------------------------------------------


def test_potential_gradient_is_differentiable():
    """``Potential.grad`` keeps its graph in grad mode: ``d/dx sum grad(x)``
    of ``fn = sum x^4`` is ``jax.grad`` of the JAX ``Potential.grad``, 12 x²;
    under ``no_grad`` and for an ``x`` without grad it carries no graph."""
    x = np.random.default_rng(1).standard_normal((2, 5)).astype(np.float32)
    jp = J.Potential(fn=lambda v: jnp.sum(v ** 4, axis=1))
    want = jax.grad(lambda v: jnp.sum(jp.grad(v)))(jnp.asarray(x))
    tp = T.Potential(fn=lambda v: (v ** 4).sum(1))
    xt = _t(x).requires_grad_()
    g = tp.grad(xt)
    assert g.requires_grad
    (h,) = torch.autograd.grad(g.sum(), xt)
    assert _rel(_np(h), want) <= 1e-6 and _rel(_np(h), 12 * x ** 2) <= 1e-6
    assert not tp.grad(_t(x)).requires_grad
    with torch.no_grad():
        assert not tp.grad(xt).requires_grad


def test_potential_conjugate_and_bregman_prox():
    """``grad_conj`` by autograd of ``conjugate`` and the inner-descent
    ``bregman_prox`` against the JAX defaults (potential.py:58, 71)."""
    u, y = _data()

    class JQ(J.Potential):
        def fn(self, v, *a, **k):
            return 0.5 * jnp.sum(v.reshape(v.shape[0], -1) ** 2, axis=1)

        def conjugate(self, v, *a, **k):
            return 0.5 * jnp.sum(v.reshape(v.shape[0], -1) ** 2, axis=1)

    class TQ(T.Potential):
        def fn(self, v, *a, **k):
            return 0.5 * (v.reshape(v.shape[0], -1) ** 2).sum(1)

        def conjugate(self, v, *a, **k):
            return 0.5 * (v.reshape(v.shape[0], -1) ** 2).sum(1)

    assert _rel(_np(TQ().grad_conj(_t(u))), JQ().grad_conj(jnp.asarray(u))) <= 1e-6
    want = JQ().bregman_prox(jnp.asarray(u), J.BregmanL2(), gamma=0.3)
    got = TQ().bregman_prox(_t(u), T.BregmanL2(), gamma=0.3)
    assert _rel(_np(got), want) <= 1e-5 and _rel(_np(got), u / 1.3) <= 1e-5


class _JSmoothTV(J.Prior):
    """``g(x) = sqrt(|grad x|^2)``, examples/demo_custom_prior_unfolded.py:35-44."""

    def fn(self, x, *args, **kwargs):
        s = jnp.sum((jnp.diff(x, axis=-1) ** 2).reshape(x.shape[0], -1), axis=1)
        s = s + jnp.sum((jnp.diff(x, axis=-2) ** 2).reshape(x.shape[0], -1), axis=1)
        return jnp.sqrt(s + 1e-12)


class _TSmoothTV(T.Prior):
    def fn(self, x, *args, **kwargs):
        s = (torch.diff(x, dim=-1) ** 2).reshape(x.shape[0], -1).sum(1)
        s = s + (torch.diff(x, dim=-2) ** 2).reshape(x.shape[0], -1).sum(1)
        return torch.sqrt(s + 1e-12)


def test_unfolded_gd_with_an_autodiff_prior_matches_jax():
    """Unrolled GD with the autodiff-gradient prior of the JAX package's
    example, 3 iterations on 16²: the loss and its gradient in the schedule
    against ``jax.grad`` (f32, 1e-4). The gradient runs through the prior's
    own gradient at each iterate, which needs ``Potential.grad``'s graph."""
    rng = np.random.default_rng(3)
    x = rng.random((2, 1, 16, 16)).astype(np.float32)
    mask = (rng.random((1, 16, 16)) < 0.5).astype(np.float32)
    y = x * mask
    pa = {"stepsize": [1.0, 0.8, 0.9], "lambda": [0.5, 0.3, 0.4], "g_param": 0.0}
    jnet = JU.unfolded_builder("GD", data_fidelity=J.L2(), prior=_JSmoothTV(), params_algo=pa,
                               max_iter=3, trainable_params=("stepsize", "lambda"))
    jphys = JP.Inpainting(img_size=(1, 16, 16), mask=jnp.asarray(mask))

    def jloss(net):
        return jnp.mean((net(jnp.asarray(y), jphys) - jnp.asarray(x)) ** 2)

    jl, jg = jax.value_and_grad(jloss)(jnet)
    tnet = TU.unfolded_builder("GD", data_fidelity=T.L2(), prior=_TSmoothTV(), params_algo=pa,
                               max_iter=3, trainable_params=("stepsize", "lambda"), device=DEV)
    tphys = TP.Inpainting((1, 16, 16), mask=_t(mask), device=DEV)
    tl = ((tnet(_t(y), tphys) - _t(x)) ** 2).mean()
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= 1e-4 * abs(float(jl))
    for k in ("stepsize", "lambda"):
        got = getattr(tnet, f"param_{k}").grad
        assert got is not None and _rel(_np(got), jg.params_algo[k]) <= 1e-4, k


# -- distances and fidelities -----------------------------------------------------------

DISTANCES = [("L2Distance", {"sigma": 0.5}), ("IndicatorL2Distance", {"radius": 10.0}),
             ("PoissonLikelihoodDistance", {"gain": 0.5, "bkg": 0.1, "denormalize": True}),
             ("L1Distance", {}), ("AmplitudeLossDistance", {}),
             ("LogPoissonLikelihoodDistance", {"N0": 512.0, "mu": 0.05}), ("ZeroDistance", {})]


@pytest.mark.parametrize("name,kw", DISTANCES, ids=[d[0] for d in DISTANCES])
def test_distance_matches_jax(name, kw):
    u, y = _data()
    jd, td = getattr(J, name)(**kw), getattr(T, name)(**kw)
    ju, jy, tu, ty = jnp.asarray(u), jnp.asarray(y), _t(u), _t(y)
    assert _rel(_np(td.fn(tu, ty)), jd.fn(ju, jy)) <= 1e-5
    assert _rel(_np(td.grad(tu, ty)), jd.grad(ju, jy)) <= 1e-5
    if name not in ("AmplitudeLossDistance", "LogPoissonLikelihoodDistance"):
        assert _rel(_np(td.prox(tu, ty, gamma=0.3)), jd.prox(ju, jy, gamma=0.3)) <= 1e-5
    if name == "IndicatorL2Distance":   # outside the ball: infinite, and the projection
        assert torch.isinf(td.fn(tu, ty, radius=0.5)).all()
        assert _rel(_np(td.prox(tu, ty, radius=0.5)), jd.prox(ju, jy, radius=0.5)) <= 1e-5


def test_poisson_prox_is_the_minimizer():
    """The closed-form Poisson prox is the minimizer of ``gamma d(v, y) + 1/2
    (v - u)^2`` (the deviation from upstream that the JAX package and the
    port share): the optimality residual, with the derivative of ``fn`` by
    autograd, is zero."""
    u, y = _data()
    d = T.PoissonLikelihoodDistance(gain=0.5, bkg=0.1)
    v = d.prox(_t(u), _t(y), gamma=0.3)
    r = 0.3 * T.Distance.grad(d, v, _t(y)) + (v - _t(u))
    assert float(r.abs().max()) <= 1e-5


FIDELITIES = ["L2", "IndicatorL2", "PoissonLikelihood", "L1", "AmplitudeLoss",
              "LogPoissonLikelihood", "ZeroFidelity"]


@pytest.mark.parametrize("name", FIDELITIES)
def test_fidelity_matches_jax(name):
    """``fn``, ``grad`` and ``prox`` through a blur (``Denoising`` for the
    closed-form ball projection), the dual solvers at a given step."""
    u, y = _data((2, 1, 12, 12), seed=2)
    kw = {"radius": 2.0} if name == "IndicatorL2" else {}
    jf, tf = getattr(J, name)(**kw), getattr(T, name)(**kw)
    filt = np.outer(*(np.array([0.25, 0.5, 0.25], np.float32),) * 2)[None, None]
    jphys = JP.BlurFFT(img_size=(1, 12, 12), filter=jnp.asarray(filt))
    tphys = TP.BlurFFT((1, 12, 12), filter=_t(filt), device=DEV)
    ju, jy, tu, ty = jnp.asarray(u), jnp.asarray(y), _t(u), _t(y)
    if name not in ("IndicatorL2",):
        assert _rel(_np(tf.fn(tu, ty, tphys)), jf.fn(ju, jy, jphys)) <= 1e-5
    assert _rel(_np(tf.grad(tu, ty, tphys)), jf.grad(ju, jy, jphys)) <= 1e-4
    if name in ("L2", "ZeroFidelity"):
        assert _rel(_np(tf.prox(tu, ty, tphys, gamma=0.5)), jf.prox(ju, jy, jphys, gamma=0.5)) \
            <= 1e-5
    elif name in ("IndicatorL2", "L1"):
        got = tf.prox(tu, ty, tphys, gamma=0.5, stepsize=0.9, max_iter=40)
        want = jf.prox(ju, jy, jphys, gamma=0.5, stepsize=0.9, max_iter=40)
        assert _rel(_np(got), want) <= 1e-4
        if name == "IndicatorL2":
            got = tf.prox(tu, ty, TP.Denoising())
            assert _rel(_np(got), jf.prox(ju, jy, JP.Denoising())) <= 1e-5
    else:   # the inner gradient descent of the base class
        kw = dict(gamma=0.01, max_iter_inter=20)
        assert _rel(_np(tf.prox(tu, ty, tphys, **kw)), jf.prox(ju, jy, jphys, **kw)) <= 1e-4
    if name == "PoissonLikelihood":
        assert _rel(_np(tf.prox_d(tu, ty, gamma=0.5)), jf.prox_d(ju, jy, gamma=0.5)) <= 1e-5


def test_itoh_fidelity_matches_jax():
    """``ItohFidelity`` over ``SpatialUnwrapping``: ``D``, its adjoint,
    ``fn``, ``grad``, the DCT prox and ``D_dagger``."""
    rng = np.random.default_rng(4)
    x = (rng.random((1, 1, 12, 14)) * 6).astype(np.float32)
    jf, tf = J.ItohFidelity(threshold=1.0), T.ItohFidelity(threshold=1.0)
    jphys = JP.SpatialUnwrapping(threshold=1.0, mode="round")
    tphys = TP.SpatialUnwrapping(threshold=1.0, mode="round")
    jy, ty = jphys.A(jnp.asarray(x)), tphys.A(_t(x))
    assert _rel(_np(ty), jy) <= 1e-6
    v = rng.standard_normal((1, 1, 12, 14, 2)).astype(np.float32)
    assert _rel(_np(tf.D(_t(x))), jf.D(jnp.asarray(x))) <= 1e-6
    assert _rel(_np(tf.D_adjoint(_t(v))), jf.D_adjoint(jnp.asarray(v))) <= 1e-6
    z = jnp.asarray(x) + 0.1
    assert _rel(_np(tf.fn(_t(np.asarray(z)), ty)), jf.fn(z, jy)) <= 1e-5
    assert _rel(_np(tf.grad(_t(np.asarray(z)), ty)), jf.grad(z, jy)) <= 1e-5
    assert _rel(_np(tf.prox(_t(np.asarray(z)), ty, gamma=0.7)), jf.prox(z, jy, gamma=0.7)) <= 1e-4
    assert _rel(_np(tf.D_dagger(ty)), jf.D_dagger(jy)) <= 1e-4


# -- Bregman ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["BregmanL2", "BurgEntropy", "NegEntropy"])
def test_bregman_potential_matches_jax(name):
    u, y = _data()
    jh, th = getattr(J, name)(), getattr(T, name)()
    ju, jy, tu, ty = jnp.asarray(u), jnp.asarray(y), _t(u), _t(y)
    assert _rel(_np(th.fn(tu)), jh.fn(ju)) <= 1e-5
    assert _rel(_np(th.grad(tu)), jh.grad(ju)) <= 1e-6
    xi = jh.grad(ju) - 0.1
    assert _rel(_np(th.grad_conj(_t(np.asarray(xi)))), jh.grad_conj(xi)) <= 1e-6
    assert _rel(_np(th.div(tu, ty)), jh.div(ju, jy)) <= 1e-4
    assert _rel(_np(th.MD_step(tu, ty, gamma=0.1)), jh.MD_step(ju, jy, gamma=0.1)) <= 1e-5


def test_bregman_icnn_matches_jax():
    """``Bregman_ICNN`` on the JAX ICNN's weights crossed by name: the
    potential, its gradient and the inverse-gradient iteration."""
    from deepinv_tpu.models.wrappers_models import ICNN as JICNN

    jnet = JICNN(in_channels=1, dim_hidden=8, depth=3, key=jax.random.key(2))
    tnet = load_jax_params(TM.ICNN(in_channels=1, dim_hidden=8, depth=3, device=DEV),
                           jax_params(jnet))
    jh, th = J.Bregman_ICNN(jnet), T.Bregman_ICNN(tnet)
    u, _ = _data()
    assert _rel(_np(th.fn(_t(u))), jh.fn(jnp.asarray(u))) <= 1e-5
    assert _rel(_np(th.grad(_t(u))), jh.grad(jnp.asarray(u))) <= 1e-4
    got = th.grad_conj(_t(u), max_iter=2, lr=0.01)
    assert _rel(_np(got), jh.grad_conj(jnp.asarray(u), max_iter=2, lr=0.01)) <= 1e-4


# -- priors ----------------------------------------------------------------------------


@pytest.mark.parametrize("name,kw", [("L1Prior", {}), ("L12Prior", {}), ("L12Prior", {"l2_axis": 1}),
                                     ("WaveletPrior", {"wv": "db2", "level": 3}),
                                     ("TVL1Prior", {"n_it_max": 30}), ("Tikhonov", {})])
def test_prior_matches_jax(name, kw):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 2, 16, 16)).astype(np.float32)
    jp, tp = getattr(J, name)(**kw), getattr(T, name)(**kw)
    assert _rel(_np(tp.fn(_t(x))), jp.fn(jnp.asarray(x))) <= 1e-5
    assert _rel(_np(tp.prox(_t(x), gamma=0.3)), jp.prox(jnp.asarray(x), gamma=0.3)) <= 1e-5
    if name == "TVL1Prior":
        g = _np(tp.nabla(_t(x)))
        assert _rel(g, jp.nabla(jnp.asarray(x))) <= 1e-6
        assert _rel(_np(tp.nabla_adjoint(_t(g))), jp.nabla_adjoint(jnp.asarray(g))) <= 1e-6
    if name == "WaveletPrior":
        for a, b in zip(tp.psi(_t(x)), jp.psi(jnp.asarray(x))):
            assert _rel(_np(a), b) <= 1e-5


def test_red_and_score_priors_match_jax():
    u, _ = _data((1, 1, 16, 16))
    want = J.RED(JMedian(3)).grad(jnp.asarray(u), 0.05)
    got = T.RED(TM.MedianFilter(3)).grad(_t(u), 0.05)
    assert _rel(_np(got), want) <= 1e-6
    b = np.array([0.0, -1e-9, 2.0, -3.0], np.float32)
    assert _rel(_np(T.ScorePrior.stable_division(_t(np.ones(4, np.float32)), _t(b))),
                J.ScorePrior.stable_division(jnp.ones(4), jnp.asarray(b))) <= 1e-6


# -- the five iterators ----------------------------------------------------------------


def _poisson_problem(size=32, gain=0.05):
    rng = np.random.default_rng(6)
    x = (rng.random((1, 1, size, size)) * 0.7 + 0.2).astype(np.float32)
    y = (gain * rng.poisson(x / gain)).astype(np.float32)
    return x, y


@pytest.mark.parametrize("it", ["MD", "PMD"])
def test_mirror_descent_recon_matches_jax(it):
    """PnP mirror descent of examples/demo_pnp_mirror_descent.py at 32² (RED
    of a 3x3 median, Burg entropy, Poisson likelihood), and proximal mirror
    descent with an l1 prior's Bregman prox; 10 iterations each."""
    gain = 0.05
    x, y = _poisson_problem(gain=gain)
    pa = {"stepsize": 0.01, "g_param": 0.05, "lambda": 1.0}
    jprior = J.RED(JMedian(3)) if it == "MD" else J.L1Prior()
    tprior = T.RED(TM.MedianFilter(3)) if it == "MD" else T.L1Prior()
    jm = J.optim_builder(it, data_fidelity=J.PoissonLikelihood(gain=gain), prior=jprior,
                         bregman_potential=J.BurgEntropy(), params_algo=pa, max_iter=10)
    tm = T.optim_builder(it, data_fidelity=T.PoissonLikelihood(gain=gain), prior=tprior,
                         bregman_potential=T.BurgEntropy(), params_algo=pa, max_iter=10,
                         device=DEV)
    want = jm(jnp.asarray(y), JP.Denoising())
    got = tm(_t(y), TP.Denoising())
    assert _rel(_np(got), want) <= 1e-4


@pytest.mark.parametrize("it", ["SIRT", "MLEM"])
def test_tomography_recon_matches_jax(it):
    """SIRT and MLEM (examples/demo_poisson_mlem.py) on 32² parallel-beam CT,
    20 iterations; the loop invariants (row and column sums, the sensitivity)
    are made once a reconstruction."""
    rng = np.random.default_rng(7)
    x = (rng.random((1, 1, 32, 32)) * 0.8 + 0.1).astype(np.float32)
    jphys = JP.Tomography(img_width=32, angles=24)
    tphys = TP.Tomography(img_width=32, angles=24, device=DEV)
    y = np.asarray(jphys.A(jnp.asarray(x))) + 0.01
    pa = {"stepsize": 1.0}
    jm = J.optim_builder(it, data_fidelity=J.PoissonLikelihood(gain=1.0), prior=J.Zero(),
                         params_algo=pa, max_iter=20)
    tm = T.optim_builder(it, data_fidelity=T.PoissonLikelihood(gain=1.0), prior=T.Zero(),
                         params_algo=pa, max_iter=20, device=DEV)
    calls = []
    orig = tphys.A_adjoint
    tphys.A_adjoint = lambda v, **k: calls.append(1) or orig(v, **k)
    got = tm(_t(y), tphys)
    assert _rel(_np(got), jm(jnp.asarray(y), jphys)) <= 1e-4
    # A^T a recon: the initial A^T y, one an iteration, one loop invariant
    assert len(calls) == 20 + 2
    if it == "MLEM":   # positive, and the likelihood rises
        short = T.optim_builder(it, prior=T.Zero(), params_algo=pa, max_iter=5, device=DEV)
        nll = [float(T.PoissonLikelihood(gain=1.0, bkg=1e-6).fn(v, _t(y), tphys).sum())
               for v in (short(_t(y), tphys), got)]
        assert np.isfinite(nll).all() and nll[1] < nll[0] and bool((got >= 0).all())


def test_spectral_method_recon_matches_jax():
    """The SM iterator on random phase retrieval (the JAX test's problem),
    the matrix and the start crossed from JAX, 30 iterations."""
    jp = JP.RandomPhaseRetrieval(m=300, img_size=(1, 8, 8), key=jax.random.key(1))
    tp = TP.RandomPhaseRetrieval(m=300, img_size=(1, 8, 8), matrix=np.asarray(jp.B.mat),
                                 device=DEV)
    x = jax.random.normal(jax.random.key(3), (1, 1, 8, 8)).astype(jnp.complex64)
    x0 = np.asarray(jax.random.normal(jax.random.key(23), (1, 1, 8, 8)).astype(jnp.complex64))
    y = jp.A(x)
    kw = dict(params_algo={"stepsize": 1.0}, max_iter=30)
    jm = J.optim_builder("SM", data_fidelity=J.L2(), prior=J.Zero(),
                         custom_init=lambda yy, p: jnp.asarray(x0), **kw)
    tm = T.optim_builder("SM", data_fidelity=T.L2(), prior=T.Zero(),
                         custom_init=lambda yy, p: _t(x0), device=DEV, **kw)
    assert _rel(_np(tm(_t(np.asarray(y)), tp)), jm(y, jp)) <= 1e-4


def test_builders_and_iterators():
    """``optim_builder`` takes every iteration the JAX package has; the named
    builders; ``unfold`` makes the schedule parameters; ``DEQ_additional_step``
    is one more iteration at the last parameters."""
    for name in ("MD", "PMD", "SM", "SIRT", "MLEM"):
        m = T.optim_builder(name, max_iter=3, device=DEV)
        assert type(m.iterator).__name__ == f"{name}Iteration"
    assert isinstance(T.MLEM(max_iter=2, device=DEV).iterator, T.MLEMIteration)
    m = T.PGD(params_algo={"stepsize": [1.0, 2.0]}, max_iter=4, unfold=True, device=DEV)
    assert isinstance(m.param_stepsize, torch.nn.Parameter)
    assert "param_stepsize" in dict(m.named_parameters())
    with pytest.raises(ValueError):
        T.create_iterator("PGD", bregman_potential=T.BurgEntropy())
    u, y = _data((1, 1, 8, 8))
    X = {"est": (_t(u), _t(u)), "it": 0}
    out = m.DEQ_additional_step(X, _t(y), TP.Denoising())
    want = _t(u) - 2.0 * (_t(u) - _t(y))
    assert torch.allclose(out["est"][0], want)


def test_dpir_schedule_matches_jax():
    for sigma, n in ((0.05, 4), (0.01, 8), (1e-5, 6)):
        jp, tp = J.get_DPIR_params(sigma, max_iter=n), T.get_DPIR_params(sigma, max_iter=n)
        assert set(jp) == set(tp)
        for k in ("g_param", "stepsize"):
            assert np.array_equal(np.asarray(jp[k], np.float32), np.asarray(tp[k], np.float32))
    m = T.DPIR(0.05, denoiser=TM.MedianFilter(), max_iter=4, device=DEV)
    assert torch.equal(m.params_algo["g_param"],
                       torch.tensor(np.asarray(J.get_DPIR_params(0.05, 4)["g_param"])))


def test_exports_every_jax_name():
    """``deepinv_tpu_torch.optim`` exports every public name of
    ``deepinv_tpu.optim``; ``unfolded`` every name of ``deepinv_tpu.unfolded``
    but its JAX imports; ``models`` every classic denoiser."""
    assert [n for n in dir(J) if not n.startswith("_") and not hasattr(T, n)] == []
    jax_imports = {"jax", "jnp", "Module", "Optional"}
    assert [n for n in dir(JU) if not n.startswith("_") and n not in jax_imports
            and not hasattr(TU, n)] == []
    assert [n for n in JC.__all__ if not hasattr(TM, n)] == []
