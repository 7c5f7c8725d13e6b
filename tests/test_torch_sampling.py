"""The port's samplers against the JAX package's, on the CPU.

JAX keys and torch generators cannot give the same numbers, so each test
computes the JAX sampler's draws with its own key schedule (``ensure_key``,
then ``split`` as the sampler does) and hands them to the port through
``draws=``. Denoisers: a small DRUNet whose weights cross by
``load_jax_params`` (f32, and bf16 ``autocast`` with scale 0 at 64 channels,
so that the port runs K1's plain version while the JAX CPU path runs XLA),
or Tweedie's closed-form denoiser of a Gaussian prior (``test_sampling.py``'s). Bounds: f32 samples
within 1e-4 relative L2 of JAX, bf16 within 5e-2; DPS's guidance gradient
within 1e-4 (f32) and 3e-2 (bf16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepinv_tpu_torch.ops.kernels.resblock_chain as rc_mod
from deepinv_tpu.core.rng import ensure_key
from deepinv_tpu.models import DRUNet as JaxDRUNet
from deepinv_tpu.models import autocast as jax_autocast
from deepinv_tpu.ops import gaussian_blur as jax_gaussian_blur
from deepinv_tpu import optim as jopt
from deepinv_tpu import physics as jphys
from deepinv_tpu import sampling as jsamp
from deepinv_tpu_torch import optim as topt
from deepinv_tpu_torch import physics as tphys
from deepinv_tpu_torch import sampling as tsamp
from deepinv_tpu_torch.models import DRUNet, autocast, load_jax_params
from deepinv_tpu_torch.ops import gaussian_blur
from test_sampling import _GaussianScoreDenoiser as _Gaussian  # Tweedie, N(mu, tau^2 I)
from test_torch_drunet import jax_params

DEV = "cpu"
NC = (64, 32, 32, 32)
SIZE = 32


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _t(a):
    return torch.tensor(np.asarray(a))


def _normals(keys, shape, dtype=jnp.float32):
    return [np.asarray(jax.random.normal(k, shape, dtype)) for k in keys]


def _first_then_steps(key, n, shape, dtype=jnp.float32):
    """The draws of a sampler that splits off one key for a first draw and
    then splits the rest into ``n`` step keys (DDRM :76-84, DiffPIR
    :239-246, DPS :306-312)."""
    k0, rest = jax.random.split(ensure_key(key))
    return _normals([k0], shape, dtype) + _normals(jax.random.split(rest, n), shape, dtype)


@pytest.fixture(scope="module")
def drunets():
    """A small 1-channel DRUNet in both packages, the same weights."""
    ref = JaxDRUNet(in_channels=1, out_channels=1, nc=NC, nb=1, key=jax.random.key(0))
    port = load_jax_params(DRUNet(in_channels=1, out_channels=1, nc=NC, nb=1, device=DEV),
                           jax_params(ref))
    return ref, port


def _denoisers(drunets, dtype):
    ref, port = drunets
    return (ref, port) if dtype == "f32" else (jax_autocast(ref), autocast(port))


BOUND = {"f32": 1e-4, "bf16": 5e-2}


def _inpainting(seed=0, noise=0.05, batch=1, channels=1):
    rng = np.random.default_rng(seed)
    x = rng.random((batch, channels, SIZE, SIZE)).astype(np.float32)
    mask = (rng.random((1, channels, SIZE, SIZE)) < 0.7).astype(np.float32)
    y = (x + noise * rng.standard_normal(x.shape).astype(np.float32)) * mask
    jp = jphys.Inpainting(img_size=(channels, SIZE, SIZE), mask=jnp.asarray(mask),
                          noise_model=jphys.GaussianNoise(noise))
    tp = tphys.Inpainting((channels, SIZE, SIZE), mask=_t(mask), device=DEV,
                          noise_model=tphys.GaussianNoise(noise, device=DEV))
    return y, jp, tp


def _blur(seed=1, noise=0.05):
    rng = np.random.default_rng(seed)
    x = rng.random((1, 1, SIZE, SIZE)).astype(np.float32)
    jp = jphys.BlurFFT(img_size=(1, SIZE, SIZE), filter=jax_gaussian_blur(sigma=1.0),
                       noise_model=jphys.GaussianNoise(noise))
    tp = tphys.BlurFFT((1, SIZE, SIZE), filter=gaussian_blur(sigma=1.0), device=DEV,
                       noise_model=tphys.GaussianNoise(noise, device=DEV))
    y = np.asarray(jp.A(jnp.asarray(x))) + noise * rng.standard_normal(x.shape).astype(np.float32)
    return y, jp, tp


def _sr(seed=2, noise=0.05, factor=2, batch=1, channels=1):
    rng = np.random.default_rng(seed)
    x = rng.random((batch, channels, SIZE, SIZE)).astype(np.float32)
    jp = jphys.Downsampling(img_size=(channels, SIZE, SIZE), filter="bicubic", factor=factor,
                            noise_model=jphys.GaussianNoise(noise))
    tp = tphys.Downsampling(img_size=(channels, SIZE, SIZE), filter="bicubic", factor=factor,
                            device=DEV, noise_model=tphys.GaussianNoise(noise, device=DEV))
    y = np.asarray(jp.A(jnp.asarray(x)))
    y = y + noise * rng.standard_normal(y.shape).astype(np.float32)
    return y, jp, tp


# -- diffusion samplers -------------------------------------------------------


@pytest.mark.parametrize("dtype,problem", [("f32", "inpainting"), ("f32", "blur"),
                                           ("bf16", "inpainting")])
def test_ddrm_matches_jax(drunets, dtype, problem):
    """DDRM over the port's DecomposablePhysics (Inpainting; BlurFFT, whose
    singular-value space is complex: complex draws) with n + 1 denoiser calls."""
    y, jp, tp = _inpainting() if problem == "inpainting" else _blur()
    jden, tden = _denoisers(drunets, dtype)
    n, key = 4, jax.random.key(3)
    sigmas = np.linspace(1, 0, n + 1)
    want = jsamp.DDRM(jden, sigmas=sigmas)(jnp.asarray(y), jp, key=key)
    ybar = jp.U_adjoint(jnp.asarray(y))
    draws = _first_then_steps(key, n, ybar.shape, ybar.dtype)
    calls = []
    hook = tden.register_forward_pre_hook(lambda m, a: calls.append(a[1]))
    with torch.no_grad():
        got = tsamp.DDRM(tden, sigmas=sigmas)(_t(y), tp, draws=draws)
    hook.remove()
    assert len(calls) == n + 1 and got.shape == want.shape
    assert _rel(got.numpy(), want) <= BOUND[dtype]


@pytest.mark.parametrize("dtype,problem", [("f32", "inpainting"), ("f32", "sr"),
                                           ("bf16", "sr")])
def test_diffpir_matches_jax(drunets, dtype, problem):
    """DiffPIR with max_iter - 1 denoiser calls, its data step the physics'
    closed-form prox. On super-resolution at the default lambda the first
    step's FFT polyphase prox runs at gamma ~7e5, where f32 rounding alone
    moves it by ~2% in both packages (test_torch_blur.py,
    test_polyphase_prox_is_ill_conditioned_at_large_gamma_in_both_packages),
    so the f32 comparison there takes lambda 1e4 (gamma <= ~500)."""
    y, jp, tp = _inpainting() if problem == "inpainting" else _sr()
    jden, tden = _denoisers(drunets, dtype)
    n, key = 5, jax.random.key(4)
    kw = {"lambda_": 1e4} if (problem, dtype) == ("sr", "f32") else {}
    want = jsamp.DiffPIR(jden, sigma=0.05, max_iter=n, **kw)(jnp.asarray(y), jp, key=key)
    draws = _first_then_steps(key, n - 1, want.shape)
    calls = []
    hook = tden.register_forward_pre_hook(lambda m, a: calls.append(a[1]))
    with torch.no_grad():
        got = tsamp.DiffPIR(tden, sigma=0.05, max_iter=n, **kw)(_t(y), tp, draws=draws)
    hook.remove()
    assert len(calls) == n - 1
    assert _rel(got.numpy(), want) <= BOUND[dtype]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_dps_matches_jax(drunets, dtype):
    """DPS on 2x bicubic super-resolution, one denoiser call and its backward
    a step, under ``torch.no_grad()`` as a caller would run it."""
    y, jp, tp = _sr()
    jden, tden = _denoisers(drunets, dtype)
    n, key = 4, jax.random.key(5)
    want = jsamp.DPS(jden, max_iter=n)(jnp.asarray(y), jp, key=key)
    draws = _first_then_steps(key, n, (1, 1, SIZE, SIZE))
    with torch.no_grad():
        got = tsamp.DPS(tden, max_iter=n)(_t(y), tp, draws=draws)
    assert _rel(got.numpy(), want) <= BOUND[dtype]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_dps_guidance_gradient_matches_jax(drunets, dtype, monkeypatch):
    """One step's guidance ``grad_x ||A(D(x)) - y||`` against
    ``jax.value_and_grad`` (1e-4 f32, 3e-2 bf16); the weights get no
    gradient, and K1's backward (bf16) is asked for ``dh`` alone."""
    y, jp, tp = _sr()
    jden, tden = _denoisers(drunets, dtype)
    at = 0.3
    x = np.random.default_rng(9).standard_normal((1, 1, SIZE, SIZE)).astype(np.float32)

    def loss(xt):
        sigma = jnp.sqrt(1 - at) / jnp.sqrt(at)
        x0 = 2 * jden((xt / jnp.sqrt(at) + 1) / 2, sigma / 2) - 1
        r = jp.A((x0 + 1) / 2) - jnp.asarray(y)
        return jnp.sqrt(jnp.sum(r ** 2)), x0

    (norm, x0_want), g_want = jax.jit(jax.value_and_grad(loss, has_aux=True))(jnp.asarray(x))
    asked = []
    f32_chain = rc_mod.resblocks_f32
    monkeypatch.setattr(rc_mod, "resblocks_f32", lambda *a: asked.append(
        [v.requires_grad for v in a]) or f32_chain(*a))
    params = list(tden.parameters())
    assert all(p.requires_grad and p.grad is None for p in params)
    g, x0, n = tsamp.DPS(tden, max_iter=4).guidance(_t(x), _t(y), tp, at)
    assert _rel(g.numpy(), g_want) <= (1e-4 if dtype == "f32" else 3e-2)
    assert _rel(x0.numpy(), x0_want) <= BOUND[dtype]
    assert abs(float(n) - float(norm)) <= BOUND[dtype] * float(norm)
    assert all(p.requires_grad and p.grad is None for p in params)  # flags restored
    assert asked == ([] if dtype == "f32" else [[True, False, False]])


def test_dps_score_matches_jax(drunets):
    y, jp, tp = _sr()
    jden, tden = drunets
    x = np.random.default_rng(10).standard_normal((1, 1, SIZE, SIZE)).astype(np.float32)
    jm = jsamp.DPS(jden, max_iter=4)
    want = jax.jit(lambda v: jm.score(jnp.asarray(y), jp, v, 500))(jnp.asarray(x))
    got = tsamp.DPS(tden, max_iter=4).score(_t(y), tp, _t(x), 500)
    assert _rel(got.numpy(), want) <= 1e-4


@pytest.fixture(scope="module")
def drunets_rgb():
    """A small 3-channel DRUNet in both packages, the same weights."""
    ref = JaxDRUNet(in_channels=3, out_channels=3, nc=NC, nb=1, key=jax.random.key(1))
    port = load_jax_params(DRUNet(in_channels=3, out_channels=3, nc=NC, nb=1, device=DEV),
                           jax_params(ref))
    return ref, port


@pytest.mark.parametrize("sampler", ["DDRM", "DiffPIR", "DPS", "PosteriorDiffusion"])
def test_batched_rgb_samplers_match_jax(drunets_rgb, sampler):
    """The samplers at B=2 on 3-channel images (the bench runs DDRM at B=8 in
    RGB), f32, within 1e-4 of JAX: DDRM and DiffPIR on inpainting, DPS and
    PosteriorDiffusion (VP) on 2x super-resolution, the batch's draws from
    the JAX key schedule."""
    jden, tden = drunets_rgb
    shape, n = (2, 3, SIZE, SIZE), 4
    key = jax.random.key(16)
    if sampler in ("DDRM", "DiffPIR"):
        y, jp, tp = _inpainting(seed=5, batch=2, channels=3)
    else:
        y, jp, tp = _sr(seed=6, batch=2, channels=3)
    if sampler == "DDRM":
        sigmas = np.linspace(1, 0, n + 1)
        want = jsamp.DDRM(jden, sigmas=sigmas)(jnp.asarray(y), jp, key=key)
        ybar = jp.U_adjoint(jnp.asarray(y))
        with torch.no_grad():
            got = tsamp.DDRM(tden, sigmas=sigmas)(
                _t(y), tp, draws=_first_then_steps(key, n, ybar.shape, ybar.dtype))
    elif sampler == "DiffPIR":
        want = jsamp.DiffPIR(jden, sigma=0.05, max_iter=n)(jnp.asarray(y), jp, key=key)
        with torch.no_grad():
            got = tsamp.DiffPIR(tden, sigma=0.05, max_iter=n)(
                _t(y), tp, draws=_first_then_steps(key, n - 1, shape))
    elif sampler == "DPS":
        want = jsamp.DPS(jden, max_iter=n)(jnp.asarray(y), jp, key=key)
        with torch.no_grad():
            got = tsamp.DPS(tden, max_iter=n)(_t(y), tp, draws=_first_then_steps(key, n, shape))
    else:
        ts = np.linspace(1.0, 0.05, n)

        def make(pkg, den):
            return pkg.PosteriorDiffusion(pkg.VariancePreservingDiffusion(den),
                                          pkg.DPSDataFidelity(den, clip=(-1, 2)), timesteps=ts)

        want = make(jsamp, jden)(jnp.asarray(y), jp, key=key)
        kp, ks = jax.random.split(ensure_key(key))
        draws = [np.asarray(jax.random.normal(kp, shape))] + _solver_draws(ks, n - 1, shape)
        got = make(tsamp, tden)(_t(y), tp, draws=draws).detach()
    assert got.shape == shape and _rel(got.numpy(), want) <= 1e-4


# -- Langevin samplers --------------------------------------------------------


def _chain_draws(key, n, shape):
    return _normals(jax.random.split(ensure_key(key), n), shape)


@pytest.mark.parametrize("algo", ["ULA", "SKRock"])
def test_langevin_matches_jax(algo):
    """ULA and SK-ROCK on deblurring with a ScorePrior, mean and variance."""
    y, jp, tp = _blur(noise=0.1)
    kw = dict(step_size=0.01, sigma=0.1, max_iter=12, thinning=2, burnin_ratio=0.25)
    if algo == "SKRock":
        kw.update(inner_iter=4, eta=0.05)
    key = jax.random.key(6)
    jm = getattr(jsamp, algo)(jopt.ScorePrior(_Gaussian()), jopt.L2(sigma=0.1), **kw)
    tm = getattr(tsamp, algo)(topt.ScorePrior(_Gaussian()), topt.L2(sigma=0.1), **kw)
    mean_w, var_w = jm.sample(jnp.asarray(y), jp, key=key)
    mean, var = tm.sample(_t(y), tp, draws=_chain_draws(key, 12, y.shape))
    assert _rel(mean.numpy(), mean_w) <= 1e-4 and _rel(var.numpy(), var_w) <= 1e-4
    assert len(tm.get_chain()) == len(jm.get_chain()) == 5
    for a, b in zip(tm.get_chain(), jm.get_chain()):
        assert _rel(a.numpy(), b) <= 1e-4
    assert (tm.mean_has_converged(), tm.var_has_converged()) == (
        jm.mean_has_converged(), jm.var_has_converged())


def test_ula_with_drunet_matches_jax(drunets):
    """ULA's ScorePrior over the small DRUNet (one call a step)."""
    y, jp, tp = _blur(noise=0.1)
    jden, tden = drunets
    kw = dict(step_size=1e-3, sigma=0.1, max_iter=4, thinning=1, burnin_ratio=0.0)
    key = jax.random.key(8)
    mean_w, _ = jsamp.ULA(jopt.ScorePrior(jden), jopt.L2(sigma=0.1), **kw).sample(
        jnp.asarray(y), jp, key=key)
    with torch.no_grad():
        mean, _ = tsamp.ULA(topt.ScorePrior(tden), topt.L2(sigma=0.1), **kw).sample(
            _t(y), tp, draws=_chain_draws(key, 4, y.shape))
    assert _rel(mean.numpy(), mean_w) <= 1e-4


def test_ula_recovers_the_gaussian_posterior():
    """With a Gaussian prior and likelihood ULA's mean and variance approach
    the analytic posterior's (tests/test_sampling.py:44), drawn from a torch
    generator."""
    sigma_noise, mu, tau = 0.3, 0.3, 0.5
    physics = tphys.Denoising(noise_model=tphys.GaussianNoise(sigma_noise, device=DEV))
    y = physics(torch.full((1, 1, 8, 8), 0.7), generator=torch.Generator().manual_seed(0))
    sampler = tsamp.ULA(topt.ScorePrior(_Gaussian(mu, tau)), topt.L2(sigma=sigma_noise),
                        step_size=0.01, sigma=1e-3, max_iter=5000, thinning=1, burnin_ratio=0.3,
                        clip=None)
    mean, var = sampler.sample(y, physics, generator=torch.Generator().manual_seed(1))
    post_mean = (mu / tau ** 2 + y / sigma_noise ** 2) / (1 / tau ** 2 + 1 / sigma_noise ** 2)
    post_var = 1.0 / (1 / tau ** 2 + 1 / sigma_noise ** 2)
    assert float((mean - post_mean).abs().max()) < 0.1
    assert abs(float(var.mean()) - post_var) / post_var < 0.5


def test_sampling_builder_welford_and_history():
    """``sampling_builder`` by name and by iterator, unknown names, the
    history's size (int, True, False), and ``Welford`` against numpy."""
    prior, df = topt.ScorePrior(_Gaussian()), topt.L2(sigma=0.1)
    s = tsamp.sampling_builder("skrock", df, prior, {"step_size": 1e-3}, max_iter=7)
    assert isinstance(s.iterator, tsamp.SKROCKIterator) and s.max_iter == 7
    it = tsamp.ULAIterator({"step_size": 1e-3})
    assert tsamp.sampling_builder(it, df, prior).iterator is it
    with pytest.raises(ValueError):
        tsamp.sampling_builder("mala", df, prior)
    physics = tphys.Denoising(noise_model=tphys.GaussianNoise(0.1, device=DEV))
    y = torch.full((1, 1, 4, 4), 0.5)
    for hs, n in ((3, 3), (True, 8), (False, 0)):
        s = tsamp.ULA(prior, df, step_size=1e-3, max_iter=10, thinning=1, burnin_ratio=0.2,
                      history_size=hs)
        mean, _ = s.sample(y, physics, generator=torch.Generator().manual_seed(0))
        if hs is False:
            with pytest.raises(RuntimeError):
                s.get_chain()
        else:
            assert len(s.get_chain()) == n
        if hs is True:  # every sample kept: the running mean is their mean
            assert torch.allclose(torch.stack(s.get_chain()).mean(0), mean, atol=1e-6)
    xs = np.random.default_rng(0).standard_normal((6, 2, 3)).astype(np.float32)
    w = tsamp.Welford(_t(xs[0]))
    for v in xs[1:]:
        w.update(_t(v))
    assert np.allclose(w.mean().numpy(), xs.mean(0), atol=1e-6)
    assert np.allclose(w.var().numpy(), xs.var(0, ddof=1), atol=1e-6)
    out = tsamp.SDEOutput(torch.zeros(1), nfe=3)
    assert out["nfe"] == out.nfe == 3
    assert torch.equal(tsamp.projbox(torch.tensor([-2.0, 0.5, 3.0]), 0, 1),
                       torch.tensor([0.0, 0.5, 1.0]))


def test_diffusion_sampler_matches_jax():
    """DiffusionSampler: Welford moments over repeated DDRM runs, the draws
    of every run in order."""
    y, jp, tp = _inpainting(seed=4)
    n, runs, key = 3, 3, jax.random.key(12)
    sigmas = np.linspace(1, 0, n + 1)
    jm = jsamp.DiffusionSampler(jsamp.DDRM(_Gaussian(), sigmas=sigmas), max_iter=runs,
                                save_chain=True)
    mean_w, var_w = jm.sample(jnp.asarray(y), jp, key=key)
    draws = [d for k in jax.random.split(ensure_key(key), runs)
             for d in _first_then_steps(k, n, y.shape)]
    tm = tsamp.DiffusionSampler(tsamp.DDRM(_Gaussian(), sigmas=sigmas), max_iter=runs,
                                save_chain=True)
    mean, var = tm.sample(_t(y), tp, draws=draws)
    assert _rel(mean.numpy(), mean_w) <= 1e-4 and _rel(var.numpy(), var_w) <= 1e-4
    assert len(tm.get_chain()) == runs


# -- SDE samplers -------------------------------------------------------------


def _solver_draws(key, n, shape):
    return _normals(jax.random.split(ensure_key(key), n), shape)


@pytest.mark.parametrize("sde,solver", [("VE", "EulerSolver"), ("VE", "HeunSolver"),
                                        ("VP", "EulerSolver"), ("VP", "HeunSolver"),
                                        ("EDM-VP", "HeunSolver"), ("Song-VP", "EulerSolver")])
def test_sde_samples_match_jax(sde, solver):
    """Reverse-time samples of each SDE with the Gaussian prior's denoiser."""
    den = _Gaussian(0.0, 1.0)
    make = {
        "VE": lambda pkg: pkg.VarianceExplodingDiffusion(den, sigma_max=5.0),
        "VP": lambda pkg: pkg.VariancePreservingDiffusion(den),
        "EDM-VP": lambda pkg: pkg.EDMDiffusionSDE(
            sigma_t=lambda t: 0.02 * (250.0 ** t), variance_preserving=True, denoiser=den),
        "Song-VP": lambda pkg: pkg.SongDiffusionSDE(variance_preserving=True, denoiser=den,
                                                    n_quad=65),
    }[sde]
    ts = np.linspace(1.0, 1e-2, 9)
    shape, key = (1, 1, 8, 8), jax.random.key(13)
    x0 = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    want = getattr(jsamp, solver)(ts).sample(make(jsamp), jnp.asarray(x0), key=key)
    got = getattr(tsamp, solver)(ts).sample(make(tsamp), _t(x0),
                                            draws=_solver_draws(key, 8, shape))
    assert _rel(got.numpy(), want) <= 1e-4


def test_edm_schedules_and_derivatives_match_jax():
    """sigma, scale and their autograd derivatives, drift, diffusion and the
    prior's scale of the EDM, Song and flow-matching SDEs, on the host."""
    den = _Gaussian(0.0, 1.0)
    pairs = [(pkg.SongDiffusionSDE(variance_preserving=True, denoiser=den, n_quad=65),
              pkg.EDMDiffusionSDE(sigma_t=lambda t: 0.5 + t ** 2, variance_exploding=True,
                                  denoiser=den),
              pkg.FlowMatching(den)) for pkg in (jsamp, tsamp)]
    x = np.random.default_rng(4).standard_normal((1, 1, 4, 4)).astype(np.float32)
    for j, p in zip(*pairs):
        for t in (0.1, 0.5, 0.9):
            for name in ("sigma_t", "scale_t", "sigma_prime_t", "scale_prime_t"):
                assert abs(float(getattr(p, name)(t)) - float(getattr(j, name)(t))) <= 1e-4 * (
                    1 + abs(float(getattr(j, name)(t))))
            assert _rel(p.drift(_t(x), torch.tensor(t, dtype=torch.float64)).numpy(),
                        j.drift(jnp.asarray(x), t)) <= 1e-4
            assert abs(float(p.diffusion(t)) - float(j.diffusion(t))) <= 1e-4 * (
                1 + float(j.diffusion(t)))


def test_flow_matching_matches_jax():
    den = _Gaussian(0.2, 0.7)
    ts = np.linspace(0.99, 0.0, 11)
    key, shape = jax.random.key(14), (1, 1, 6, 6)
    x0 = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    want = jsamp.FlowMatching(den, timesteps=ts).sample(jnp.asarray(x0), key=key)
    fm = tsamp.FlowMatching(den, timesteps=ts)
    got = fm.sample(_t(x0), draws=_solver_draws(key, 10, shape))
    assert _rel(got.numpy(), want) <= 1e-4
    assert _rel(fm.velocity(_t(x0), 0.5).numpy(),
                jsamp.FlowMatching(den, timesteps=ts).velocity(jnp.asarray(x0), 0.5)) <= 1e-4


@pytest.mark.parametrize("sde", ["VP"])
def test_posterior_diffusion_matches_jax(drunets, sde):
    """PosteriorDiffusion with DPSDataFidelity over the small DRUNet on 2x
    super-resolution: the prior draw, then one draw a step; the weights get
    no gradient."""
    y, jp, tp = _sr()
    jden, tden = drunets
    ts = np.linspace(1.0, 0.05, 4)

    def make(pkg, den):
        s = (pkg.VariancePreservingDiffusion(den) if sde == "VP"
             else pkg.VarianceExplodingDiffusion(den, sigma_max=2.0))
        return pkg.PosteriorDiffusion(s, pkg.DPSDataFidelity(den, clip=(-1, 2)), timesteps=ts)

    key = jax.random.key(15)
    want = make(jsamp, jden)(jnp.asarray(y), jp, key=key)
    kp, ks = jax.random.split(ensure_key(key))
    draws = [np.asarray(jax.random.normal(kp, (1, 1, SIZE, SIZE)))] + _solver_draws(
        ks, 3, (1, 1, SIZE, SIZE))
    got = make(tsamp, tden)(_t(y), tp, draws=draws)
    assert _rel(got.detach().numpy(), want) <= 1e-4
    assert all(p.grad is None and p.requires_grad for p in tden.parameters())
    x = np.random.default_rng(6).standard_normal((1, 1, SIZE, SIZE)).astype(np.float32)
    assert _rel(make(tsamp, tden).score(_t(y), tp, _t(x), 0.5).detach().numpy(),
                make(jsamp, jden).score(jnp.asarray(y), jp, jnp.asarray(x), 0.5)) <= 1e-4


def test_noisy_data_fidelity_matches_jax():
    y, jp, tp = _sr()
    x = np.random.default_rng(7).random((1, 1, SIZE, SIZE)).astype(np.float32)
    want = jsamp.NoisyDataFidelity(weight=0.5).grad(jnp.asarray(x), jnp.asarray(y), jp)
    got = tsamp.NoisyDataFidelity(weight=0.5).grad(_t(x), _t(y), tp)
    assert _rel(got.numpy(), want) <= 1e-5


def test_solver_generator_and_draws():
    """The solver's own generator advances between draws and resets; a
    sampler given fewer draws than it takes raises; the same generator seed
    gives the same sample."""
    solver = tsamp.EulerSolver(np.linspace(1, 0.1, 5), rng_seed=3)
    x = torch.zeros((2, 3))
    a, b = solver.randn_like(x), solver.randn_like(x)
    assert not torch.equal(a, b)
    assert torch.equal(solver.reset_rng().randn_like(x), a)
    assert not torch.equal(solver.rng_manual_seed("other").randn_like(x), a)
    sde = tsamp.VarianceExplodingDiffusion(_Gaussian(0.0, 1.0))
    with pytest.raises(ValueError, match="more draws"):
        solver.sample(sde, x, draws=[np.zeros((2, 3))])
    run = [solver.sample(sde, x, generator=torch.Generator().manual_seed(1)) for _ in range(2)]
    assert torch.equal(*run)


def test_default_path_needs_cuda():
    """Without a device the samplers' inputs go to the CUDA device: where
    there is none the entry points raise, naming ``device="cpu"``."""
    sde = tsamp.VarianceExplodingDiffusion(_Gaussian(0.0, 1.0))
    if torch.cuda.is_available():
        assert sde.prior_sample((1, 1, 4, 4)).is_cuda
        return
    for make in (lambda: sde.prior_sample((1, 1, 4, 4)),
                 lambda: tphys.Inpainting((1, 4, 4), mask=0.5),
                 lambda: DRUNet(in_channels=1, out_channels=1, nc=NC, nb=1)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            make()
