"""The port's noise models against the JAX package's, on the CPU.

Keys and generators never draw the same numbers, so each JAX model's draws
are computed with its own key schedule (``noise.py``: one key a draw, split
``(ks, kn)``, ``(kp, kn)``, ``(k1, k2)``, and ``_ChainedNoise`` giving ``k2``
to the inner model) and passed into the port through ``draws=``; the outputs
then agree within 1e-6 (relative and absolute). For the Poisson and gamma
laws the draw is the variate itself. The port's own draws (its
``torch.Generator``) are held by their first two moments against the
analytic ones from ``scipy``: the mean within 5 standard errors, the
variance within 3% relative, over 2^18 samples.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special as sps
import scipy.stats as st
import torch

import deepinv_tpu.physics.noise as jn
import deepinv_tpu_torch.physics.noise as tn
from deepinv_tpu.physics import Denoising as JDenoising
from deepinv_tpu_torch.physics import Denoising

DEV = "cpu"
B, SHAPE = 2, (2, 3, 8, 9)
PER_SAMPLE = np.array([0.05, 0.2], np.float32)
# the (B,) values of each per-sample keyword
BATCHED = {"sigma": PER_SAMPLE, "gain": PER_SAMPLE, "a": PER_SAMPLE, "s": PER_SAMPLE,
           "b": PER_SAMPLE, "l": np.array([1.5, 4.0], np.float32),
           "N0": np.array([256.0, 1024.0], np.float32)}

# name -> (constructor keywords with scalar values, the keyword that takes a (B,) tensor)
MODELS = {
    "ZeroNoise": ({}, None),
    "GaussianNoise": ({"sigma": 0.1}, "sigma"),
    "UniformGaussianNoise": ({"sigma_min": 0.05, "sigma_max": 0.3}, None),
    "PoissonNoise": ({"gain": 0.1}, "gain"),
    "GammaNoise": ({"l": 3.0}, "l"),
    "PoissonGaussianNoise": ({"gain": 0.1, "sigma": 0.05}, "gain"),
    "UniformNoise": ({"a": 0.2}, "a"),
    "LogPoissonNoise": ({"N0": 512.0, "mu": 0.5}, "N0"),
    "SaltPepperNoise": ({"p": 0.1, "s": 0.15}, "s"),
    "FisherTippettNoise": ({"l": 2.0}, "l"),
    "RicianNoise": ({"sigma": 0.1}, "sigma"),
    "LaplaceNoise": ({"b": 0.1}, "b"),
}


def _bc(p, y):
    p = jnp.asarray(p)
    return p if p.ndim == 0 else p.reshape(p.shape + (1,) * (y.ndim - 1))


def jax_draws(model, y, key):
    """The draws the JAX ``model`` takes from ``key`` on ``y``, in order."""
    name = type(model).__name__
    if name == "_ChainedNoise":
        k1, k2 = jax.random.split(key)
        inner = jax_draws(model.inner, y, k2)
        return inner + jax_draws(model.outer, model.inner(y, key=k2), k1)
    if name == "ZeroNoise":
        return []
    if name == "GaussianNoise":
        if jnp.iscomplexobj(y):
            kr, ki = jax.random.split(key)
            return [jax.random.normal(k, y.shape, y.real.dtype) for k in (kr, ki)]
        return [jax.random.normal(key, y.shape, y.dtype)]
    if name == "UniformGaussianNoise":
        ks, kn = jax.random.split(key)
        return [jax.random.uniform(ks, (y.shape[0],), y.dtype),
                jax.random.normal(kn, y.shape, y.dtype)]
    if name in ("PoissonNoise", "PoissonGaussianNoise"):
        rate = y / _bc(model.gain, y)
        if model.clip_positive:
            rate = jnp.clip(rate, 0.0, None)
        if name == "PoissonNoise":
            return [jax.random.poisson(key, rate, y.shape)]
        kp, kn = jax.random.split(key)
        return [jax.random.poisson(kp, rate, y.shape), jax.random.normal(kn, y.shape, y.dtype)]
    if name in ("GammaNoise", "FisherTippettNoise"):
        return [jax.random.gamma(key, jnp.broadcast_to(_bc(model.l, y), y.shape).astype(y.dtype))]
    if name in ("UniformNoise", "SaltPepperNoise"):
        return [jax.random.uniform(key, y.shape, y.dtype)]
    if name == "LogPoissonNoise":
        return [jax.random.poisson(key, _bc(model.N0, y) * jnp.exp(-y * _bc(model.mu, y)),
                                   y.shape)]
    if name == "RicianNoise":
        k1, k2 = jax.random.split(key)
        return [jax.random.normal(k, y.shape, y.dtype) for k in (k1, k2)]
    if name == "LaplaceNoise":
        return [jax.random.laplace(key, y.shape, y.dtype)]
    raise KeyError(name)


def _pair(name, per_sample):
    kw, batched = MODELS[name]
    kw = dict(kw)
    if per_sample:
        kw[batched] = BATCHED[batched]
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    tkw = {k: torch.as_tensor(v) for k, v in kw.items()}
    return getattr(jn, name)(**jkw), getattr(tn, name)(**tkw, **({"device": DEV} if kw else {}))


def _input(seed=0, positive=True):
    y = np.random.default_rng(seed).random(SHAPE).astype(np.float32)
    return y + 0.1 if positive else y - 0.5


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


CASES = [(n, False) for n in MODELS] + [(n, True) for n, (_, b) in MODELS.items() if b]


@pytest.mark.parametrize("name,per_sample", CASES)
def test_noise_matches_jax_from_the_same_draws(name, per_sample):
    """Each model, scalar and per-sample ``(B,)`` parameters, from the JAX
    draws."""
    jm, tm = _pair(name, per_sample)
    y = _input(3)
    key = jax.random.key(11)
    want = jm(jnp.asarray(y), key=key)
    draws = [np.asarray(d) for d in jax_draws(jm, jnp.asarray(y), key)]
    _close(tm(torch.from_numpy(y), draws=draws), want)


def test_complex_gaussian_and_clip_positive_match_jax():
    """Circular complex Gaussian noise (a real and an imaginary draw), and
    Poisson noise of a negative rate clipped at 0, with and without the
    normalisation by the gain."""
    rng = np.random.default_rng(5)
    yc = (rng.standard_normal(SHAPE) + 1j * rng.standard_normal(SHAPE)).astype(np.complex64)
    key = jax.random.key(2)
    jm, tm = jn.GaussianNoise(0.3), tn.GaussianNoise(0.3, device=DEV)
    want = jm(jnp.asarray(yc), key=key)
    draws = [np.asarray(d) for d in jax_draws(jm, jnp.asarray(yc), key)]
    _close(tm(torch.from_numpy(yc), draws=draws), want)
    y = _input(6, positive=False)
    for normalize in (True, False):
        jm = jn.PoissonNoise(0.2, normalize=normalize, clip_positive=True)
        tm = tn.PoissonNoise(0.2, normalize=normalize, clip_positive=True, device=DEV)
        want = jm(jnp.asarray(y), key=key)
        _close(tm(torch.from_numpy(y), draws=[np.asarray(d) for d in
                                              jax_draws(jm, jnp.asarray(y), key)]), want)


@pytest.mark.parametrize("outer,inner", [("PoissonNoise", "GaussianNoise"),
                                         ("GaussianNoise", "SaltPepperNoise"),
                                         ("RicianNoise", "UniformGaussianNoise")])
def test_chained_noise_matches_jax(outer, inner):
    """``outer * inner``: the inner model draws first (from ``k2`` in the JAX
    package), then the outer."""
    jo, to = _pair(outer, False)
    ji, ti = _pair(inner, False)
    jm, tm = jo * ji, to * ti
    assert type(tm).__name__ == "_ChainedNoise"
    y = _input(7)
    key = jax.random.key(4)
    want = jm(jnp.asarray(y), key=key)
    draws = [np.asarray(d) for d in jax_draws(jm, jnp.asarray(y), key)]
    _close(tm(torch.from_numpy(y), draws=draws), want)


def test_gaussian_mul_update_and_rng():
    """``GaussianNoise``'s closed-form products, ``update`` and
    ``update_parameters`` (also through ``Physics.update`` with a ``(B,)``
    sigma), and the seed: calls without a generator repeat their draws,
    ``rng_manual_seed`` changes them and ``reset_rng`` keeps them."""
    merged = tn.GaussianNoise(0.3, device=DEV) * tn.GaussianNoise(0.4, device=DEV)
    want = jn.GaussianNoise(0.3) * jn.GaussianNoise(0.4)
    assert isinstance(merged, tn.GaussianNoise)
    assert abs(float(merged.sigma) - float(want.sigma)) <= 1e-7
    scaled = tn.GaussianNoise(0.3, device=DEV) * 2.0
    assert abs(float(scaled.sigma) - float((jn.GaussianNoise(0.3) * 2.0).sigma)) <= 1e-7
    m = tn.GaussianNoise(0.1, device=DEV)
    for upd in (m.update, m.update_parameters):
        new = upd(sigma=torch.tensor(0.2), unknown=1.0)
        assert float(new.sigma) == pytest.approx(0.2) and float(m.sigma) == pytest.approx(0.1)
    y = torch.from_numpy(_input(8))
    sig = torch.from_numpy(PER_SAMPLE)
    phys = Denoising(tn.GaussianNoise(0.1, device=DEV)).update(sigma=sig)
    jphys = JDenoising(jn.GaussianNoise(0.1)).update(sigma=jnp.asarray(PER_SAMPLE))
    key = jax.random.key(9)
    draws = [np.asarray(d) for d in jax_draws(jphys.noise_model, jnp.asarray(y.numpy()), key)]
    _close(phys.noise_model(y, draws=draws), jphys.noise_model(jnp.asarray(y.numpy()), key=key))
    assert torch.equal(m(y), m(y)) and torch.equal(m.reset_rng()(y), m(y))
    assert not torch.equal(m.rng_manual_seed(1)(y), m(y))
    assert torch.equal(m.rng_manual_seed(1)(y), m(y, generator=torch.Generator().manual_seed(1)))
    assert m.randn_like(y).shape == y.shape and float(m.rand_like(y).min()) >= 0.0


def _moments(name, kw, x):
    """The analytic mean and variance of model ``name`` at the level ``x``."""
    if name == "ZeroNoise":
        return x, 0.0
    if name == "GaussianNoise":
        return x, kw["sigma"] ** 2
    if name == "UniformGaussianNoise":
        a, b = kw["sigma_min"], kw["sigma_max"]
        return x, (b ** 3 - a ** 3) / (3 * (b - a))
    if name == "PoissonNoise":
        return x, kw["gain"] * x
    if name == "GammaNoise":
        return st.gamma(kw["l"], scale=x / kw["l"]).stats("mv")
    if name == "PoissonGaussianNoise":
        return x, kw["gain"] * x + kw["sigma"] ** 2
    if name == "UniformNoise":
        return st.uniform(x - kw["a"], 2 * kw["a"]).stats("mv")
    if name == "LogPoissonNoise":
        lam = kw["N0"] * np.exp(-x * kw["mu"])
        n = np.arange(0, int(lam + 40 * np.sqrt(lam)))
        f = -np.log(np.maximum(n, 1e-8) / kw["N0"]) / kw["mu"]
        pmf = st.poisson(lam).pmf(n)
        m = float((pmf * f).sum())
        return m, float((pmf * (f - m) ** 2).sum())
    if name == "SaltPepperNoise":
        p, s = kw["p"], kw["s"]
        m = (1 - p - s) * x + s
        return m, (1 - p - s) * x ** 2 + s - m ** 2
    if name == "FisherTippettNoise":
        return x + sps.digamma(kw["l"]) - np.log(kw["l"]), sps.polygamma(1, kw["l"])
    if name == "RicianNoise":
        return st.rice(x / kw["sigma"], scale=kw["sigma"]).stats("mv")
    if name == "LaplaceNoise":
        return st.laplace(x, kw["b"]).stats("mv")
    raise KeyError(name)


@pytest.mark.parametrize("name", list(MODELS))
def test_port_draws_have_the_analytic_moments(name):
    """The port's own draws (a seeded ``torch.Generator``: ``torch.poisson``
    and ``torch._standard_gamma`` take it) on a constant image of 2^18
    pixels: the sample mean within 5 standard errors and the variance within
    3% of ``scipy``'s."""
    kw = MODELS[name][0]
    x = 0.5
    m = getattr(tn, name)(**kw, **({"device": DEV} if kw else {}))
    # 2^14 samples of 4x4: UniformGaussianNoise draws a level a sample
    out = m(torch.full((1 << 14, 1, 4, 4), x), generator=torch.Generator().manual_seed(17))
    out = out.double().numpy().ravel()
    mean, var = (float(v) for v in _moments(name, kw, x))
    if var == 0.0:
        assert np.array_equal(out, np.full_like(out, x))
        return
    assert abs(out.mean() - mean) <= 5 * np.sqrt(var / out.size)
    assert abs(out.var() - var) <= 0.03 * var
