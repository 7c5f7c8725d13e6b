"""The port's classic denoisers against the JAX package's, on the CPU: TGV,
TV-L1, wavelet thresholding (soft, hard, top-k; per-level thresholds),
the wavelet dictionary, the median and bilateral filters, the Anscombe
wrapper and the generalized Anscombe pair, and ``WaveletPrior``'s prox on
db4 and haar.

Inputs from numpy seeds, f32; bounds are the max abs error over the
reference's max: 1e-5 for one pass, 1e-4 for the primal-dual loops.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepinv_tpu.models as JM
import deepinv_tpu.optim as J
import deepinv_tpu_torch.models as TM
import deepinv_tpu_torch.optim as T


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _np(t):
    return t.detach().numpy()


def _img(shape=(2, 1, 15, 18), seed=0, noise=0.1):
    rng = np.random.default_rng(seed)
    x = np.zeros(shape, np.float32)
    x[..., shape[-2] // 3:, shape[-1] // 2:] = 1.0
    return (x + noise * rng.standard_normal(shape)).astype(np.float32)


def _pair(jden, tden, x, tol, *args):
    want = jden(jnp.asarray(x), *args)
    got = tden(torch.from_numpy(x), *args)
    assert got.shape == tuple(want.shape)
    assert _rel(_np(got), want) <= tol


def test_tgv_matches_jax():
    x = _img()
    _pair(JM.TGVDenoiser(n_it_max=20), TM.TGVDenoiser(n_it_max=20), x, 1e-4, 0.1)
    v = np.random.default_rng(1).standard_normal((2, 1, 15, 18, 2)).astype(np.float32)
    e = TM.TGVDenoiser.epsilon(torch.from_numpy(v))
    assert _rel(_np(e), JM.TGVDenoiser.epsilon(jnp.asarray(v))) <= 1e-6
    assert _rel(_np(TM.TGVDenoiser.epsilon_adjoint(e)),
                JM.TGVDenoiser.epsilon_adjoint(jnp.asarray(_np(e)))) <= 1e-6
    assert _rel(_np(TM.TGVDenoiser().prox_tau_fr(torch.from_numpy(v), 2.0)),
                JM.TGVDenoiser().prox_tau_fr(jnp.asarray(v), 2.0)) <= 1e-6


def test_tvl1_matches_jax():
    x = _img(seed=2)
    x[0, 0, 3, 4] = 5.0     # an outlier, the TV-L1 case
    _pair(JM.TVL1Denoiser(n_it_max=30), TM.TVL1Denoiser(n_it_max=30), x, 1e-4, 0.2)


@pytest.mark.parametrize("wv,level,nl,ths", [
    ("db4", 2, "soft", 0.1), ("haar", 3, "hard", 0.2), ("db2", 2, "topk", 0.25),
    ("db4", 2, "soft", [[0.05, 0.1, 0.15], [0.2, 0.25, 0.3]]), ("db8", 1, "soft", [0.1, 0.2, 0.3])])
def test_wavelet_denoiser_matches_jax(wv, level, nl, ths):
    x = _img(seed=3)
    jd = JM.WaveletDenoiser(wv=wv, level=level, non_linearity=nl)
    td = TM.WaveletDenoiser(wv=wv, level=level, non_linearity=nl)
    want = jd(jnp.asarray(x), jnp.asarray(ths) if isinstance(ths, list) else ths)
    got = td(torch.from_numpy(x), torch.tensor(ths) if isinstance(ths, list) else ths)
    assert _rel(_np(got), want) <= 1e-5


def test_wavelet_dictionary_and_helpers_match_jax():
    x = _img(seed=4)
    _pair(JM.WaveletDictDenoiser(level=2), TM.WaveletDictDenoiser(level=2), x, 1e-5, 0.1)
    jd, td = JM.WaveletDenoiser(level=2), TM.WaveletDenoiser(level=2)
    xp, pad = td.pad_input(torch.from_numpy(x))
    assert pad == (1, 0) and tuple(xp.shape[-2:]) == (16, 18)
    assert _rel(_np(td.flatten_coeffs(td.dwt(xp))),
                jd.flatten_coeffs(jd.dwt(jnp.asarray(_np(xp))))) <= 1e-5
    for a, b in zip(TM.WaveletDictDenoiser.psi(xp), JM.WaveletDictDenoiser.psi(jnp.asarray(_np(xp)))):
        assert _rel(_np(a), b) <= 1e-5


@pytest.mark.parametrize("k", [3, 5])
def test_median_filter_matches_jax(k):
    _pair(JM.MedianFilter(k), TM.MedianFilter(k), _img(seed=5), 0.0)


def test_bilateral_filter_matches_jax():
    x = _img(seed=6)
    _pair(JM.BilateralFilter(), TM.BilateralFilter(), x, 1e-5)
    _pair(JM.BilateralFilter(kernel_size=3, sigma_space=1.0), TM.BilateralFilter(3, 1.0), x,
          1e-5, 0.3)


def test_anscombe_matches_jax():
    rng = np.random.default_rng(7)
    x = (0.5 * rng.poisson(np.full((1, 1, 16, 16), 6.0))).astype(np.float32)
    _pair(JM.AnscombeDenoiser(JM.MedianFilter(3), gain=0.5),
          TM.AnscombeDenoiser(TM.MedianFilter(3), gain=0.5), x, 1e-5)
    for kw in ({}, {"gain": 0.5, "sigma": 0.1, "mu": 0.05}):
        z = TM.generalized_anscombe_transform(torch.from_numpy(x), **kw)
        assert _rel(_np(z), JM.generalized_anscombe_transform(jnp.asarray(x), **kw)) <= 1e-6
        back = TM.inverse_generalized_anscombe_transform(z, **kw)
        assert _rel(_np(back), JM.inverse_generalized_anscombe_transform(jnp.asarray(_np(z)),
                                                                         **kw)) <= 1e-6


@pytest.mark.parametrize("wv", ["db4", "haar"])
def test_wavelet_prior_prox_matches_jax(wv):
    """``WaveletPrior``: the prox soft-thresholds the details of the
    orthonormal DWT (the exact prox), and its cost; also the denoiser's
    equality with the prox at the same threshold."""
    x = _img((2, 2, 16, 16), seed=8)
    jp, tp = J.WaveletPrior(wv=wv, level=2), T.WaveletPrior(wv=wv, level=2)
    got = tp.prox(torch.from_numpy(x), gamma=0.15)
    assert _rel(_np(got), jp.prox(jnp.asarray(x), gamma=0.15)) <= 1e-5
    assert _rel(_np(tp.fn(torch.from_numpy(x))), jp.fn(jnp.asarray(x))) <= 1e-5
    den = TM.WaveletDenoiser(wv=wv, level=2)(torch.from_numpy(x), 0.15)
    assert _rel(_np(den), _np(got)) <= 1e-5
