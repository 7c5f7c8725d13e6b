"""The port's patch priors against the JAX package's, on the CPU: the patch
extractor, the Gaussian mixture (densities with JAX's parameters crossed,
and an EM fit from JAX's starting points, handed in by ``draws=``), EPLL
denoising with JAX's fitted mixture crossed, ``PatchPrior``, and ``PatchNR``
with its coupling weights crossed by name.

f32; bounds are the max abs error over the reference's max: 1e-5 for the
densities and the flow, 1e-4 for EM and EPLL (solves and iterations).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import deepinv_tpu.optim as J
import deepinv_tpu_torch.optim as T
from deepinv_tpu.core.rng import ensure_key
from deepinv_tpu_torch.models import load_jax_params
from test_torch_drunet import DEV, jax_params


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _np(t):
    return t.detach().numpy()


def _images(n=4, size=16, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    imgs = []
    for _ in range(n):
        cy, cx, r = rng.uniform(4, size - 4, 2).tolist() + [rng.uniform(2, 5)]
        imgs.append((((yy - cy) ** 2 + (xx - cx) ** 2) < r ** 2).astype(np.float32))
    return np.stack(imgs)[:, None]


def _fitted(k=3, p=3, seed=1):
    """A JAX mixture fitted on patches of circles, and those patches."""
    flat = np.asarray(J.patch_extractor(jnp.asarray(_images()), p)[0]).reshape(-1, p * p)
    flat = flat + 0.01 * np.random.default_rng(seed).standard_normal(flat.shape).astype(np.float32)
    gmm = J.GaussianMixtureModel(k, p * p, seed=seed).fit(jnp.asarray(flat), max_iters=8)
    return gmm, flat


def test_patch_extractor_matches_jax():
    x = np.random.default_rng(2).standard_normal((2, 3, 9, 11)).astype(np.float32)
    for p, s in ((3, 1), (4, 2)):
        want, wgrid = J.patch_extractor(jnp.asarray(x), p, stride=s)
        got, grid = T.patch_extractor(torch.from_numpy(x), p, stride=s)
        assert tuple(grid) == tuple(int(v) for v in wgrid) and _rel(_np(got), want) == 0.0


def test_gmm_densities_match_jax():
    jg, flat = _fitted()
    tg = load_jax_params(T.GaussianMixtureModel(3, 9, device=DEV), jax_params(jg))
    pts = torch.from_numpy(flat[:50])
    assert _rel(_np(tg.log_prob_components(pts)), jg.log_prob_components(jnp.asarray(flat[:50]))) \
        <= 1e-5
    assert _rel(_np(tg.log_prob(pts)), jg.log_prob(jnp.asarray(flat[:50]))) <= 1e-5
    assert np.array_equal(_np(tg.classify(pts)), np.asarray(jg.classify(jnp.asarray(flat[:50]))))


def test_gmm_em_fit_from_the_same_start_matches_jax():
    """EM from JAX's starting means (its ``jax.random.choice`` with the fit's
    default key, handed in by ``draws=``), 8 iterations."""
    _, flat = _fitted()
    jg = J.GaussianMixtureModel(3, 9, seed=4).fit(jnp.asarray(flat), max_iters=8)
    idx = np.asarray(jax.random.choice(ensure_key(None, 1), flat.shape[0], (3,), replace=False))
    tg = T.GaussianMixtureModel(3, 9, draws=[np.asarray(J.GaussianMixtureModel(3, 9, seed=4).mu)],
                                device=DEV)
    tg.fit(torch.from_numpy(flat), max_iters=8, draws=[idx])
    for name in ("mu", "cov", "weights"):
        assert _rel(_np(getattr(tg, name)), getattr(jg, name)) <= 1e-4, name
    # the port's own draws: a fit from its generator's start is a proper mixture
    own = T.GaussianMixtureModel(3, 9, generator=torch.Generator().manual_seed(0), device=DEV)
    own.fit(torch.from_numpy(flat), max_iters=5, generator=torch.Generator().manual_seed(1))
    assert abs(float(own.weights.sum()) - 1.0) < 1e-5 and torch.isfinite(own.cov).all()


def test_gmm_fit_keeps_rank_deficient_covariances_positive_definite():
    """Points spanning 3 of 36 dimensions, as patches of piecewise-constant
    images do: the EM's covariances stay positive definite and the fit
    finite. The
    Gram matrix is summed in float64: summed in float32 it fell below 0 (on
    the card at demo_patch_priors' patches, here at 3x their scale), and the
    next step's Cholesky raised. The JAX package, in float32, gives NaN on
    these points."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((6000, 3)) * 3).astype(np.float32) @ rng.standard_normal(
        (3, 36)).astype(np.float32)
    jg = J.GaussianMixtureModel(2, 36, seed=0).fit(jnp.asarray(x), max_iters=3)
    assert not np.isfinite(np.asarray(jg.cov)).all()
    tg = T.GaussianMixtureModel(2, 36, device=DEV).fit(torch.from_numpy(x), max_iters=3,
                                                        draws=[np.arange(2)])
    assert torch.isfinite(tg.mu).all() and torch.isfinite(tg.cov).all()
    assert float(torch.linalg.eigvalsh(tg.cov.double()).min()) > 0


def test_epll_matches_jax():
    """EPLL denoising and its negative log-likelihood with JAX's fitted
    mixture crossed into the port."""
    jg, _ = _fitted()
    tg = load_jax_params(T.GaussianMixtureModel(3, 9, device=DEV), jax_params(jg))
    je, te = J.EPLL(gmm=jg, patch_size=3), T.EPLL(gmm=tg, patch_size=3, device=DEV)
    x = _images(2, seed=5)
    y = x + 0.1 * np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)
    got = te(torch.from_numpy(y), 0.1)
    assert _rel(_np(got), je(jnp.asarray(y), 0.1)) <= 1e-4
    assert _rel(_np(te.negative_log_likelihood(torch.from_numpy(y))),
                je.negative_log_likelihood(jnp.asarray(y))) <= 1e-5
    pp = J.PatchPrior(jg.log_prob, patch_size=3, n_patches=40)
    tp = T.PatchPrior(tg.log_prob, patch_size=3, n_patches=40)
    assert _rel(_np(tp.fn(torch.from_numpy(y))), pp.fn(jnp.asarray(y))) <= 1e-5


def test_patchnr_matches_jax():
    """The flow with random (nonzero) last layers crossed from JAX: forward,
    log-determinant, inverse, the patch NLL and the prior's cost; then a few
    steps of the port's own fit lower the NLL."""
    jn = J.PatchNR(patch_size=3, n_layers=3, hidden=16, key=jax.random.key(8))
    for i, layer in enumerate(jn.layers):
        w = jax.random.normal(jax.random.key(20 + i), layer.l3.weight.shape) * 0.1
        layer.l3 = layer.l3.replace(weight=w)
    tn = load_jax_params(T.PatchNR(patch_size=3, n_layers=3, hidden=16, device=DEV),
                         jax_params(jn))
    z = np.random.default_rng(9).standard_normal((20, 9)).astype(np.float32)
    jz, jld = jn.flow_forward(jnp.asarray(z))
    tz, tld = tn.flow_forward(torch.from_numpy(z))
    assert _rel(_np(tz), jz) <= 1e-5 and _rel(_np(tld), jld) <= 1e-5
    assert _rel(_np(tn.flow_inverse(tz)), z) <= 1e-5
    assert _rel(_np(tn.nll(torch.from_numpy(z))), jn.nll(jnp.asarray(z))) <= 1e-5
    x = _images(2, seed=10)
    assert _rel(_np(tn.fn(torch.from_numpy(x))), jn.fn(jnp.asarray(x))) <= 1e-5
    flat = T.patch_extractor(torch.from_numpy(_images()), 3)[0].reshape(-1, 9)
    before = float(tn.nll(flat).mean())
    tn.fit(flat, n_steps=20, lr=1e-2, batch_size=64, generator=torch.Generator().manual_seed(0))
    assert float(tn.nll(flat).mean()) < before
