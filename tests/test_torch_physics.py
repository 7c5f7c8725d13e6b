"""The port's blur physics against the JAX package on the CPU.

Filters, transfer functions and BlurFFT's operators get the same inputs,
made from a numpy seed; noise is drawn with numpy and added explicitly on
both sides, since JAX keys and torch generators draw different numbers.
Images are unit-scale, so f32 results agree to 1e-5 absolute.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepinv_tpu.ops import filter_fft_2d as jax_filter_fft_2d
from deepinv_tpu.ops import gaussian_blur as jax_gaussian_blur
from deepinv_tpu.physics import BlurFFT as JaxBlurFFT
from deepinv_tpu_torch.ops import filter_fft_2d, gaussian_blur
from deepinv_tpu_torch.physics import BlurFFT, GaussianNoise
from test_torch_drunet import DEV

ATOL = 1e-5


@pytest.mark.parametrize("kwargs", [
    dict(sigma=1.5),
    dict(sigma=(1.0, 2.0), angle=30.0),
    dict(sigma=(0.7, 1.3), angle=-45.0, psf_size=7),
    dict(sigma=2.0, psf_size=(5, 9)),
])
def test_gaussian_blur_matches_jax(kwargs):
    got = gaussian_blur(**kwargs)
    want = np.asarray(jax_gaussian_blur(**kwargs))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-7)
    assert abs(float(got.sum()) - 1.0) < 1e-6


@pytest.mark.parametrize("real_fft", [True, False])
@pytest.mark.parametrize("grid", [(3, 32, 24), (1, 8, 12)])
def test_filter_fft_2d_matches_jax(real_fft, grid):
    """Transfer functions, including a PSF larger than the grid (15x15 on
    8x12), which wraps modulo the grid."""
    psf = np.array(jax_gaussian_blur(sigma=(2.0, 1.0), angle=20.0, psf_size=15))
    got = filter_fft_2d(torch.from_numpy(psf), grid, real_fft=real_fft)
    want = np.asarray(jax_filter_fft_2d(jnp.asarray(psf), grid, real_fft=real_fft))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def _problem(B=2, shape=(3, 32, 24), sigma=1.5, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((B,) + shape).astype(np.float32)
    eps = rng.standard_normal((B,) + shape).astype(np.float32)
    z = rng.random((B,) + shape).astype(np.float32)
    psf = gaussian_blur(sigma)
    port = BlurFFT(shape, filter=psf, noise_model=GaussianNoise(0.01, device=DEV), device=DEV)
    ref = JaxBlurFFT(shape, filter=jnp.asarray(psf.numpy()))
    return x, eps, z, port, ref


@pytest.mark.parametrize("gamma", [0.5, "per-sample"])
def test_blurfft_operators_match_jax(gamma):
    """A, A_adjoint and prox_l2 (scalar and per-sample gamma)."""
    x, eps, z, port, ref = _problem()
    y = np.asarray(ref.A(jnp.asarray(x))) + 0.01 * eps
    g = np.array([0.5, 3.0], np.float32) if gamma == "per-sample" else gamma
    g_t = torch.from_numpy(g) if isinstance(g, np.ndarray) else g
    pairs = [
        (port.A(torch.from_numpy(x)), ref.A(jnp.asarray(x))),
        (port.A_adjoint(torch.from_numpy(y)), ref.A_adjoint(jnp.asarray(y))),
        (port.prox_l2(torch.from_numpy(z), torch.from_numpy(y), g_t),
         ref.prox_l2(jnp.asarray(z), jnp.asarray(y), jnp.asarray(g))),
    ]
    for got, want in pairs:
        assert got.shape == want.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_blurfft_a_dagger_matches_jax():
    """The closed-form pseudo-inverse divides by the transfer function, which
    amplifies f32 rounding by up to 1/min|mask|; a sigma-1 PSF keeps
    min|mask| near 7e-3, so the bound is 1e-3 relative to the output."""
    x, eps, _, port, ref = _problem(sigma=1.0)
    y = np.asarray(ref.A(jnp.asarray(x))) + 0.01 * eps
    got = port.A_dagger(torch.from_numpy(y)).numpy()
    want = np.asarray(ref.A_dagger(jnp.asarray(y)))
    assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()


def test_blurfft_complex_input_takes_the_svd_path():
    """Complex inputs go through the full-spectrum DecomposablePhysics path,
    as in the JAX package."""
    x, eps, _, port, ref = _problem(B=1)
    xc = x + 1j * eps
    got = port.A(torch.from_numpy(xc.astype(np.complex64)))
    want = ref.A(jnp.asarray(xc.astype(np.complex64)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_blurfft_adjointness():
    x, _, _, port, _ = _problem(B=1)
    assert abs(float(port.adjointness_test(torch.from_numpy(x)))) < 1e-3


@pytest.mark.parametrize("gamma", [0.3, 200.0])
def test_prox_l2_optimality_residual(gamma):
    """The prox solves gamma * A^T (A x - y) + (x - z) = 0."""
    x, eps, z, port, _ = _problem(seed=3)
    y = port.A(torch.from_numpy(x)) + 0.01 * torch.from_numpy(eps)
    zt = torch.from_numpy(z)
    xp = port.prox_l2(zt, y, gamma)
    res = gamma * port.A_adjoint(port.A(xp) - y) + (xp - zt)
    assert float(res.abs().max()) < 1e-4


def test_measurement_noise_and_update():
    """physics(x) = A x + sigma * eps with eps from the generator; update()
    returns a new physics (noise level or PSF) and leaves the old one."""
    x, _, _, port, _ = _problem(B=2, shape=(1, 64, 64))
    xt = torch.from_numpy(x)
    y1 = port(xt, generator=torch.Generator().manual_seed(5))
    y2 = port(xt, generator=torch.Generator().manual_seed(5))
    assert torch.equal(y1, y2)
    assert torch.equal(port(xt), port(xt))  # seeded from the noise model by default
    r = (y1 - port.A(xt)) / 0.01
    assert abs(float(r.mean())) < 0.05 and abs(float(r.std()) - 1.0) < 0.05

    loud = port.update(sigma=0.5)
    assert float(loud.noise_model.sigma) == 0.5
    assert float(port.noise_model.sigma) == pytest.approx(0.01)
    r = loud(xt) - port.A(xt)
    assert abs(float(r.std()) - 0.5) < 0.02

    per_sample = port.update(sigma=torch.tensor([0.0, 1.0]))
    r = per_sample(xt) - port.A(xt)
    assert float(r[0].abs().max()) == 0.0 and abs(float(r[1].std()) - 1.0) < 0.05

    psf = gaussian_blur(2.5)
    other = port.update(filter=psf)
    fresh = BlurFFT((1, 64, 64), filter=psf, device=DEV)
    assert torch.equal(other.mask, fresh.mask) and not torch.equal(other.mask, port.mask)
    assert torch.equal(other.A(xt), fresh.A(xt))
