"""The port's MRI and CT physics, and the NUFFT under CT, against the JAX
package on the CPU.

Inputs, masks and noise come from numpy seeds and are handed to both sides.
The NUFFT interpolation weights differ in their last bits: the port builds
them in float64 numpy at construction, the JAX package's type-2 NUFFT in
float32 inside the trace; the results agree to about 1e-5 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepinv_tpu.ops import nufft as jax_nufft
from deepinv_tpu.physics import MRI as JaxMRI
from deepinv_tpu.physics import Tomography as JaxTomography
from deepinv_tpu_torch.ops import (nufft2, nufft2_adjoint, nufft2_normal, nufft2_toeplitz_spec,
                                   radon_output_size, radon_slice_normal_spec)
from deepinv_tpu_torch.ops.nufft import _grid_setup, _interp_plan
from deepinv_tpu_torch.ops.radon_fourier import _next_smooth
from deepinv_tpu_torch.ops.radon_slice import _slice_plan
from deepinv_tpu_torch.optim import L2
from deepinv_tpu_torch.physics import MRI, GaussianNoise, Tomography
from test_torch_drunet import DEV


def _rel_l2(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _mri_pair(size=32, seed=0):
    rng = np.random.default_rng(seed)
    mask = (rng.random((size, size)) < 0.3).astype(np.float32)
    return JaxMRI(mask=jnp.asarray(mask), img_size=(size, size)), MRI(mask=mask,
                                                                      img_size=(size, size),
                                                                      device=DEV)


def test_mri_matches_jax():
    """``A``, ``A_adjoint`` and the closed-form ``prox_l2`` of the masked
    centred orthonormal FFT at 32 x 32, B = 2: within 1e-5 absolute on
    unit-scale data."""
    ref, port = _mri_pair()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 2, 32, 32)).astype(np.float32)
    y = rng.standard_normal((2, 2, 32, 32)).astype(np.float32)
    z = rng.standard_normal((2, 2, 32, 32)).astype(np.float32)
    pairs = [
        (port.A(torch.from_numpy(x)), ref.A(jnp.asarray(x))),
        (port.A_adjoint(torch.from_numpy(y)), ref.A_adjoint(jnp.asarray(y))),
        (port.prox_l2(torch.from_numpy(z), torch.from_numpy(y), 0.7),
         ref.prox_l2(jnp.asarray(z), jnp.asarray(y), 0.7)),
        (port.A_adjoint(torch.from_numpy(y), mag=True, crop=(20, 24)),
         ref.A_adjoint(jnp.asarray(y), mag=True, crop=(20, 24))),
        (port.A_adjoint_A(torch.from_numpy(x)), ref.A_adjoint_A(jnp.asarray(x))),
    ]
    for got, want in pairs:
        assert tuple(got.shape) == want.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert port.mask.shape == (1, 2, 32, 32) and "mask" in dict(port.named_buffers())
    assert not port.fast_normal


def test_mri_mask_update_and_masked_noise():
    """A new mask is normalized as at construction and leaves the old
    physics as it was; noise lands on the sampled k-space only."""
    _, port = _mri_pair(size=16)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 2, 16, 16)).astype(
        np.float32))
    full = port.update(mask=torch.ones(16, 16))
    assert full.mask.shape == (1, 2, 16, 16) and float(port.mask.mean()) < 0.5
    np.testing.assert_allclose(full.A_adjoint(full.A(x)).numpy(), x.numpy(), atol=1e-5)
    noisy = MRI(mask=port.mask[0, 0], img_size=(16, 16),
                noise_model=GaussianNoise(0.1, device=DEV), device=DEV)
    y = noisy(x, generator=torch.Generator().manual_seed(0))
    assert bool((y[port.mask.expand_as(y) == 0] == 0).all())
    assert float((y - noisy.A(x)).abs().max()) > 0


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("circle", [False, True])
@pytest.mark.parametrize("width", [32, 64])
def test_tomography_matches_jax(width, circle, normalize):
    """``Tomography(method="slice")``'s ``A``, ``A_adjoint`` and Toeplitz
    ``A_adjoint_A``: relative L2 error <= 1e-4 (observed <= 1e-5). At 64 px
    with the circle, the JAX package's float32 Toeplitz spectrum is 2.9e-2
    from a float64 one (test_toeplitz_spectrum_is_float64_accurate) and its
    ``A_adjoint_A`` 2.6e-4 from the port's: bound 5e-4 there."""
    kw = dict(angles=30, img_width=width, circle=circle, normalize=normalize, method="slice")
    ref, port = JaxTomography(**kw), Tomography(**kw, device=DEV)
    rng = np.random.default_rng(width)
    x = rng.random((2, 1, width, width)).astype(np.float32)
    n_det = radon_output_size(width, circle)
    y = rng.standard_normal((2, 1, n_det, 30)).astype(np.float32)
    got = port.A(torch.from_numpy(x))
    assert tuple(got.shape) == (2, 1, n_det, 30) and got.dtype == torch.float32
    assert _rel_l2(got.numpy(), ref.A(jnp.asarray(x))) <= 1e-4
    assert _rel_l2(port.A_adjoint(torch.from_numpy(y)).numpy(),
                   ref.A_adjoint(jnp.asarray(y))) <= 1e-4
    assert port.fast_normal and ref.fast_normal
    assert _rel_l2(port.A_adjoint_A(torch.from_numpy(x)).numpy(),
                   ref.A_adjoint_A(jnp.asarray(x))) <= (5e-4 if (width, circle) == (64, True)
                                                        else 1e-4)


def _spec_float64(W, theta):
    """The Toeplitz spectrum of ``radon_slice_normal_spec`` computed with the
    same plan in float64/complex128 numpy arithmetic."""
    om, _ = _slice_plan(W, theta, 4, 2.0)
    N = _next_smooth(2 * W)
    (G, _), beta, scale = _grid_setup((N, N), 4, 2.0)
    idx, wts = _interp_plan(om, (G, G), 4, beta)
    grid = np.zeros(G * G, np.complex128)
    np.add.at(grid, idx.reshape(-1), (wts / W / (4 / np.i0(beta)) ** 2).reshape(-1))
    k = np.fft.fftshift(np.fft.ifft2(np.fft.ifftshift(grid.reshape(G, G)))) * G * G
    p = (G - N) // 2
    k = k[p:p + N, p:p + N] * scale.astype(np.float64)
    o = G // 2 - (G - N) // 2
    return np.fft.fft2(np.roll(k, (-o, -o), axis=(0, 1)))


@pytest.mark.parametrize("W", [33, 46, 64, 91])
def test_toeplitz_spectrum_is_float64_accurate(W):
    """The port builds the plan in float64 and applies it in complex64: its
    spectrum is within 1e-6 relative L2 of the same computation in float64
    (observed ~2e-7). The JAX package computes the spreading weights in
    float32 inside the trace and lands 9e-6 to 3e-5 away, and 2.9e-2 at
    W = 64, where many sample positions fall on grid cells."""
    theta = np.linspace(0, 180, 30, endpoint=False).astype(np.float32)
    want = _spec_float64(W, theta)
    got = radon_slice_normal_spec(W, theta, circle=True)
    assert tuple(got.shape) == want.shape and got.dtype == torch.complex64
    assert _rel_l2(got.numpy(), want) <= 1e-6


@pytest.mark.parametrize("circle", [False, True])
@pytest.mark.parametrize("width", [32, 33])
def test_tomography_adjointness(width, circle):
    """``<A u, v> = <u, A^T v>`` to 1e-5 relative (the adjoint is the exact
    transpose of the forward, up to float32 rounding)."""
    physics = Tomography(angles=20, img_width=width, circle=circle, method="slice", device=DEV)
    g = torch.Generator().manual_seed(width)
    u = torch.rand((2, 1, width, width), generator=g)
    Au = physics.A(u)
    v = torch.randn(Au.shape, generator=g)
    lhs = float((Au.double() * v.double()).sum())
    rhs = float((u.double() * physics.A_adjoint(v).double()).sum())
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)
    assert abs(float(physics.adjointness_test(u))) <= 1e-4 * float(Au.norm() ** 2)


def test_toeplitz_normal_is_close_to_adjoint_of_forward():
    """The Toeplitz ``A_adjoint_A`` is exact up to the Kaiser-Bessel
    gridding: within 1e-2 relative max error of ``A_adjoint(A(x))`` at 32 px
    (the JAX package gives 4.2e-3 there); both are held to JAX above."""
    physics = Tomography(angles=90, img_width=32, normalize=True, method="slice", device=DEV)
    x = torch.rand((1, 1, 32, 32), generator=torch.Generator().manual_seed(0))
    fast, slow = physics.A_adjoint_A(x), physics.A_adjoint(physics.A(x))
    assert float((fast - slow).abs().max() / slow.abs().max()) <= 1e-2
    plain = Tomography(angles=90, img_width=32, normalize=True, method="slice",
                       fast_normal=False, device=DEV)
    assert not plain.fast_normal and plain.plan.spec is None
    assert torch.equal(plain.A_adjoint_A(x), slow)


def test_tomography_state_and_unported_options():
    """The plan and the spectrum are buffers (``physics.to(device)`` moves
    them); the other projectors (``interp``, the default, and ``fourier``)
    and the fan beam construct and project as the JAX package's do."""
    physics = Tomography(angles=12, img_width=16, method="slice", device=DEV)
    buffers = dict(physics.named_buffers())
    for name in ("angles", "plan.phase", "plan.spec", "plan.nufft.idx", "plan.nufft.wts",
                 "plan.nufft.scale"):
        assert name in buffers, name
    assert buffers["plan.spec"].dtype == torch.complex64
    assert buffers["plan.nufft.idx"].dtype == torch.int64
    x = torch.rand((1, 1, 16, 16), generator=torch.Generator().manual_seed(5))
    for kw in (dict(), dict(method="fourier"), dict(method="slice", fan_beam=True)):
        port = Tomography(angles=12, img_width=16, device=DEV, **kw)
        ref = JaxTomography(angles=12, img_width=16, **kw)
        got, want = port.A(x), np.asarray(ref.A(jnp.asarray(x.numpy())))
        assert tuple(got.shape) == want.shape and port.n_det == ref.n_det
        # the default fan beam's float32 geometry in JAX (tests/test_torch_ct_projectors.py)
        bound = 2e-3 if kw.get("fan_beam") else 1e-4
        assert float(np.abs(got.numpy() - want).max()) <= bound * float(np.abs(want).max())


def test_l2_grad_splits_with_fast_normal():
    """With a fast normal operator ``L2.grad`` is ``A_adjoint_A(x) - A^T y``
    (data_fidelity.py:151-160); without one, ``A^T (A x - y)``. Both agree
    to the Toeplitz accuracy."""
    physics = Tomography(angles=30, img_width=32, normalize=True, method="slice", device=DEV)
    g = torch.Generator().manual_seed(3)
    x, y = torch.rand((1, 1, 32, 32), generator=g), physics.A(torch.rand((1, 1, 32, 32),
                                                                         generator=g))
    fast = L2(sigma=0.5).grad(x, y, physics)
    want = (physics.A_adjoint_A(x) - physics.A_adjoint(y)) / 0.25
    assert torch.allclose(fast, want)
    plain = Tomography(angles=30, img_width=32, normalize=True, method="slice",
                       fast_normal=False, device=DEV)
    slow = L2(sigma=0.5).grad(x, y, plain)
    assert float((fast - slow).abs().max() / slow.abs().max()) <= 5e-2


@pytest.mark.parametrize("shape", [(12, 10), (9, 16)])
def test_nufft_matches_jax(shape):
    """Type 2, type 1 (explicit spreading here, ``jax.linear_transpose``
    there) and the Toeplitz normal operator on random k-space points:
    relative L2 error <= 1e-4 (observed ~1e-6); type 1 is the adjoint of
    type 2 to 1e-5."""
    rng = np.random.default_rng(sum(shape))
    om = (rng.random((2, 60)) * 2 * np.pi - np.pi).astype(np.float32)
    x = rng.standard_normal((3,) + shape).astype(np.float32)
    y = (rng.standard_normal((3, 60)) + 1j * rng.standard_normal((3, 60))).astype(np.complex64)
    Ax = nufft2(torch.from_numpy(x), torch.from_numpy(om))
    assert Ax.shape == (3, 60) and Ax.dtype == torch.complex64
    assert _rel_l2(Ax.numpy(), jax_nufft.nufft2(jnp.asarray(x), jnp.asarray(om))) <= 1e-4
    Aty = nufft2_adjoint(torch.from_numpy(y), om, shape)
    want = jax_nufft.nufft2_adjoint(jnp.asarray(y), jnp.asarray(om), shape)
    assert _rel_l2(Aty.numpy(), want) <= 1e-4
    lhs = complex(torch.vdot(Ax.flatten().to(torch.complex128),
                             torch.from_numpy(y).flatten().to(torch.complex128)))
    rhs = complex(torch.vdot(torch.from_numpy(x).flatten().to(torch.complex128),
                             Aty.flatten().to(torch.complex128)))
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)
    spec = nufft2_toeplitz_spec(om, shape)
    want_spec = jax_nufft.nufft2_toeplitz_spec(jnp.asarray(om), shape)
    assert _rel_l2(spec.numpy(), want_spec) <= 1e-4
    assert _rel_l2(nufft2_normal(torch.from_numpy(x), spec).numpy(),
                   jax_nufft.nufft2_normal(jnp.asarray(x), want_spec)) <= 1e-4
