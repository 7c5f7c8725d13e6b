"""TV reconstruction through both packages on the CPU: the conjugate proxes,
FBP (``ramp_filter``, ``iradon_slice``, ``Tomography.A_dagger``), the GD,
FISTA, ADMM, DRS and Chambolle-Pock iterators with ``TVPrior``, and the slice
as a whole (TV-PGD on MRI and on CT from the FBP, PnP-HQS with
``TVDenoiser``), as the examples run them (``demo_tv_minimisation.py``,
``demo_mri_tour.py``, ``demo_ct_projectors.py``, ``demo_basics.py``) cut to
small images. Same measurements on both sides, from a numpy seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepinv_tpu.models import TVDenoiser as JaxTVDenoiser
from deepinv_tpu.ops.radon import ramp_filter as jax_ramp_filter
from deepinv_tpu.ops.radon_slice import iradon_slice as jax_iradon_slice
from deepinv_tpu.optim import L2 as JaxL2
from deepinv_tpu.optim import PnP as JaxPnP
from deepinv_tpu.optim import TVPrior as JaxTVPrior
from deepinv_tpu.optim import create_iterator as jax_create_iterator
from deepinv_tpu.optim import optim_builder as jax_optim_builder
from deepinv_tpu.optim.optimizers import PDCP as JaxPDCP
from deepinv_tpu.physics import MRI as JaxMRI
from deepinv_tpu.physics import BlurFFT as JaxBlurFFT
from deepinv_tpu.physics import Tomography as JaxTomography
from deepinv_tpu_torch.models import TVDenoiser
from deepinv_tpu_torch.ops import gaussian_blur, iradon_slice, ramp_filter
from deepinv_tpu_torch.optim import (ADMM, CP, DRS, FISTA, GD, HQS, L2, PDCP, PGD, PnP, TVPrior,
                                     create_iterator, optim_builder)
from deepinv_tpu_torch.physics import MRI, BlurFFT, Tomography
from test_torch_drunet import DEV


def _discs(shape, seed=0, n=6):
    """Piecewise-constant phantom: random discs of random levels per channel
    (``random_circles``, deepinv_tpu/datasets/phantoms.py:39)."""
    rng = np.random.default_rng(seed)
    C, H, W = shape
    img = np.zeros(shape, np.float32)
    yy, xx = np.mgrid[0:H, 0:W]
    for _ in range(n):
        cy, cx = rng.integers(0, H), rng.integers(0, W)
        r = rng.integers(max(H // 16, 1), H // 4)
        img[:, (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = rng.random(C)[:, None]
    return img[None]


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


def _psnr(a, x):
    return float(10 * np.log10(1.0 / np.mean((np.asarray(a, np.float32) - x) ** 2)))


def _blur_problem(shape=(3, 32, 32), seed=0):
    x = _discs(shape, seed)
    psf = gaussian_blur(2.0)
    ref = JaxBlurFFT(shape, filter=jnp.asarray(psf.numpy()))
    port = BlurFFT(shape, filter=psf, device=DEV)
    noise = np.random.default_rng(seed + 1).standard_normal(x.shape).astype(np.float32)
    y = np.asarray(ref.A(jnp.asarray(x))) + 0.02 * noise
    return x, y, ref, port


def _run(ref_model, port_model, y, ref_phys, port_phys):
    want = np.asarray(jax.jit(lambda m, v, p: m(v, p))(ref_model, jnp.asarray(y), ref_phys))
    with torch.no_grad():
        got = port_model(torch.from_numpy(y), port_phys).numpy()
    return got, want


def test_prox_conjugates_match_jax():
    """The Moreau identity on ``TVPrior`` (``Potential.prox_conjugate``,
    potential.py:66), on the whole L2 fidelity through BlurFFT
    (``DataFidelity.prox_conjugate``, data_fidelity.py:83) and on its
    distance alone (``prox_d_conjugate`` :92): atol 1e-5."""
    x, y, ref_phys, port_phys = _blur_problem(shape=(1, 16, 16))
    v = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
    vt, vj, yt, yj = torch.from_numpy(v), jnp.asarray(v), torch.from_numpy(y), jnp.asarray(y)
    pairs = [
        (TVPrior(n_it_max=20).prox_conjugate(vt, None, gamma=0.5, lamb=0.2),
         JaxTVPrior(n_it_max=20).prox_conjugate(vj, None, gamma=0.5, lamb=0.2)),
        (L2(sigma=0.5).prox_conjugate(vt, yt, port_phys, gamma=0.7, lamb=1.5),
         JaxL2(sigma=0.5).prox_conjugate(vj, yj, ref_phys, gamma=0.7, lamb=1.5)),
        (L2(sigma=0.5).prox_d_conjugate(vt, yt, gamma=0.7, lamb=1.5),
         JaxL2(sigma=0.5).prox_d_conjugate(vj, yj, gamma=0.7, lamb=1.5)),
    ]
    for got, want in pairs:
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_ramp_filter_and_iradon_slice_match_jax():
    """``ramp_filter`` (radon.py:89) and ``iradon_slice`` (radon_slice.py:84),
    filtered and not, on 64 x 64 images with 30 angles, no circle: relative
    max error <= 1e-4."""
    W = 91  # the detector of a 64-pixel image without the circle
    theta = np.linspace(0, 180, 30, endpoint=False).astype(np.float32)
    sino = np.random.default_rng(3).standard_normal((2, 1, W, 30)).astype(np.float32)
    got = ramp_filter(torch.from_numpy(sino))
    assert got.shape == sino.shape and got.dtype == torch.float32
    assert _rel(got.numpy(), jax_ramp_filter(jnp.asarray(sino))) <= 1e-4
    for filtered in (True, False):
        got = iradon_slice(torch.from_numpy(sino), theta, filtered=filtered, out_size=64)
        want = jax_iradon_slice(jnp.asarray(sino), theta, filtered=filtered, out_size=64)
        assert tuple(got.shape) == want.shape == (2, 1, 64, 64)
        assert _rel(got.numpy(), want) <= 1e-4


@pytest.mark.parametrize("normalize", [False, True])
def test_tomography_fbp_matches_jax(normalize):
    """``Tomography.A_dagger`` (FBP, tomography.py:191) and its alias ``fbp``
    at 64 x 64, 30 angles, no circle: relative max error <= 1e-4; the FBP of
    a phantom's sinogram is closer to it than the backprojection is."""
    kw = dict(angles=30, img_width=64, normalize=normalize, method="slice")
    ref, port = JaxTomography(**kw), Tomography(**kw, device=DEV)
    x = _discs((1, 64, 64), seed=4)
    y = np.asarray(ref.A(jnp.asarray(x)))
    got = port.A_dagger(torch.from_numpy(y))
    assert tuple(got.shape) == x.shape
    assert _rel(got.numpy(), ref.A_dagger(jnp.asarray(y))) <= 1e-4
    assert torch.equal(port.fbp(torch.from_numpy(y)), got)
    bp = port.A_adjoint(torch.from_numpy(y)).numpy()
    assert _psnr(got.numpy(), x) > _psnr(bp / np.abs(bp).max() * x.max(), x)


ITERATIONS = [("GD", False), ("FISTA", False), ("FISTA", True), ("ADMM", False),
              ("ADMM", True), ("DRS", False), ("DRS", True), ("CP", False), ("CP", True)]


@pytest.mark.parametrize("name,g_first", ITERATIONS)
def test_iterators_with_tv_prior_match_jax(name, g_first):
    """Each iterator, in both orders where it has two, with ``TVPrior`` on
    BlurFFT at 1 x 3 x 32 x 32, 5 iterations, a stepsize schedule and
    relaxation: relative max error <= 1e-4.

    GD and FISTA with ``g_first`` step along TV's gradient, whose
    ``sqrt(|grad x|^2 + 1e-12)`` is ill-conditioned where the iterate is
    nearly flat: in float32 the two packages' last-bit differences grow 3-5x
    per iteration there (1e-3 after 5, on this problem). Those two run in
    float64 on both sides, where what is left is the two packages' float32
    transfer functions (observed 8e-6 and 2e-5)."""
    x, y, ref_phys, port_phys = _blur_problem(seed=5)
    params = {"stepsize": [0.5, 0.8], "lambda": 0.05, "beta": 0.9, "stepsize_dual": 0.7}
    if name == "GD":
        params["stepsize"] = 0.3
    along_grad = name == "GD" or (name == "FISTA" and g_first)
    if along_grad:
        y = y.astype(np.float64)
    ref = jax_optim_builder(jax_create_iterator(name, g_first=g_first), data_fidelity=JaxL2(),
                            prior=JaxTVPrior(n_it_max=20), params_algo=params, max_iter=5)
    port = optim_builder(create_iterator(name, g_first=g_first), data_fidelity=L2(),
                         prior=TVPrior(n_it_max=20), params_algo=params, max_iter=5, device=DEV)
    with jax.enable_x64(along_grad):
        got, want = _run(ref, port, y, ref_phys, port_phys)
    assert got.shape == x.shape and got.dtype == want.dtype == y.dtype
    assert np.isfinite(got).all()
    assert _rel(got, want) <= 1e-4


def test_named_builders_and_pdcp():
    """``PGD``/``FISTA``/``ADMM``/``DRS``/``CP``/``GD``/``HQS`` are
    ``optim_builder`` with the iteration fixed; ``PDCP`` with an explicit
    ``K`` matches the JAX package's (relative max error <= 1e-4), and with
    none it is ``CP``. ``K`` on another iteration raises."""
    x, y, ref_phys, port_phys = _blur_problem(shape=(1, 16, 16), seed=6)
    kw = dict(data_fidelity=L2(), prior=TVPrior(n_it_max=10), params_algo={"lambda": 0.05},
              max_iter=3, device=DEV)
    for builder, it in [(PGD, "PGDIteration"), (FISTA, "FISTAIteration"),
                        (ADMM, "ADMMIteration"), (DRS, "DRSIteration"), (CP, "CPIteration"),
                        (GD, "GDIteration"), (HQS, "HQSIteration")]:
        assert type(builder(**kw).iterator).__name__ == it
    yt = torch.from_numpy(y)
    with torch.no_grad():
        assert torch.equal(PDCP(**kw)(yt, port_phys), CP(**kw)(yt, port_phys))
    params = {"stepsize": 0.4, "lambda": 0.05, "stepsize_dual": 0.5}
    ref = JaxPDCP(data_fidelity=JaxL2(), prior=JaxTVPrior(n_it_max=10), K=lambda v: 0.5 * v,
                  K_adjoint=lambda v: 0.5 * v, params_algo=params, max_iter=3)
    port = PDCP(data_fidelity=L2(), prior=TVPrior(n_it_max=10), K=lambda v: 0.5 * v,
                K_adjoint=lambda v: 0.5 * v, params_algo=params, max_iter=3, device=DEV)
    got, want = _run(ref, port, y, ref_phys, port_phys)
    assert _rel(got, want) <= 1e-4
    with pytest.raises(ValueError, match="CP"):
        create_iterator("PGD", K=lambda v: v)


def test_tv_pgd_mri_matches_jax():
    """TV-PGD on MRI as ``demo_mri_tour.py`` runs it (stepsize 1.0, lambda
    0.002, 20 iterations, ``TVPrior()`` with its 100 Chambolle steps), 64 x 64
    with a 30% mask: relative max error <= 1e-4, and better than the
    zero-filled ``A^T y``."""
    rng = np.random.default_rng(7)
    x = np.concatenate([_discs((1, 64, 64), seed=7), np.zeros((1, 1, 64, 64), np.float32)], 1)
    mask = (rng.random((64, 64)) < 0.3).astype(np.float32)
    ref = JaxMRI(mask=jnp.asarray(mask), img_size=(64, 64))
    port = MRI(mask=mask, img_size=(64, 64), device=DEV)
    y = np.asarray(ref.A(jnp.asarray(x))) + 0.01 * rng.standard_normal(x.shape).astype(
        np.float32) * mask
    params = {"stepsize": 1.0, "lambda": 0.002}
    got, want = _run(jax_optim_builder("PGD", data_fidelity=JaxL2(), prior=JaxTVPrior(),
                                       params_algo=params, max_iter=20),
                     PGD(data_fidelity=L2(), prior=TVPrior(), params_algo=params, max_iter=20,
                         device=DEV), y, ref, port)
    assert _rel(got, want) <= 1e-4
    assert _psnr(got, x) > _psnr(port.A_adjoint(torch.from_numpy(y)).numpy(), x)


def test_tv_pgd_ct_from_fbp_matches_jax():
    """TV-PGD on CT as ``demo_ct_projectors.py`` runs it (stepsize 1.0,
    lambda 5e-4, 30 iterations, the FBP as the initial iterate), 64 x 64, 90
    angles, normalized: relative max error <= 1e-3 (CT's gradient subtracts
    two near-equal terms, tests/test_torch_pgd.py), and no worse than the FBP
    by more than 0.5 dB."""
    kw = dict(img_width=64, angles=90, method="slice", normalize=True)
    ref, port = JaxTomography(**kw), Tomography(**kw, device=DEV)
    x = _discs((1, 64, 64), seed=8)
    Ax = np.asarray(ref.A(jnp.asarray(x)))
    y = Ax + 0.002 * np.random.default_rng(8).standard_normal(Ax.shape).astype(np.float32)
    params = {"stepsize": 1.0, "lambda": 5e-4}
    got, want = _run(
        jax_optim_builder("PGD", data_fidelity=JaxL2(), prior=JaxTVPrior(), params_algo=params,
                          max_iter=30, custom_init=lambda v, p: p.A_dagger(v)),
        optim_builder("PGD", data_fidelity=L2(), prior=TVPrior(), params_algo=params,
                      max_iter=30, custom_init=lambda v, p: p.A_dagger(v), device=DEV),
        y, ref, port)
    assert _rel(got, want) <= 1e-3
    assert _psnr(got, x) >= _psnr(port.A_dagger(torch.from_numpy(y)).numpy(), x) - 0.5


def test_pnp_hqs_with_tv_denoiser_matches_jax():
    """PnP-HQS with ``TVDenoiser(50)`` as ``demo_basics.py`` runs it
    (stepsize 1.0, g_param 0.03, 10 iterations) on the deblurring problem at
    1 x 3 x 64 x 64: relative max error <= 1e-4, and better than ``y``."""
    x, y, ref_phys, port_phys = _blur_problem(shape=(3, 64, 64), seed=9)
    params = {"stepsize": 1.0, "g_param": 0.03}
    got, want = _run(jax_optim_builder("HQS", data_fidelity=JaxL2(),
                                       prior=JaxPnP(JaxTVDenoiser(50)), params_algo=params,
                                       max_iter=10),
                     optim_builder("HQS", data_fidelity=L2(), prior=PnP(TVDenoiser(50)),
                                   params_algo=params, max_iter=10, device=DEV),
                     y, ref_phys, port_phys)
    assert _rel(got, want) <= 1e-4
    assert _psnr(got, x) > _psnr(y, x)
