"""The port's single-pixel, compressed-sensing, structured-random, misc,
pansharpening and multiscale physics, ``adjoint_function``, ``Demosaicing``
and the ``functional`` namespace against the JAX package's, on the CPU; then
the slice as a whole: PnP-HQS on the single-pixel camera and PnP-PGD on fast
compressed sensing with a DnCNN crossed by ``load_jax_params``.

Inputs come from numpy seeds; random tables (matrices, signs and rows,
diagonals, the unmixing matrix, the coded aperture) are drawn by JAX and
handed to the port by keyword. Bounds, f32, max abs error over the
reference's max: ``A``, ``A_adjoint``, ``A_dagger`` and ``prox_l2`` within
1e-5, or 1e-4 where an FFT of prime length (the flattened DST-I) or an
iterative solve sits inside; adjointness ``|<Ax, y> - <x, A^T y>|`` within
1e-5 of ``||Ax|| ||y||``; the PnP recons within 1e-4.
"""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepinv_tpu.physics as J
import deepinv_tpu_torch.physics as T
from deepinv_tpu.core import TensorList as JTensorList
from deepinv_tpu.ops import gaussian_blur as jgaussian_blur
from deepinv_tpu.optim import L2 as JL2
from deepinv_tpu.optim import PnP as JPnP
from deepinv_tpu.optim import optim_builder as joptim_builder
from deepinv_tpu_torch.core import TensorList
from deepinv_tpu_torch.optim import L2, PnP, optim_builder
from test_torch_dncnn import _pair

jfun = importlib.import_module("deepinv_tpu.physics.functional")
tfun = importlib.import_module("deepinv_tpu_torch.physics.functional")
jspc = importlib.import_module("deepinv_tpu.physics.singlepixel")
tspc = importlib.import_module("deepinv_tpu_torch.physics.singlepixel")

DEV = "cpu"
KEY = jax.random.key


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(v):
    if isinstance(v, (TensorList, JTensorList)):
        return [np.asarray(u) for u in v]
    return np.asarray(v)


def _close(got, want, tol):
    got, want = _np(got), _np(want)
    if isinstance(want, list):
        assert max(_rel(g, w) for g, w in zip(got, want)) <= tol
    else:
        assert got.shape == want.shape and _rel(got, want) <= tol


def _adjoint_gap(p, x, y):
    """``|<A x, y> - <x, A^T y>| / (||A x|| ||y||)`` of the port's physics."""
    Ax, Aty = p.A(x), p.A_adjoint(y)
    lhs = sum(torch.vdot(a.flatten(), b.flatten()) for a, b in zip(_leaves(Ax), _leaves(y)))
    rhs = torch.vdot(x.flatten().to(Aty.dtype), Aty.flatten())
    na = math.sqrt(sum(float(a.norm()) ** 2 for a in _leaves(Ax)))
    ny = math.sqrt(sum(float(b.norm()) ** 2 for b in _leaves(y)))
    return abs(complex(lhs - rhs)) / (na * ny)


def _leaves(v):
    return list(v) if isinstance(v, TensorList) else [v]


# the Krylov A_dagger and prox_l2 run to a tight tolerance on both sides, so
# that a stop one iteration apart (f32 rounding in another order) does not
# decide the comparison
KRYLOV = dict(max_iter=200, tol=1e-6)


def _parity(jp, tp, x, tol=1e-5, dagger_tol=None, prox_tol=None, gamma=0.7):
    """``A``, ``A_adjoint``, ``A_dagger`` and ``prox_l2`` (the Krylov ones at
    ``KRYLOV``) of the two physics on ``x`` and on ``y = A x`` plus a seeded
    perturbation; adjointness."""
    jx = jnp.asarray(x)
    y = jp.A(jx)
    rng = np.random.default_rng(7)
    if isinstance(y, JTensorList):
        ys = [np.asarray(v) + 0.1 * rng.standard_normal(v.shape).astype(np.float32) for v in y]
        jy, ty = JTensorList([jnp.asarray(v) for v in ys]), TensorList([_t(v) for v in ys])
    else:
        ys = np.asarray(y) + 0.1 * rng.standard_normal(y.shape).astype(np.float32)
        jy, ty = jnp.asarray(ys), _t(ys)
    tx = _t(x)
    with torch.no_grad():
        _close(tp.A(tx), jp.A(jx), tol)
        _close(tp.A_adjoint(ty), jp.A_adjoint(jy), tol)
        if dagger_tol is not None:
            _close(tp.A_dagger(ty, **KRYLOV), jp.A_dagger(jy, **KRYLOV), dagger_tol)
        if prox_tol is not None:
            z = rng.random(x.shape).astype(np.float32)
            _close(tp.prox_l2(_t(z), ty, gamma, **KRYLOV),
                   jp.prox_l2(jnp.asarray(z), jy, gamma, **KRYLOV), prox_tol)
        assert _adjoint_gap(tp, tx, ty) <= 1e-5


# -- the namespace -----------------------------------------------------------------


def test_physics_exports_every_jax_name():
    """``deepinv_tpu_torch.physics`` holds every public name of
    ``deepinv_tpu.physics``, and ``functional`` every name of its
    ``__all__``."""
    missing = [n for n in dir(J) if not n.startswith("_") and not hasattr(T, n)]
    assert missing == []
    assert [n for n in jfun.__all__ if not hasattr(tfun, n)] == []


def test_adjoint_function_and_demosaicing():
    rng = np.random.default_rng(0)
    M = rng.standard_normal((6, 10)).astype(np.float32)
    y = rng.standard_normal((3, 6)).astype(np.float32)
    want = J.adjoint_function(lambda v: v @ jnp.asarray(M).T, (3, 10))(jnp.asarray(y))
    got = T.adjoint_function(lambda v: v @ _t(M).T, (3, 10))(_t(y))
    _close(got, want, 1e-6)
    x = rng.random((2, 3, 8, 12)).astype(np.float32)
    _parity(J.Demosaicing((3, 8, 12)), T.Demosaicing((8, 12), device=DEV), x, dagger_tol=1e-6,
            prox_tol=1e-6)


# -- functional --------------------------------------------------------------------


@pytest.mark.parametrize("norm", [None, "ortho"])
def test_functional_dct(norm):
    x = np.random.default_rng(1).standard_normal((2, 3, 12)).astype(np.float32)
    got, want = tfun.dct(_t(x), norm=norm), jfun.dct(jnp.asarray(x), norm=norm)
    _close(got, want, 1e-5)
    _close(tfun.idct(got, norm=norm), jfun.idct(want, norm=norm), 1e-5)
    _close(tfun.idct(got, norm=norm), x, 1e-5)


def test_functional_liu_jia_pad_and_multipliers():
    rng = np.random.default_rng(2)
    x = rng.random((2, 3, 14, 10)).astype(np.float32)
    _close(tfun.liu_jia_pad(_t(x), padding=(3, 2)), jfun.liu_jia_pad(jnp.asarray(x),
                                                                     padding=(3, 2)), 1e-5)
    m = (rng.standard_normal((14, 10)) + 1j * rng.standard_normal((14, 10))).astype(np.complex64)
    _close(tfun.multiplier_adjoint(_t(x), _t(m)), jfun.multiplier_adjoint(jnp.asarray(x), m),
           1e-6)
    for mode in ("bump", "linear"):
        _close(tfun.generate_tiled_multipliers((20, 16), (8, 6), (6, 5), mode=mode),
               jfun.generate_tiled_multipliers((20, 16), (8, 6), (6, 5), mode=mode), 1e-6)
    K = J.TiledSpaceVaryingBlur.num_filters((20, 16), 8, 6)
    h = rng.random((1, 3, K, 5, 5)).astype(np.float32)
    xi = rng.random((1, 3, 20, 16)).astype(np.float32)
    _close(tfun.tiled_product_convolution(_t(xi), _t(h), 8, 6),
           jfun.tiled_product_convolution(jnp.asarray(xi), jnp.asarray(h), 8, 6), 1e-5)


def test_functional_radon_classes():
    rng = np.random.default_rng(3)
    x = rng.random((1, 2, 24, 24)).astype(np.float32)
    theta = np.linspace(0, 180, 20, endpoint=False).astype(np.float32)
    jr, tr = jfun.Radon(theta=theta, circle=True), tfun.Radon(theta=theta, circle=True)
    sino = tr(_t(x))
    _close(sino, jr(jnp.asarray(x)), 1e-5)
    ji, ti = jfun.IRadon(24, theta=theta, circle=True), tfun.IRadon(24, theta=theta, circle=True)
    _close(ti(sino), ji(jnp.asarray(sino.numpy())), 1e-4)
    _close(tfun.ApplyRadon.apply(sino, tr, ti, is_adjoint=True),
           jfun.ApplyRadon.apply(jnp.asarray(sino.numpy()), jr, ji, is_adjoint=True), 1e-4)
    jf, tf = jfun.RampFilter(), tfun.RampFilter()
    _close(tf(sino), jf(jnp.asarray(sino.numpy())), 1e-5)
    ff = tf._get_fourier_filter(64)
    _close(ff, jf._get_fourier_filter(64), 1e-6)
    s2 = rng.random((1, 1, 20, 40)).astype(np.float32)
    _close(tf.filter(_t(s2), ff[:33], 24), jf.filter(jnp.asarray(s2), ff.numpy()[:33], 24),
           1e-5)
    geo = dict(geometry_type="fanbeam", angles=np.deg2rad(theta), source_radius=40.0,
               detector_radius=20.0)
    jx, tx = jfun.XrayTransform(img_size=(24, 24), **geo), tfun.XrayTransform(img_size=(24, 24),
                                                                             **geo)
    assert tx.range_shape == jx.range_shape and tx.magnification_factor == 1.0
    assert tx.source_radius == pytest.approx(jx.source_radius)
    yx = tx(_t(x))
    _close(yx, jx(jnp.asarray(x)), 1e-5)
    v = rng.standard_normal(tuple(yx.shape)).astype(np.float32)
    _close(tx.T(_t(v)), jx.T(jnp.asarray(v)), 1e-5)


# -- compressed sensing, structured random, the single-pixel camera ---------------


@pytest.mark.parametrize("fast,channelwise", [(False, False), (False, True), (True, False),
                                              (True, True)])
def test_compressed_sensing_matches_jax(fast, channelwise):
    """Dense and fast forms; the fast DST-I of 2 x 10 x 10 = 200 pixels is an
    FFT of 402 = 2 x 3 x 67, a prime factor as at 256² (65537)."""
    jp = J.CompressedSensing(m=60, img_size=(2, 10, 10), fast=fast, channelwise=channelwise,
                             key=KEY(3))
    tables = (dict(D=np.asarray(jp.D), rows=np.asarray(jp.rows)) if fast else
              dict(matrix=np.asarray(jp._A_mat)))
    tp = T.CompressedSensing(m=60, img_size=(2, 10, 10), fast=fast, channelwise=channelwise,
                             device=DEV, **tables)
    x = np.random.default_rng(4).random((2, 2, 10, 10)).astype(np.float32)
    _parity(jp, tp, x, tol=1e-4 if fast else 1e-5, dagger_tol=1e-4, prox_tol=1e-4)


def test_compressed_sensing_draws():
    """The port's own tables: signs +-1, m distinct rows, a matrix of
    variance 1/m."""
    p = T.CompressedSensing(m=300, img_size=(1, 32, 32), fast=True, device=DEV,
                            generator=torch.Generator().manual_seed(0))
    assert set(p.D.unique().tolist()) == {-1.0, 1.0} and p.rows.unique().numel() == 300
    d = T.CompressedSensing(m=300, img_size=(1, 32, 32), device=DEV)
    assert abs(float(d._A_mat.var()) * 300 - 1) < 0.02


@pytest.mark.parametrize("n_layers,out", [(1.0, None), (2.5, (1, 12, 10))])
def test_structured_random_matches_jax(n_layers, out):
    jp = J.StructuredRandom((1, 16, 14), out, n_layers=n_layers, key=KEY(5))
    tp = T.StructuredRandom((1, 16, 14), out, n_layers=n_layers, device=DEV,
                            diagonals=[np.asarray(d) for d in jp.diagonals])
    x = np.random.default_rng(5).random((2, 1, 16, 14)).astype(np.float32)
    _parity(jp, tp, x, prox_tol=1e-4)


@pytest.mark.parametrize("ordering", ["sequency", "cake_cutting", "zig_zag", "xy"])
def test_single_pixel_camera_matches_jax(ordering):
    jp = J.SinglePixelCamera(m=100, img_size=(2, 16, 16), ordering=ordering)
    tp = T.SinglePixelCamera(m=100, img_size=(2, 16, 16), ordering=ordering, device=DEV)
    assert np.array_equal(tp.mask.numpy(), np.asarray(jp.mask))
    x = np.random.default_rng(6).random((2, 2, 16, 16)).astype(np.float32)
    _parity(jp, tp, x, dagger_tol=1e-5, prox_tol=1e-5)


def test_hadamard_transforms_and_exact_f32():
    """The dense product and the butterfly (n > 4096) against JAX; the
    orthonormal transform is its own inverse under the caller's bf16
    autocast."""
    rng = np.random.default_rng(7)
    u = rng.standard_normal((2, 8192)).astype(np.float32)
    _close(tspc.hadamard_1d(_t(u)), jspc.hadamard_1d(jnp.asarray(u)), 1e-5)
    x = rng.standard_normal((1, 1, 32, 64)).astype(np.float32)
    _close(tspc.hadamard_2d(_t(x)), jspc.hadamard_2d(jnp.asarray(x)), 1e-5)
    assert np.array_equal(tspc.sequency_order(64), jspc.sequency_order(64))
    with torch.autocast("cpu", dtype=torch.bfloat16):
        back = tspc.hadamard_2d(tspc.hadamard_2d(_t(x)))
    assert back.dtype == torch.float32 and _rel(back, x) <= 1e-6


# -- misc and pansharpening --------------------------------------------------------


def _misc_cases():
    rng = np.random.default_rng(8)
    x3 = rng.random((2, 3, 12, 10)).astype(np.float32)
    jh = J.HyperSpectralUnmixing(E=3, C=6, key=KEY(8))
    jc = J.CompressiveSpectralImaging((4, 12, 10), mode="ss", key=KEY(9))
    jd = J.CompressiveSpectralImaging((4, 12, 10), mode="sd", shear_dir="w", key=KEY(10))
    return {
        "decolorize": (J.Decolorize(), T.Decolorize(device=DEV), x3, 1e-5, None),
        "unmixing": (jh, T.HyperSpectralUnmixing(M=np.asarray(jh.M), device=DEV), x3, 1e-5,
                     None),
        "cassi_ss": (jc, T.CompressiveSpectralImaging((4, 12, 10), mode="ss", device=DEV,
                                                      mask=np.asarray(jc.mask)),
                     rng.random((2, 4, 12, 10)).astype(np.float32), None, 1e-4),
        "cassi_sd": (jd, T.CompressiveSpectralImaging((4, 12, 10), mode="sd", shear_dir="w",
                                                      device=DEV, mask=np.asarray(jd.mask)),
                     rng.random((2, 4, 12, 10)).astype(np.float32), None, 1e-4),
    }


@pytest.mark.parametrize("case", ["decolorize", "unmixing", "cassi_ss", "cassi_sd"])
def test_linear_misc_operators_match_jax(case):
    jp, tp, x, dagger_tol, prox_tol = _misc_cases()[case]
    _parity(jp, tp, x, dagger_tol=dagger_tol, prox_tol=prox_tol)


@pytest.mark.parametrize("gamma", [0.7, (0.3, 2.0)])
def test_decolorize_prox_solves_the_normal_equations(gamma):
    """``Decolorize.prox_l2`` solves ``(gamma A^T A + I) x = gamma A^T y + z``
    and agrees with the Krylov prox (scalar and per-sample gamma). The JAX
    package takes the square-``V`` closed form of ``DecomposablePhysics``
    here, which misses the channel directions the response does not span
    (ROADMAP Queue 3), so this one is held to the equations, not to JAX."""
    rng = np.random.default_rng(17)
    z, y = _t(rng.random((2, 3, 8, 8)).astype(np.float32)), _t(rng.random((2, 1, 8, 8)).astype(
        np.float32))
    p = T.Decolorize(srf=(0.2, 0.5, 0.3), device=DEV)
    g = torch.tensor(gamma).reshape(-1, 1, 1, 1) if isinstance(gamma, tuple) else gamma
    x = p.prox_l2(z, y, torch.tensor(gamma) if isinstance(gamma, tuple) else gamma)
    r = g * p.A_adjoint(p.A(x) - y) + x - z
    assert float(r.norm() / z.norm()) <= 1e-6
    xk = T.LinearPhysics.prox_l2(p, z, y, torch.tensor(gamma) if isinstance(gamma, tuple) else
                                 gamma, **KRYLOV)
    _close(x, xk, 1e-5)


def test_nonlinear_misc_operators_match_jax():
    rng = np.random.default_rng(9)
    im, d, a = (rng.random((2, 3, 8, 8)).astype(np.float32),
                rng.random((2, 1, 8, 8)).astype(np.float32) * 5,
                rng.random((2, 1, 1, 1)).astype(np.float32))
    jh, th = J.Haze(beta=0.2, offset=0.1), T.Haze(beta=0.2, offset=0.1)
    y = th.A(TensorList([_t(im), _t(d), _t(a)]))
    _close(y, jh.A(JTensorList([jnp.asarray(im), jnp.asarray(d), jnp.asarray(a)])), 1e-6)
    _close(th.A_dagger(y), jh.A_dagger(jnp.asarray(y.numpy())), 1e-5)
    jl, tl = J.SinglePhotonLidar(sigma=1.5, bins=30), T.SinglePhotonLidar(sigma=1.5, bins=30)
    xl = np.concatenate([rng.random((2, 1, 6, 6)) * 25, rng.random((2, 1, 6, 6)),
                         rng.random((2, 1, 6, 6)) * 0.1], 1).astype(np.float32)
    yl = tl.A(_t(xl))
    _close(yl, jl.A(jnp.asarray(xl)), 1e-6)
    _close(tl.A_dagger(yl), jl.A_dagger(jnp.asarray(yl.numpy())), 1e-5)
    xw = (rng.random((2, 1, 10, 10)) * 20 - 10).astype(np.float32)
    for mode in ("floor", "round"):
        jw, tw = J.SpatialUnwrapping(mode=mode), T.SpatialUnwrapping(mode=mode)
        yw = tw.A(_t(xw))
        _close(yw, jw.A(jnp.asarray(xw)), 1e-6)
        _close(tw.A_dagger(yw), jw.A_dagger(jnp.asarray(yw.numpy())), 1e-5)


def test_pansharpen_matches_jax():
    jp = J.Pansharpen((3, 16, 16), factor=4)
    tp = T.Pansharpen((3, 16, 16), factor=4, device=DEV)
    x = np.random.default_rng(10).random((2, 3, 16, 16)).astype(np.float32)
    _parity(jp, tp, x, prox_tol=1e-4)
    y = tp.A(_t(x))
    jy = JTensorList([jnp.asarray(v.numpy()) for v in y])
    _close(tp.brovey(y), jp.brovey(jy), 1e-5)


# -- the multiscale and cropping wrappers ------------------------------------------


def _wrapped(kind):
    f = np.asarray(jgaussian_blur(sigma=1.2))
    mask = (np.random.default_rng(11).random((1, 1, 16, 16)) < 0.6).astype(np.float32)
    if kind == "blur":
        return (J.Blur(filter=jnp.asarray(f), padding="reflect"),
                T.Blur(filter=_t(f), padding="reflect", device=DEV))
    if kind == "blur_fft":
        return J.BlurFFT((1, 16, 16), filter=jnp.asarray(f)), T.BlurFFT((1, 16, 16), _t(f),
                                                                        device=DEV)
    if kind == "inpainting":
        return (J.Inpainting((1, 16, 16), mask=jnp.asarray(mask)),
                T.Inpainting((1, 16, 16), mask=_t(mask), device=DEV))
    jcs = J.CompressedSensing(m=100, img_size=(1, 16, 16), key=KEY(12))
    return jcs, T.CompressedSensing(m=100, img_size=(1, 16, 16), matrix=np.asarray(jcs._A_mat),
                                    device=DEV)


@pytest.mark.parametrize("kind", ["blur", "blur_fft", "inpainting", "linear"])
def test_multiscale_wrappers_match_jax(kind):
    jb, tb = _wrapped(kind)
    jm = J.to_multiscale(jb, img_size=(1, 16, 16), factors=(2, 4))
    tm = T.to_multiscale(tb, img_size=(1, 16, 16), factors=(2, 4), device=DEV)
    assert type(tm).__name__ == type(jm).__name__
    rng = np.random.default_rng(13)
    for s, n in ((0, 16), (1, 8), (2, 4)):
        x = rng.random((2, 1, n, n)).astype(np.float32)
        y = np.asarray(jm.A(jnp.asarray(x), scale=s))
        with torch.no_grad():
            _close(tm.A(_t(x), scale=s), y, 1e-5)
            _close(tm.A_adjoint(_t(y), scale=s), jm.A_adjoint(jnp.asarray(y), scale=s), 1e-5)
            _close(tm.A_adjoint_A(_t(x), scale=s), jm.A_adjoint_A(jnp.asarray(x), scale=s),
                   1e-5)
            assert _adjoint_gap(tm.with_scale(s), _t(x), _t(y)) <= 1e-5
            if kind != "linear":
                _close(tm.downsample_measurement(_t(y), scale=s),
                       jm.downsample_measurement(jnp.asarray(y), scale=s), 1e-5)


def test_cropper_and_virtual_physics_match_jax():
    jb, tb = _wrapped("blur")
    jc, tc = J.PhysicsCropper(jb, (2, 3)), T.PhysicsCropper(tb, (2, 3))
    x = np.random.default_rng(14).random((2, 1, 18, 19)).astype(np.float32)
    _parity(jc, tc, x)
    jv = J.VirtualLinearPhysics(lambda: jb)
    tv = T.VirtualLinearPhysics(lambda: tb)
    _parity(jv, tv, x[..., 2:, 3:], prox_tol=1e-4)


# -- the slice as a whole ----------------------------------------------------------


@pytest.mark.parametrize("algo", ["HQS-spc", "PGD-cs"])
def test_pnp_on_single_pixel_and_compressed_sensing_matches_jax(algo):
    """8 iterations of PnP-HQS on the single-pixel camera (25% of the
    cake-cutting patterns) and of PnP-PGD on fast compressed sensing, 64²,
    B=2, with a depth-4 ``DnCNN(1, 1)`` crossed from JAX: f32 within 1e-4."""
    size = 64
    x = np.random.default_rng(15).random((2, 1, size, size)).astype(np.float32)
    name, op = algo.split("-")
    if op == "spc":
        jp = J.SinglePixelCamera(m=size * size // 4, img_size=(1, size, size),
                                 ordering="cake_cutting")
        tp = T.SinglePixelCamera(m=size * size // 4, img_size=(1, size, size),
                                 ordering="cake_cutting", device=DEV)
        params = {"stepsize": 1.0, "g_param": 0.05}
    else:
        jp = J.CompressedSensing(m=size * size // 4, img_size=(1, size, size), fast=True,
                                 key=KEY(16))
        tp = T.CompressedSensing(m=size * size // 4, img_size=(1, size, size), fast=True,
                                 D=np.asarray(jp.D), rows=np.asarray(jp.rows), device=DEV)
        params = {"stepsize": 1.0, "g_param": 0.05}
    y = np.asarray(jp.A(jnp.asarray(x)))
    jden, tden = _pair(1, 4, seed=4)
    jm = joptim_builder(name, data_fidelity=JL2(), prior=JPnP(jden), params_algo=params,
                        max_iter=8)
    want = np.asarray(jax.jit(lambda m, v, p: m(v, p))(jm, jnp.asarray(y), jp))
    tm = optim_builder(name, data_fidelity=L2(), prior=PnP(tden), params_algo=params,
                       max_iter=8, device=DEV)
    with torch.no_grad():
        got = tm(_t(y), tp).numpy()
    assert _rel(got, want) <= 1e-4
