"""The port's convolutions, blur filters and Blur / Downsampling / Upsampling
physics against the JAX package's, on the CPU.

Same inputs, made from a numpy seed, go through ``deepinv_tpu.ops.conv`` and
``deepinv_tpu.physics`` and their counterparts in the port. Bounds: outputs
within 1e-5 of JAX (f32, max abs error over the max), adjointness within 1e-4
relative, ``Downsampling.prox_l2`` within 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepinv_tpu.ops import conv as jconv
from deepinv_tpu.physics import Blur as JBlur
from deepinv_tpu.physics import Downsampling as JDownsampling
from deepinv_tpu.physics import DownsamplingMatlab as JDownsamplingMatlab
from deepinv_tpu.physics import SpaceVaryingBlur as JSpaceVaryingBlur
from deepinv_tpu.physics import Upsampling as JUpsampling
from deepinv_tpu_torch.ops import conv as tconv
from deepinv_tpu_torch.physics import (Blur, Downsampling, DownsamplingMatlab, SpaceVaryingBlur,
                                       Upsampling)

DEV = "cpu"
PADDINGS = ["valid", "circular", "replicate", "reflect", "constant", "zeros"]
FILTER_SHAPES = [(1, 1, 5, 4), (2, 3, 3, 3)]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _dot(a, b):
    return float((a.double() * b.double()).sum())


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("fshape", FILTER_SHAPES)
@pytest.mark.parametrize("padding", PADDINGS[:-1])
def test_conv2d_and_transpose_match_jax(padding, fshape):
    """conv2d and conv_transpose2d in every padding mode, with filters
    broadcast over batch and channel (b, c in {1, B} x {1, C}), odd and even
    sizes, true convolution and correlation."""
    rng = np.random.default_rng(len(padding) + fshape[-1])
    x = rng.standard_normal((2, 3, 13, 18)).astype(np.float32)
    f = rng.standard_normal(fshape).astype(np.float32)
    for corr in (False, True):
        want = jconv.conv2d(jnp.asarray(x), jnp.asarray(f), padding, correlation=corr)
        got = tconv.conv2d(_t(x), _t(f), padding, correlation=corr)
        assert got.shape == want.shape
        assert _rel(got.numpy(), want) <= 1e-5
        v = rng.standard_normal(want.shape).astype(np.float32)
        want_t = jconv.conv_transpose2d(jnp.asarray(v), jnp.asarray(f), padding, correlation=corr)
        got_t = tconv.conv_transpose2d(_t(v), _t(f), padding, correlation=corr)
        assert got_t.shape == want_t.shape == x.shape
        assert _rel(got_t.numpy(), want_t) <= 1e-5


@pytest.mark.parametrize("padding", PADDINGS)
def test_conv_transpose2d_is_the_adjoint(padding):
    """<conv2d(u), v> = <u, conv_transpose2d(v)> within 1e-4 relative in
    every mode (the padding's adjoint included), and the transpose is
    differentiable in its input."""
    rng = np.random.default_rng(7)
    u = torch.tensor(rng.standard_normal((2, 2, 17, 12)).astype(np.float32))
    f = torch.tensor(rng.standard_normal((1, 2, 5, 6)).astype(np.float32))
    Au = tconv.conv2d(u, f, padding)
    v = torch.tensor(rng.standard_normal(tuple(Au.shape)).astype(np.float32))
    lhs, rhs = _dot(Au, v), _dot(u, tconv.conv_transpose2d(v, f, padding))
    assert abs(lhs - rhs) <= 1e-4 * abs(lhs)
    vg = v.clone().requires_grad_()
    (g,) = torch.autograd.grad((tconv.conv_transpose2d(vg, f, padding) * u).sum(), vg)
    assert torch.allclose(g, Au, rtol=1e-4, atol=1e-4)


def test_bad_padding_and_filter_shape_raise():
    x = torch.zeros((2, 3, 8, 8))
    with pytest.raises(ValueError):
        tconv.conv2d(x, torch.zeros((1, 1, 3, 3)), "mirror")
    with pytest.raises(ValueError):
        tconv.conv2d(x, torch.zeros((3, 1, 3, 3)), "circular")


@pytest.mark.parametrize("factor", [2, 3, 4])
def test_filters_match_jax(factor):
    """bilinear, bicubic, windowed and plain sinc, Gaussian, and the Kaiser
    window, each against the JAX factory."""
    pairs = [(tconv.bilinear_filter(factor), jconv.bilinear_filter(factor)),
             (tconv.bicubic_filter(factor), jconv.bicubic_filter(factor)),
             (tconv.sinc_filter(factor, length=4 * factor), jconv.sinc_filter(factor, 4 * factor)),
             (tconv.sinc_filter(factor, 11, windowed=False),
              jconv.sinc_filter(factor, 11, windowed=False)),
             (tconv.gaussian_blur((factor, factor / 2), angle=30.0),
              jconv.gaussian_blur((factor, factor / 2), angle=30.0))]
    for got, want in pairs:
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        assert _rel(got.numpy(), want) <= 1e-5
        assert abs(float(got.sum()) - 1.0) <= 1e-5
    for beta in (0.0, 3.4, 8.0):
        assert _rel(tconv.kaiser_window(beta, 4 * factor), jconv.kaiser_window(beta, 4 * factor)) \
            <= 1e-6


@pytest.mark.parametrize("padding", ["valid", "circular", "replicate", "reflect", "constant"])
def test_blur_matches_jax(padding):
    """Blur's A and A_adjoint with an array PSF, and with a named filter."""
    rng = np.random.default_rng(3)
    x = rng.random((2, 3, 16, 20)).astype(np.float32)
    f = rng.random((1, 3, 5, 5)).astype(np.float32)
    for filt in (f, "bicubic"):
        jb = JBlur(filter=filt, padding=padding)
        tb = Blur(filter=filt, padding=padding, device=DEV)
        y = jb.A(jnp.asarray(x))
        assert _rel(tb.A(_t(x)).numpy(), y) <= 1e-5
        v = rng.standard_normal(y.shape).astype(np.float32)
        assert _rel(tb.A_adjoint(_t(v)).numpy(), jb.A_adjoint(jnp.asarray(v))) <= 1e-5
    # a filter passed at call time
    g = rng.random((1, 1, 3, 3)).astype(np.float32)
    assert _rel(tb.A(_t(x), filter=_t(g)).numpy(), jb.A(jnp.asarray(x), filter=jnp.asarray(g))) \
        <= 1e-5


@pytest.mark.parametrize("padding", ["valid", "circular", "reflect"])
def test_blur_volumetric_psf_waits(padding):
    """The 5-D Blur (a volumetric PSF, ``conv3d``) against JAX: A and
    A_adjoint of a 3-D ``gaussian_blur`` and of a PSF passed at call time."""
    rng = np.random.default_rng(7)
    x = rng.random((2, 1, 6, 10, 9)).astype(np.float32)
    psf = tconv.gaussian_blur(sigma=(1.0, 0.8, 1.2), psf_size=(3, 5, 5))
    jb, tb = JBlur(filter=psf.numpy(), padding=padding), Blur(filter=psf, padding=padding,
                                                              device=DEV)
    y = jb.A(jnp.asarray(x))
    assert tuple(tb.A(_t(x)).shape) == y.shape and _rel(tb.A(_t(x)).numpy(), y) <= 1e-5
    v = rng.standard_normal(y.shape).astype(np.float32)
    assert _rel(tb.A_adjoint(_t(v)).numpy(), jb.A_adjoint(jnp.asarray(v))) <= 1e-5
    lhs, rhs = _dot(tb.A(_t(x)), _t(v)), _dot(_t(x), tb.A_adjoint(_t(v)))
    assert abs(lhs - rhs) <= 1e-4 * abs(lhs)
    g = rng.random((1, 1, 2, 3, 3)).astype(np.float32)
    assert _rel(tb.A(_t(x), filter=_t(g)).numpy(), jb.A(jnp.asarray(x), filter=jnp.asarray(g))) \
        <= 1e-5


@pytest.mark.parametrize("factor", [2, 4])
@pytest.mark.parametrize("name", ["bicubic", "bilinear", "gaussian", "sinc"])
def test_downsampling_matches_jax(name, factor):
    """A, A_adjoint and the FFT polyphase prox_l2 (with a scalar and a
    per-sample gamma) against JAX; the adjoint within 1e-4 relative; the
    prox's optimality residual gamma A^T(Ax - y) + (x - z) ~ 0."""
    rng = np.random.default_rng(factor)
    x = rng.random((2, 3, 32, 32)).astype(np.float32)
    jd = JDownsampling(img_size=(3, 32, 32), filter=name, factor=factor)
    td = Downsampling(img_size=(3, 32, 32), filter=name, factor=factor, device=DEV)
    y = jd.A(jnp.asarray(x))
    got = td.A(_t(x))
    assert tuple(got.shape) == y.shape == (2, 3, 32 // factor, 32 // factor)
    assert _rel(got.numpy(), y) <= 1e-5
    v = rng.standard_normal(y.shape).astype(np.float32)
    assert _rel(td.A_adjoint(_t(v)).numpy(), jd.A_adjoint(jnp.asarray(v))) <= 1e-5
    lhs, rhs = _dot(got, _t(v)), _dot(_t(x), td.A_adjoint(_t(v)))
    assert abs(lhs - rhs) <= 1e-4 * abs(lhs)
    z = rng.standard_normal(x.shape).astype(np.float32)
    for gamma in (0.7, np.array([0.5, 2.0], np.float32)):
        want = jd.prox_l2(jnp.asarray(z), y, jnp.asarray(gamma))
        p = td.prox_l2(_t(z), _t(y), gamma if isinstance(gamma, float) else _t(gamma))
        assert _rel(p.numpy(), want) <= 1e-4
        g = torch.as_tensor(gamma).reshape(-1, 1, 1, 1)
        res = g * td.A_adjoint(td.A(p) - _t(y)) + (p - _t(z))
        assert float(res.abs().max()) <= 1e-4 * float(_t(z).abs().max())


def test_downsampling_overrides_and_parameters():
    """A filter and factor passed at call time, ``check_factor`` and
    ``get_filter_parameters``, and no filter at all (pure decimation)."""
    rng = np.random.default_rng(5)
    x = rng.random((1, 2, 24, 24)).astype(np.float32)
    jd = JDownsampling(img_size=(2, 24, 24), filter="gaussian", factor=2)
    td = Downsampling(img_size=(2, 24, 24), filter="gaussian", factor=2, device=DEV)
    assert _rel(td.A(_t(x), filter="bicubic", factor=3).numpy(),
                jd.A(jnp.asarray(x), filter="bicubic", factor=3)) <= 1e-5
    assert Downsampling.check_factor(torch.tensor([4, 4])) == 4 == Downsampling.check_factor(4.0)
    with pytest.raises(ValueError):
        Downsampling.check_factor(torch.tensor([2, 4]))
    params = Downsampling.get_filter_parameters(filter="bilinear", factor=np.array([3]))
    assert params["factor"] == 3
    assert _rel(params["filter"].numpy(), jconv.bilinear_filter(3)) == 0
    plain = Downsampling(img_size=(2, 24, 24), filter=None, factor=3, device=DEV)
    assert torch.equal(plain.A(_t(x)), _t(x)[:, :, ::3, ::3])
    y = rng.standard_normal((1, 2, 8, 8)).astype(np.float32)
    want = JDownsampling(img_size=(2, 24, 24), filter=None, factor=3).A_adjoint(jnp.asarray(y))
    assert _rel(plain.A_adjoint(_t(y)).numpy(), want) == 0


KRYLOV_CASES = {
    "reflect": ("down", dict(img_size=(1, 16, 16), filter="bicubic", factor=2, padding="reflect")),
    "no-filter": ("down", dict(img_size=(1, 16, 16), filter=None, factor=2)),
    "size-not-divided": ("down", dict(img_size=(1, 15, 15), filter="bicubic", factor=2)),
    "upsampling": ("up", dict(img_size=(1, 16, 16), filter="bicubic", factor=2)),
}


@pytest.mark.parametrize("case", list(KRYLOV_CASES))
def test_downsampling_krylov_prox_waits(case):
    """Where the JAX package falls back to its Krylov prox_l2 (a padding
    other than circular, no filter, a size the factor does not divide, and
    Upsampling), the port solves it by the same CG (the physics' defaults,
    50 iterations, tol 1e-4) from the same z: within 1e-4 of JAX, for a
    scalar and a per-sample gamma."""
    kind, kw = KRYLOV_CASES[case]
    jcls, tcls = (JDownsampling, Downsampling) if kind == "down" else (JUpsampling, Upsampling)
    jp, tp = jcls(**kw), tcls(**kw, device=DEV)
    rng = np.random.default_rng(21)
    C, H, W = kw["img_size"]
    x_shape = (2, C, H, W) if kind == "down" else (2, C, H // 2, W // 2)   # A upsamples
    x, z = (rng.random(x_shape).astype(np.float32) for _ in range(2))
    y = np.array(jp.A(jnp.asarray(x)))
    for gamma in (0.7, np.array([0.5, 3.0], np.float32)):
        want = jp.prox_l2(jnp.asarray(z), jnp.asarray(y), jnp.asarray(gamma))
        got = tp.prox_l2(_t(z), _t(y), gamma if isinstance(gamma, float) else _t(gamma))
        assert got.shape == x_shape and _rel(got.numpy(), want) <= 1e-4


@pytest.mark.parametrize("factor", [2, 4])
def test_upsampling_matches_jax(factor):
    rng = np.random.default_rng(11)
    x = rng.random((1, 3, 16, 16)).astype(np.float32)
    ju = JUpsampling(img_size=(3, 16 * factor, 16 * factor), filter="bicubic", factor=factor)
    tu = Upsampling(img_size=(3, 16 * factor, 16 * factor), filter="bicubic", factor=factor,
                    device=DEV)
    y = ju.A(jnp.asarray(x))
    assert _rel(tu.A(_t(x)).numpy(), y) <= 1e-5
    v = rng.standard_normal(y.shape).astype(np.float32)
    assert _rel(tu.A_adjoint(_t(v)).numpy(), ju.A_adjoint(jnp.asarray(v))) <= 1e-5


def test_polyphase_prox_is_ill_conditioned_at_large_gamma_in_both_packages():
    """The closed-form prox multiplies a difference of two O(1) spectra by
    gamma (blur.py:348): at gamma 7e5, the first step of DiffPIR at its
    default lambda on 4x super-resolution, f32 rounding moves it by ~2% in
    both packages alike. The port's f32 prox is as far from its float64
    version as the JAX one is; at moderate gamma both are within 1e-4."""
    rng = np.random.default_rng(0)
    x = rng.random((1, 1, 32, 32)).astype(np.float32)
    z = rng.random((1, 1, 32, 32)).astype(np.float32)
    jd = JDownsampling(img_size=(1, 32, 32), filter="bicubic", factor=2)
    td = Downsampling(img_size=(1, 32, 32), filter="bicubic", factor=2, device=DEV)
    y = np.asarray(jd.A(jnp.asarray(x)))
    for gamma, bound in ((1.0, 1e-5), (7e5, 1e-1)):
        exact = td.double().prox_l2(_t(z).double(), _t(y).double(), gamma).numpy()
        td.float()
        e_port = _rel(td.prox_l2(_t(z), _t(y), gamma).numpy(), exact)
        e_jax = _rel(jd.prox_l2(jnp.asarray(z), jnp.asarray(y), gamma), exact)
        assert e_port <= bound and e_jax <= bound
        assert e_port <= 2 * e_jax + 1e-6


def test_default_device_is_cuda():
    """Without ``device`` the physics goes to the CUDA device, and raises
    naming ``device="cpu"`` where there is none."""
    if torch.cuda.is_available():
        assert Downsampling((1, 8, 8), "bicubic", 2).filter.is_cuda
        return
    for make in (lambda: Blur(filter="bicubic"), lambda: Downsampling((1, 8, 8), "bicubic", 2),
                 lambda: Upsampling((1, 8, 8), "bicubic", 2)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            make()


@pytest.mark.parametrize("padding", ["valid", "circular"])
def test_space_varying_blur_matches_jax(padding):
    """Four Gaussian PSF branches of growing sigma with smooth multipliers
    summing to one, on RGB: A, A_adjoint, adjointness, and the Krylov
    ``prox_l2`` through the transpose."""
    rng = np.random.default_rng(11)
    H = W = 16
    x = rng.random((2, 3, H, W)).astype(np.float32)
    h = np.concatenate([tconv.gaussian_blur(sigma=s, psf_size=5).numpy() for s in
                        (0.5, 1.0, 1.5, 2.0)], axis=1)[:, None]       # (1, 1, 4, 5, 5)
    yy = np.linspace(0, 1, H, dtype=np.float32)[:, None] * np.ones((1, W), np.float32)
    m = np.stack([(1 - yy) ** 3, 3 * yy * (1 - yy) ** 2, 3 * yy ** 2 * (1 - yy), yy ** 3])[None, None]
    jb = JSpaceVaryingBlur(filters=jnp.asarray(h), multipliers=jnp.asarray(m), padding=padding)
    tb = SpaceVaryingBlur(filters=h, multipliers=m, padding=padding, device=DEV)
    assert torch.allclose(tb.multipliers.sum(2), torch.ones(()))
    y = jb.A(jnp.asarray(x))
    got = tb.A(_t(x))
    assert tuple(got.shape) == y.shape and _rel(got.numpy(), y) <= 1e-5
    v = rng.standard_normal(y.shape).astype(np.float32)
    assert _rel(tb.A_adjoint(_t(v)).numpy(), jb.A_adjoint(jnp.asarray(v))) <= 1e-5
    lhs, rhs = _dot(got, _t(v)), _dot(_t(x), tb.A_adjoint(_t(v)))
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)
    if padding == "circular":
        z = rng.standard_normal(x.shape).astype(np.float32)
        want = jb.prox_l2(jnp.asarray(z), y, 0.5)
        assert _rel(tb.prox_l2(_t(z), _t(np.asarray(y)), 0.5).numpy(), want) <= 1e-4


@pytest.mark.parametrize("factor", [2, 4])
def test_downsampling_matlab_matches_jax(factor):
    rng = np.random.default_rng(factor + 20)
    x = rng.random((2, 3, 32, 24)).astype(np.float32)
    jd = JDownsamplingMatlab(img_size=(3, 32, 24), factor=factor)
    td = DownsamplingMatlab(img_size=(3, 32, 24), factor=factor)
    y = jd.A(jnp.asarray(x))
    got = td.A(_t(x))
    assert tuple(got.shape) == y.shape == (2, 3, 32 // factor, 24 // factor)
    assert _rel(got.numpy(), y) <= 1e-5
    v = rng.standard_normal(y.shape).astype(np.float32)
    assert _rel(td.A_adjoint(_t(v)).numpy(), jd.A_adjoint(jnp.asarray(v))) <= 1e-5
    assert _rel(DownsamplingMatlab(factor=factor).A_adjoint(_t(v)).numpy(),
                jd.A_adjoint(jnp.asarray(v))) <= 1e-5
    lhs, rhs = _dot(got, _t(v)), _dot(_t(x), td.A_adjoint(_t(v)))
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)
    assert td.check_factor(np.array([factor, factor])) == factor
