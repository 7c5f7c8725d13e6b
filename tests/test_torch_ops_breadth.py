"""The port's ops and core breadth against the JAX package's, on the CPU:
the rest of ``TensorList``, the 3D and FFT convolutions and the N-D Gaussian
PSFs (``ops/conv.py``), ``ops/fourier.py``, ``ops/imresize.py``,
``ops/product_convolution.py``, ``ops/wavelets.py``, ``ops/misc.py`` and the
phantoms of ``datasets/phantoms.py``.

Inputs come from numpy seeds and go to both sides. Bounds (f32, max abs
error over the reference's max): convolutions and gathers 1e-5, FFT paths
1e-4 (the same as the FFT's own rounding at these sizes, ~1e-6), round trips
of orthonormal transforms 1e-5, adjointness ``|<Ax, y> - <x, A^T y>|``
within 1e-5 of ``||Ax|| ||y||``.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepinv_tpu.core as jcore
import deepinv_tpu.datasets as jdata
import deepinv_tpu_torch.core as tcore
import deepinv_tpu_torch.datasets as tdata

jconv = importlib.import_module("deepinv_tpu.ops.conv")
tconv = importlib.import_module("deepinv_tpu_torch.ops.conv")
jfourier = importlib.import_module("deepinv_tpu.ops.fourier")
tfourier = importlib.import_module("deepinv_tpu_torch.ops.fourier")
jimresize = importlib.import_module("deepinv_tpu.ops.imresize")
timresize = importlib.import_module("deepinv_tpu_torch.ops.imresize")
jpc = importlib.import_module("deepinv_tpu.ops.product_convolution")
tpc = importlib.import_module("deepinv_tpu_torch.ops.product_convolution")
jwav = importlib.import_module("deepinv_tpu.ops.wavelets")
twav = importlib.import_module("deepinv_tpu_torch.ops.wavelets")
jmisc = importlib.import_module("deepinv_tpu.ops.misc")
tmisc = importlib.import_module("deepinv_tpu_torch.ops.misc")

PADDINGS = ["valid", "circular", "replicate", "reflect", "constant"]


def _rel(a, b):
    a, b = np.asarray(a).astype(np.complex128), np.asarray(b).astype(np.complex128)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _t(a):
    return torch.tensor(np.asarray(a))


def _adjointness(A, At, x, y):
    Ax = A(x)
    return abs(float((Ax.double() * y.double()).sum() - (x.double() * At(y).double()).sum())) \
        / float(Ax.double().norm() * y.double().norm())


def test_tensorlist_additions_match_jax():
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((2, 3)).astype(np.float32), rng.standard_normal(4).astype(np.float32)
    J, T = jcore.TensorList([jnp.asarray(a), jnp.asarray(b)]), tcore.TensorList([_t(a), _t(b)])
    pairs = [((T ** 2).x, (J ** 2).x), (abs(T).x, abs(J).x), (T.abs().x, J.abs().x),
             (T.max().x, J.max().x), (T.numpy(), J.numpy()), ((T > 0).x, (J > 0).x),
             ((T < 0.1).x, (J < 0.1).x), (T.isnan().x, J.isnan().x),
             (T.unsqueeze(0).squeeze(0).x, J.unsqueeze(0).squeeze(0).x),
             (T.reshape([(3, 2), (2, 2)]).x, J.reshape([(3, 2), (2, 2)]).x),
             (T.astype(torch.float64).x, J.astype(jnp.float32).x),
             (T.append(_t(b)).x, J.append(jnp.asarray(b)).x), (T.append(T)[2:].x, J.x),
             (tcore.zeros_like(T).x, jcore.zeros_like(J).x),
             (tcore.ones_like(T).x, jcore.ones_like(J).x)]
    for got, want in pairs:
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert tuple(g.shape) == tuple(w.shape) and np.allclose(np.asarray(g), np.asarray(w))
    assert T.shape == [torch.Size([2, 3]), torch.Size([4])] and T.dtype == [torch.float32] * 2
    assert T.numel() == J.numel() == 10 and (T > -100).all() and (T > 0).any()
    assert not T.isnan().any() and not (T > 100).any() and T.squeeze().shape == T.shape
    assert isinstance(T[1:], tcore.TensorList) and T[1] is T.x[1]


def test_random_like_draws():
    """``randn_like`` and ``rand_like`` on a TensorList with a complex
    member: shapes and dtypes kept, draws reproducible from the generator,
    the complex member of unit variance (halves of 1/2)."""
    y = tcore.TensorList([torch.zeros((400, 50)), torch.zeros((300, 60), dtype=torch.complex64)])
    n1 = tcore.randn_like(torch.Generator().manual_seed(1), y)
    n2 = tcore.randn_like(torch.Generator().manual_seed(1), y)
    assert all(torch.equal(a, b) for a, b in zip(n1, n2))
    assert [v.dtype for v in n1] == [torch.float32, torch.complex64]
    assert abs(float(n1[0].var()) - 1) < 0.05 and abs(float(n1[1].abs().pow(2).mean()) - 1) < 0.05
    assert abs(float(n1[1].real.var()) - 0.5) < 0.03
    u = tcore.rand_like(torch.Generator().manual_seed(2), y[0])
    assert u.shape == y[0].shape and 0 <= float(u.min()) and float(u.max()) < 1
    assert abs(float(u.mean()) - 0.5) < 0.01


@pytest.mark.parametrize("padding", PADDINGS)
def test_conv2d_fft_matches_jax(padding):
    rng = np.random.default_rng(len(padding))
    x = rng.standard_normal((2, 3, 13, 18)).astype(np.float32)
    f = rng.standard_normal((1, 3, 5, 4)).astype(np.float32)
    want = jconv.conv2d_fft(jnp.asarray(x), jnp.asarray(f), padding)
    got = tconv.conv2d_fft(_t(x), _t(f), padding)
    assert tuple(got.shape) == want.shape and _rel(got, want) <= 1e-4
    v = rng.standard_normal(want.shape).astype(np.float32)
    assert _rel(tconv.conv_transpose2d_fft(_t(v), _t(f), padding),
                jconv.conv_transpose2d_fft(jnp.asarray(v), jnp.asarray(f), padding)) <= 1e-4
    assert _adjointness(lambda a: tconv.conv2d_fft(a, _t(f), padding),
                        lambda b: tconv.conv_transpose2d_fft(b, _t(f), padding), _t(x), _t(v)) \
        <= 1e-5
    if padding in ("valid", "circular"):   # the spatial convolution computes the same
        assert _rel(got, tconv.conv2d(_t(x), _t(f), padding)) <= 1e-4


def test_conv2d_fft_complex_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 2, 8, 10)).astype(np.float32)
    f = rng.standard_normal((1, 1, 3, 3)).astype(np.float32)
    want = jconv.conv2d_fft(jnp.asarray(x), jnp.asarray(f), real_fft=False)
    got = tconv.conv2d_fft(_t(x), _t(f), real_fft=False)
    assert got.is_complex() and _rel(got.numpy(), want) <= 1e-4
    assert _rel(got.real, tconv.conv2d(_t(x), _t(f), "circular")) <= 1e-4


@pytest.mark.parametrize("padding", PADDINGS)
def test_conv3d_and_transpose_match_jax(padding):
    rng = np.random.default_rng(10 + len(padding))
    x = rng.standard_normal((2, 2, 7, 9, 8)).astype(np.float32)
    f = rng.standard_normal((2, 1, 3, 4, 3)).astype(np.float32)
    for corr in (False, True):
        want = jconv.conv3d(jnp.asarray(x), jnp.asarray(f), padding, correlation=corr)
        got = tconv.conv3d(_t(x), _t(f), padding, correlation=corr)
        assert tuple(got.shape) == want.shape and _rel(got, want) <= 1e-5
        v = rng.standard_normal(want.shape).astype(np.float32)
        assert _rel(tconv.conv_transpose3d(_t(v), _t(f), padding, correlation=corr),
                    jconv.conv_transpose3d(jnp.asarray(v), jnp.asarray(f), padding,
                                           correlation=corr)) <= 1e-5


def test_conv3d_fft_matches_jax_and_conv3d():
    rng = np.random.default_rng(20)
    x = rng.standard_normal((1, 2, 6, 9, 8)).astype(np.float32)
    f = rng.standard_normal((1, 2, 3, 4, 3)).astype(np.float32)
    want = jconv.conv3d_fft(jnp.asarray(x), jnp.asarray(f))
    got = tconv.conv3d_fft(_t(x), _t(f))
    assert _rel(got, want) <= 1e-4
    assert _rel(got, tconv.conv3d(_t(x), _t(f), "circular")) <= 1e-4
    assert _rel(tconv.conv_transpose3d_fft(_t(x), _t(f)),
                jconv.conv_transpose3d_fft(jnp.asarray(x), jnp.asarray(f))) <= 1e-4
    assert _rel(tconv.conv3d_fft(_t(x), _t(f), real_fft=False).real,
                jconv.conv3d_fft(jnp.asarray(x), jnp.asarray(f), real_fft=False).real) <= 1e-4
    with pytest.raises(NotImplementedError):
        tconv.conv3d_fft(_t(x), _t(f), "reflect")


@pytest.mark.parametrize("args", [
    dict(sigma=(2.0,), psf_size=(9,)),
    dict(sigma=(1.0, 2.0, 1.5)),
    dict(sigma=(1.0, 2.0, 1.5), angle=(10.0, 20.0, 30.0)),
    dict(sigma=1.3, angle=25.0),
    dict(sigma=np.array([[1.0, 2.0], [0.5, 1.5]], np.float32),
         angle=np.array([10.0, 30.0], np.float32), psf_size=(7, 9)),
    dict(sigma=np.array([[1.0, 2.0, 1.5], [0.7, 1.0, 2.0]], np.float32),
         angle=np.array([[10.0, 20.0, 30.0], [0.0, 45.0, 5.0]], np.float32), psf_size=(5, 7, 9)),
], ids=["1d", "3d", "3d-rotated", "2d-rotated", "2d-batched", "3d-batched"])
def test_gaussian_blur_nd_matches_jax(args):
    """1D, 3D and batched PSFs (the JAX package takes a batch as a jax
    array, the port as a numpy array or a tensor)."""
    want = jconv.gaussian_blur(**{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                                  for k, v in args.items()})
    got = tconv.gaussian_blur(**args)
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    assert _rel(got, want) <= 1e-6
    if isinstance(args["sigma"], np.ndarray):
        assert _rel(tconv.gaussian_blur(**{k: _t(v) if isinstance(v, np.ndarray) else v
                                           for k, v in args.items()}), want) <= 1e-6


def test_fourier_transforms_match_jax():
    rng = np.random.default_rng(30)
    x = rng.standard_normal((2, 3, 12, 10)).astype(np.float32)
    jx, tx = jnp.asarray(x), _t(x)
    for got, want in [(tfourier.dct1d(tx, axis=-2), jfourier.dct1d(jx, axis=-2)),
                      (tfourier.dct1d(tx, ortho=False), jfourier.dct1d(jx, ortho=False)),
                      (tfourier.dct2(tx), jfourier.dct2(jx)),
                      (tfourier.idct2(tx), jfourier.idct2(jx)),
                      (tfourier.idct1d(tx, axis=1), jfourier.idct1d(jx, axis=1)),
                      (tfourier.dst1(tx), jfourier.dst1(jx)),
                      (tfourier.dst1(tx, axes=(-1,), ortho=False),
                       jfourier.dst1(jx, axes=(-1,), ortho=False))]:
        assert _rel(got, want) <= 1e-5
    assert _rel(tfourier.idct2(tfourier.dct2(tx)), x) <= 1e-5
    assert _rel(tfourier.dst1(tfourier.dst1(tx)), x) <= 1e-5
    z = (rng.standard_normal((2, 8, 12)) + 1j * rng.standard_normal((2, 8, 12))).astype(
        np.complex64)
    assert _rel(tfourier.fftc(_t(z)).numpy(), jfourier.fftc(jnp.asarray(z))) <= 1e-5
    assert _rel(tfourier.ifftc(_t(z), axes=(-1,)).numpy(),
                jfourier.ifftc(jnp.asarray(z), axes=(-1,))) <= 1e-5


@pytest.mark.parametrize("scale,out_shape", [(0.5, None), (0.25, None), (2.0, None),
                                             (None, (9, 14))])
def test_imresize_matlab_matches_jax(scale, out_shape):
    rng = np.random.default_rng(40)
    x = rng.random((2, 3, 24, 20)).astype(np.float32)
    want = jimresize.imresize_matlab(jnp.asarray(x), scale=scale, out_shape=out_shape)
    got = timresize.imresize_matlab(_t(x), scale=scale, out_shape=out_shape)
    assert tuple(got.shape) == want.shape and _rel(got, want) <= 1e-5


@pytest.mark.parametrize("padding,use_fft", [("valid", False), ("circular", False),
                                             ("reflect", False), ("circular", True)])
def test_product_convolution_matches_jax(padding, use_fft):
    rng = np.random.default_rng(50 + use_fft)
    x = rng.standard_normal((2, 2, 16, 14)).astype(np.float32)
    w = rng.random((1, 2, 3, 16, 14)).astype(np.float32)
    h = rng.random((1, 1, 3, 5, 5)).astype(np.float32)
    want = jpc.product_convolution2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(h), padding,
                                     use_fft)
    got = tpc.product_convolution2d(_t(x), _t(w), _t(h), padding, use_fft)
    assert tuple(got.shape) == want.shape and _rel(got, want) <= (1e-4 if use_fft else 1e-5)
    v = rng.standard_normal(want.shape).astype(np.float32)
    assert _rel(tpc.product_convolution2d_adjoint(_t(v), _t(w), _t(h), padding, use_fft),
                jpc.product_convolution2d_adjoint(jnp.asarray(v), jnp.asarray(w),
                                                  jnp.asarray(h), padding, use_fft)) <= 1e-4
    assert _adjointness(lambda a: tpc.product_convolution2d(a, _t(w), _t(h), padding, use_fft),
                        lambda b: tpc.product_convolution2d_adjoint(b, _t(w), _t(h), padding,
                                                                    use_fft), _t(x), _t(v)) <= 1e-5
    assert torch.equal(tpc.multiplier(_t(x), _t(w)[:, :, 0]), _t(x) * _t(w)[:, :, 0])


@pytest.mark.parametrize("wavelet,level,ndim,shape", [
    ("haar", 2, 2, (2, 1, 16, 16)), ("db4", 3, 2, (1, 2, 29, 35)),
    ("db2", 2, 3, (1, 1, 8, 12, 9))])
def test_wavelets_match_jax(wavelet, level, ndim, shape):
    """The coefficients, the round trip and the helpers; odd sizes take the
    symmetric padding. The other filters differ only in their table, held
    equal to the JAX package's."""
    rng = np.random.default_rng(60 + level)
    x = rng.standard_normal(shape).astype(np.float32)
    jw, tw = jwav.WaveletTransform(wavelet, level, ndim), twav.WaveletTransform(wavelet, level,
                                                                               ndim)
    want, got = jw.dwt2(jnp.asarray(x)), tw.dwt2(_t(x))
    assert got["orig_shape"] == tuple(want["orig_shape"])
    assert _rel(got["coeffs"][0], want["coeffs"][0]) <= 1e-5
    for gd, wd in zip(got["coeffs"][1:], want["coeffs"][1:]):
        assert len(gd) == len(wd) == 2 ** ndim - 1
        for g, w in zip(gd, wd):
            assert tuple(g.shape) == w.shape and _rel(g, w) <= 1e-5
    assert _rel(tw.idwt2(got), x) <= 1e-5
    assert _rel(tw.flat_coeffs(got), jw.flat_coeffs(want)) <= 1e-5
    shrunk = tw.map_detail(got, lambda c: 0.5 * c)
    assert _rel(tw.idwt2(shrunk), jw.idwt2(jw.map_detail(want, lambda c: 0.5 * c))) <= 1e-5
    assert twav.WAVELET_FILTERS == jwav.WAVELET_FILTERS


def test_histograms_match_jax():
    rng = np.random.default_rng(70)
    x = rng.standard_normal((500, 2)).astype(np.float32)
    w = rng.random(500).astype(np.float32)
    for kw in (dict(bins=8), dict(bins=(4, 6), low=-1.0, upp=(1.0, 2.0), weights=w),
               dict(bins=5, low=-2.0, upp=2.0, bounded=True)):
        wj = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
        hj, ej = jmisc.histogramdd(jnp.asarray(x), **wj)
        ht, et = tmisc.histogramdd(_t(x), **{k: _t(v) if isinstance(v, np.ndarray) else v
                                            for k, v in kw.items()})
        assert tuple(ht.shape) == hj.shape and np.allclose(ht.numpy(), hj, atol=1e-4)
        for a, b in zip(et, ej):
            assert _rel(a, b) <= 1e-6
    h1, e1 = tmisc.histogram(_t(x[:, 0]), bins=7)
    hj1, ej1 = jmisc.histogram(jnp.asarray(x[:, 0]), bins=7)
    assert np.array_equal(h1.numpy(), np.asarray(hj1)) and float(h1.sum()) == 500


def test_random_choice_draws():
    g = torch.Generator().manual_seed(0)
    a = torch.arange(10, 20)
    s = tmisc.random_choice(g, a, shape=(3, 4))
    assert s.shape == (3, 4) and bool(((s >= 10) & (s < 20)).all())
    u = tmisc.random_choice(g, 10, shape=(10,), replace=False)
    assert sorted(u.tolist()) == list(range(10))
    p = torch.tensor([0.0, 0.0, 1.0, 0.0])
    assert tmisc.random_choice(g, 4, shape=(5,), p=p).tolist() == [2] * 5
    draws = tmisc.random_choice(g, 3, shape=(6000,), p=[0.2, 0.3, 0.5])
    freq = torch.bincount(draws, minlength=3).float() / 6000
    assert torch.allclose(freq, torch.tensor([0.2, 0.3, 0.5]), atol=0.03)
    same = [tmisc.random_choice(torch.Generator().manual_seed(3), 50, shape=(8,)) for _ in range(2)]
    assert torch.equal(*same)
    with pytest.raises(ValueError):
        tmisc.random_choice(g, 3, shape=(4,), replace=False)


def test_thin_plate_spline_matches_jax():
    rng = np.random.default_rng(80)
    X = rng.random((12, 2)).astype(np.float32)
    Y = rng.standard_normal((12, 3)).astype(np.float32)
    Yb = rng.standard_normal((2, 1, 12, 2)).astype(np.float32)
    Q = rng.random((20, 2)).astype(np.float32)
    for y, alpha in ((Y, 0.0), (Yb, 0.1)):
        want = jmisc.ThinPlateSpline(alpha).fit(jnp.asarray(X), jnp.asarray(y)).transform(
            jnp.asarray(Q))
        tps = tmisc.ThinPlateSpline(alpha).fit(_t(X), _t(y))
        got = tps.transform(_t(Q))
        assert tuple(got.shape) == want.shape and _rel(got, want) <= 1e-4
    # at alpha 0 the spline interpolates its control points
    assert _rel(tmisc.ThinPlateSpline().fit(_t(X), _t(Y)).transform(_t(X)), Y) <= 1e-4


def test_phantoms_match_jax():
    assert np.array_equal(tdata.shepp_logan(64), jdata.shepp_logan(64))
    assert np.array_equal(tdata.random_circles(32, seed=3, channels=2),
                          jdata.random_circles(32, seed=3, channels=2))
    rp = importlib.import_module("deepinv_tpu.datasets.phantoms")
    assert np.array_equal(tdata.generate_random_phantom(32, rng=np.random.RandomState(1)),
                          rp.generate_random_phantom(32, rng=np.random.RandomState(1)))
    for tds, jds in ((tdata.SheppLoganDataset(32, n_data=2, length=3),
                      jdata.SheppLoganDataset(32, n_data=2, length=3)),
                     (tdata.RandomPhantomDataset(3, size=24, n_data=2, seed=5),
                      jdata.RandomPhantomDataset(3, size=24, n_data=2, seed=5))):
        assert len(tds) == len(jds) == 3
        for i in range(3):
            assert np.array_equal(tds[i], jds[i]) and tds[i].shape[0] == 2
        assert isinstance(tds, tdata.ImageDataset)
        tds.check_dataset()
