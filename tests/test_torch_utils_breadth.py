"""The port's ``utils`` io, DICOM, functional, decorators and plotting against
the JAX package's, on the CPU, and the Trainer's plotting and MLOps
arguments.

The loaders read files each test writes from a numpy seed (``.mat`` through
scipy and v7.3 through h5py, NIfTI-1 and DICOM byte by byte, HDF5 through
h5py, TIFF through PIL) and are held exactly, with the same error types.
``functional`` is held at 1e-6 and ``resize_pad_square_tensor`` at 1e-5
(both antialias a shrink); the random draws are the port's own and are held
by shape, dtype, device, seed and moments. The plotting helpers' arrays are
held at 1e-6, and the figures are written under Agg. Also the repair of
``DistributedProcessing``'s split error, which now names the axis it tiles.
"""

import gzip
import os
import struct
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepinv_tpu.utils as jutils
import deepinv_tpu_torch.utils as tutils
from deepinv_tpu.core import TensorList as JTensorList
from deepinv_tpu_torch.core import TensorList

import test_torch_drunet  # noqa: F401  (each xdist worker takes its share of the cores)
from test_torch_named_datasets import _save_mat73, _write_dicom


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, want, tol):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


def _pair(seed, shape, complex_=False):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if complex_:
        a = (a + 1j * np.random.default_rng(seed + 1).standard_normal(shape)).astype(np.complex64)
    return torch.from_numpy(a), jnp.asarray(a)


# --------------------------------------------------------------- functional --
@pytest.mark.parametrize("case", ["complex", "two channels", "two channels flat"])
def test_complex_abs_matches_jax(case):
    t, j = _pair(0, (2, 2, 5, 6), complex_=case == "complex")
    keep = case != "two channels flat"
    _close(tutils.complex_abs(t, keepdims=keep), jutils.complex_abs(j, keepdims=keep), 1e-6)


@pytest.mark.parametrize("shape", [(1, 1, 5, 5), (2, 3, 8, 6), (4, 7)])
def test_diracs_match_jax(shape):
    """The impulse and the comb, alone and like a tensor or a TensorList."""
    _close(tutils.dirac(shape), jutils.dirac(shape), 0)
    for period in (2, 3):
        _close(tutils.dirac_comb(shape, period), jutils.dirac_comb(shape, period), 0)
    t = torch.zeros(shape, dtype=torch.float64)
    assert tutils.dirac_like(t).dtype == torch.float64
    _close(tutils.dirac_like(t), jutils.dirac_like(jnp.zeros(shape)), 0)
    tl = tutils.dirac_comb_like(TensorList([t, torch.zeros(3, 4)]), 2)
    jl = jutils.dirac_comb_like(JTensorList([jnp.zeros(shape), jnp.zeros((3, 4))]), 2)
    for u, v in zip(tl, jl):
        _close(u, v, 0)
    dl = tutils.dirac_like(TensorList([t]))
    assert isinstance(dl, TensorList) and float(dl[0].sum()) == np.prod(shape[:-2])


def test_ones_zeros_like_and_helpers():
    """``ones_like``/``zeros_like`` of a tensor and a TensorList; the device
    comparison and the timestamp's format."""
    t = torch.rand(2, 3, dtype=torch.float64)
    for f, g in ((tutils.ones_like, jutils.ones_like), (tutils.zeros_like, jutils.zeros_like)):
        _close(f(t), g(jnp.asarray(t.numpy())), 0)
        out = f(TensorList([t, t[0]]))
        assert isinstance(out, TensorList) and out[1].shape == (3,)
        assert out[0].dtype == torch.float64
    assert tutils.devices_equal(torch.device("cpu"), "cpu")
    assert not tutils.devices_equal("cpu", "cuda")
    ts = tutils.get_timestamp()
    assert len(ts) == len(jutils.get_timestamp()) and ts[2] == "-" and ts[8] == "-"


@pytest.mark.parametrize("mode", ["min_max", "clip"])
def test_normalize_signal_matches_jax(mode):
    t, j = _pair(2, (3, 2, 7, 5))
    _close(tutils.normalize_signal(t * 3, mode), jutils.normalize_signal(j * 3, mode), 1e-6)


@pytest.mark.parametrize("shape,size", [((2, 3, 40, 24), 16), ((1, 1, 10, 14), 32),
                                        ((1, 2, 33, 17), 20), ((2, 1, 12, 12), 12)])
def test_resize_pad_square_matches_jax(shape, size):
    """Shrinking (antialiased in both) and enlarging, then the zero pad, at
    1e-5."""
    x = np.random.default_rng(3).random(shape).astype(np.float32)
    _close(tutils.resize_pad_square_tensor(torch.from_numpy(x), size),
           jutils.resize_pad_square_tensor(jnp.asarray(x), size), 1e-5)


@pytest.mark.parametrize("fn", ["rand_like", "randn_like"])
def test_random_like_by_seed(fn):
    """The port's draws: shape, dtype and device of each member, one draw a
    TensorList member, the same for one seed, another for the next, and the
    moments of the law (JAX's keys cannot give the same bits)."""
    f = getattr(tutils, fn)
    x = torch.zeros(64, 64, 16, dtype=torch.float64)
    a, b, c = f(x, seed=3), f(x, seed=3), f(x, seed=4)
    assert a.shape == x.shape and a.dtype == torch.float64 and a.device == x.device
    assert torch.equal(a, b) and not torch.equal(a, c)
    g = torch.Generator().manual_seed(3)
    assert torch.equal(f(x, generator=g), a)
    mean, var = (0.5, 1 / 12) if fn == "rand_like" else (0.0, 1.0)
    assert abs(float(a.mean()) - mean) < 0.01 and abs(float(a.var()) / var - 1) < 0.02
    if fn == "rand_like":
        assert float(a.min()) >= 0 and float(a.max()) < 1
    tl = f(TensorList([torch.zeros(4, 5), torch.zeros(3, dtype=torch.float64)]), seed=1)
    assert isinstance(tl, TensorList) and tl[1].dtype == torch.float64
    assert not torch.equal(tl[0].reshape(-1)[:3], tl[1])
    jx = getattr(jutils, fn)(jnp.zeros((4, 5)), seed=1)
    assert jx.shape == tl[0].shape


def test_get_device_is_the_card_or_raises():
    """``get_device`` is ``resolve_device(None)``: the CUDA device, and a raise
    naming ``device="cpu"`` without one; no fallback to the CPU."""
    if torch.cuda.is_available():
        assert tutils.get_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            tutils.get_device()


# --------------------------------------------------------------- decorators --
def _record(call):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = call()
    return out, [(x.category, str(x.message)) for x in w]


def test_decorators_warn_as_jax():
    """Each helper: the same result, the same warnings (category and
    message) and the same errors as the JAX package's."""
    results = []
    for mod in (tutils, jutils):
        rec = []

        @mod.deprecated_alias(num_angles="angles")
        def f(angles=1):
            return angles

        @mod.deprecated_argument("old")
        def g(a=1):
            return a

        @mod.deprecated_func
        def h():
            return 3

        @mod.deprecated_class
        class K:
            def __init__(self, v):
                self.v = v

        def new(a):
            return a + 1

        red = mod.deprecated_func_replaced_by(new, redirect=True, since="0.2", remove_in="0.4",
                                              extra="See docs.")(lambda a: a)
        keep = mod.deprecated_func_replaced_by("pkg.new")(lambda a: -a)

        class Obj:
            pass

        o, o2 = Obj(), Obj()
        mod.deprecate_attribute(o, attr_name="alpha", attr_underscore_name="_alpha",
                                attr_initial_value=5, deprecation_message="alpha is old")
        mod.deprecate_attribute(o2, attr_name="alpha", attr_underscore_name="_alpha",
                                attr_initial_value=6, deprecation_message="alpha went")

        def touch():
            o.alpha = 7
            v = (o.alpha, o2.alpha)
            del o.alpha
            return v

        for call in (lambda: f(num_angles=4), lambda: f(angles=2), lambda: g(a=2, old=9),
                     lambda: h(), lambda: K(5).v, lambda: red(2), lambda: keep(2), touch):
            rec.append(_record(call))
        with pytest.raises(TypeError, match="Cannot specify both"):
            f(num_angles=1, angles=2)
        with pytest.raises(TypeError, match="redirect=True"):
            mod.deprecated_func_replaced_by("pkg.new", redirect=True)
        results.append(rec)
    assert results[0] == results[1]
    assert results[0][0][1] == [(DeprecationWarning, "Argument 'num_angles' is deprecated and "
                                 "will be removed in a future version. Use 'angles' instead.")]


# ------------------------------------------------------------- DICOM and io --
@pytest.mark.parametrize("apply_rescale", [True, False])
@pytest.mark.parametrize("as_tensor", [True, False])
def test_load_dicom_matches_jax(tmp_path, apply_rescale, as_tensor):
    """The reader in numpy: raw int16 or HU as float32, or a tensor on the
    device asked for; the same bits as JAX's."""
    arr = np.random.default_rng(5).integers(-1000, 2000, (16, 14), dtype=np.int16)
    p = str(tmp_path / "s.dcm")
    _write_dicom(p, arr, slope=2.0, intercept=-1024.0)
    got = tutils.load_dicom(p, as_tensor=as_tensor, apply_rescale=apply_rescale, device="cpu")
    want = jutils.load_dicom(p, as_tensor=as_tensor, apply_rescale=apply_rescale)
    if as_tensor:
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    else:
        assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert _np(got).dtype == np.asarray(want).dtype
    from deepinv_tpu_torch.utils.dicom import load_dicom

    np.testing.assert_array_equal(load_dicom(p, dtype=np.float64), arr.astype(np.float64))


def test_load_dicom_errors_match_jax(tmp_path):
    bad = tmp_path / "bad.dcm"
    bad.write_bytes(b"\x00" * 200)
    nopix = tmp_path / "nopix.dcm"
    nopix.write_bytes(b"\x00" * 128 + b"DICM" + struct.pack("<HH", 0x0028, 0x0010) + b"US"
                      + struct.pack("<H", 2) + struct.pack("<H", 4))
    for p, match in ((bad, "not a DICOM"), (nopix, "no PixelData")):
        for mod in (tutils, jutils):
            with pytest.raises(ValueError, match=match):
                mod.load_dicom(str(p))
    if not torch.cuda.is_available():
        _write_dicom(str(tmp_path / "ok.dcm"), np.zeros((2, 2), np.int16))
        with pytest.raises(RuntimeError, match='device="cpu"'):
            tutils.load_dicom(str(tmp_path / "ok.dcm"), as_tensor=True)


def _same_dict(a, b):
    keys = sorted(k for k in b if not k.startswith("__"))
    assert sorted(k for k in a if not k.startswith("__")) == keys
    for k in keys:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("kind", ["v5", "v7.3", "v7.3 by fallback"])
def test_load_mat_matches_jax(tmp_path, kind):
    """scipy's reader, and the HDF5 reader of v7.3 files: the axes back in
    MATLAB's order and complex compounds assembled, as in JAX."""
    rng = np.random.default_rng(6)
    p = str(tmp_path / "m.mat")
    real = rng.random((3, 4, 5))
    cplx = rng.normal(size=(4, 2, 3)) + 1j * rng.normal(size=(4, 2, 3))
    if kind == "v5":
        from scipy.io import savemat

        savemat(p, {"a": real, "c": cplx, "v": np.arange(6.0)})
        mat73 = False
    else:
        _save_mat73(p, "c", cplx)
        mat73 = kind == "v7.3"
        if not mat73:  # MATLAB's 128-byte header, which makes scipy refuse the file
            import h5py

            with h5py.File(p, "r") as f, h5py.File(p + ".ub", "w", userblock_size=512) as g:
                f.copy("c", g)
            head = b"MATLAB 7.3 MAT-file".ljust(116) + b"\x00" * 8 + b"\x00\x02IM"
            with open(p + ".ub", "r+b") as f:
                f.write(head)
            os.replace(p + ".ub", p)
    a, b = tutils.load_mat(p, mat73=mat73), jutils.load_mat(p, mat73=mat73)
    _same_dict(a, b)
    if kind != "v5":
        np.testing.assert_array_equal(a["c"], cplx)


def _write_nifti(path, arr, dtcode, scl_slope=0.0, scl_inter=0.0, gz=False, byteorder="<"):
    """A NIfTI-1 file: the 348-byte header and Fortran-ordered voxels at 352
    (tests/test_io_battery.py:24)."""
    hdr = bytearray(348)
    struct.pack_into(byteorder + "i", hdr, 0, 348)
    struct.pack_into(byteorder + "8h", hdr, 40, *([arr.ndim] + list(arr.shape)
                                                  + [1] * (7 - arr.ndim)))
    struct.pack_into(byteorder + "h", hdr, 70, dtcode)
    struct.pack_into(byteorder + "h", hdr, 72, arr.dtype.itemsize * 8)
    struct.pack_into(byteorder + "f", hdr, 108, 352.0)
    struct.pack_into(byteorder + "2f", hdr, 112, scl_slope, scl_inter)
    hdr[344:348] = b"n+1\x00"
    payload = bytes(hdr) + b"\x00" * 4 + np.asfortranarray(
        arr.astype(arr.dtype.newbyteorder(byteorder))).tobytes(order="F")
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(payload)


NIFTI = {
    "int16": dict(dtcode=4, dtype=np.int16),
    "float32 gz": dict(dtcode=16, dtype=np.float32, gz=True),
    "float64 big-endian": dict(dtcode=64, dtype=np.float64, byteorder=">"),
    "slope": dict(dtcode=4, dtype=np.int16, scl_slope=2.5, scl_inter=-3.0),
    "slope 0": dict(dtcode=4, dtype=np.int16, scl_slope=0.0, scl_inter=7.0),
    "NaN slope": dict(dtcode=2, dtype=np.uint8, scl_slope=float("nan"), scl_inter=1.0),
}


@pytest.mark.parametrize("case", list(NIFTI))
def test_load_nifti_matches_jax(tmp_path, case):
    """Each datatype, gz, either byte order, the slope and intercept rules,
    the cast and the memmap: the same bits as JAX's."""
    kw = dict(NIFTI[case])
    dtype = kw.pop("dtype")
    vol = (np.random.default_rng(7).random((7, 5, 3)) * 100).astype(dtype)
    p = str(tmp_path / ("v.nii.gz" if kw.get("gz") else "v.nii"))
    _write_nifti(p, vol, **kw)
    for opts in (dict(), dict(dtype=np.float64), dict(dtype=None), dict(as_memmap=True)):
        a, b = tutils.load_nifti(p, **opts), jutils.load_nifti(p, **opts)
        assert type(a) is type(b) and a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    bad = tmp_path / "x.nii"
    bad.write_bytes(b"\x00" * 352)
    for mod in (tutils, jutils):
        with pytest.raises(ValueError):
            mod.load_nifti(str(bad))


def test_load_ismrmd_and_np_match_jax(tmp_path):
    """Complex k-space stacked as (2, ...), a slab read by ``data_slice``, a
    dataset nested in a group, a missing one (KeyError); ``load_np``."""
    import h5py

    rng = np.random.default_rng(8)
    k = (rng.standard_normal((6, 4, 12, 9)) + 1j * rng.standard_normal((6, 4, 12, 9))).astype(
        np.complex64)
    p = str(tmp_path / "k.h5")
    with h5py.File(p, "w") as f:
        f["kspace"] = k
        f.create_group("dataset")["data"] = rng.random((3, 4)).astype(np.float32)
    for kw in (dict(), dict(data_slice=0), dict(data_slice=(0, slice(0, 2))),
               dict(data_name="data")):
        a, b = tutils.load_ismrmd(p, **kw), jutils.load_ismrmd(p, **kw)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for mod in (tutils, jutils):
        with pytest.raises(KeyError):
            mod.load_ismrmd(p, data_name="missing")
    np.save(tmp_path / "a.npy", k)
    np.testing.assert_array_equal(tutils.load_np(str(tmp_path / "a.npy")),
                                  jutils.load_np(str(tmp_path / "a.npy")))


@pytest.mark.parametrize("patch", [False, 4, (4, 6)])
def test_load_raster_and_tiff_match_jax(tmp_path, patch):
    """Without tifffile or rasterio both read through PIL: the same bands and
    patches (``patch_start``, a transform), and the same refusal of
    ``patch=True``."""
    from PIL import Image

    rgb = np.random.default_rng(9).integers(0, 255, (12, 18, 3), np.uint8)
    p = str(tmp_path / "r.tiff")
    Image.fromarray(rgb).save(p)
    np.testing.assert_array_equal(tutils.load_tiff(p), jutils.load_tiff(p))
    kw = dict(patch=patch, patch_start=(2, 3) if patch else (0, 0),
              transform=lambda q: q.astype(np.float32) * 2)
    a, b = tutils.load_raster(p, **kw), jutils.load_raster(p, **kw)
    a, b = (list(a), list(b)) if patch else ([a], [b])
    assert len(a) == len(b) > 0
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)
    for mod in (tutils, jutils):
        with pytest.raises(NotImplementedError):
            mod.load_raster(p, patch=True)


def test_url_example_and_cache_home_match_jax(monkeypatch, tmp_path):
    """``load_url`` and an unknown example raise ``DownloadError``; the
    synthetic examples are the same arrays; the cache and data homes."""
    for mod in (tutils, jutils):
        with pytest.raises(mod.DownloadError):
            mod.load_url("https://example.com/x.png")
        with pytest.raises(mod.DownloadError):
            mod.load_example("butterfly.png")
    assert issubclass(tutils.DownloadError, RuntimeError)
    for name, kw in (("SheppLogan", dict(size=32)), ("circles.png", dict(size=16, seed=2))):
        np.testing.assert_array_equal(tutils.load_example(name, **kw),
                                      jutils.load_example(name, **kw))
    monkeypatch.setenv("DEEPINV_CACHE_DIR", str(tmp_path))
    assert tutils.get_cache_home() == jutils.get_cache_home() == str(tmp_path)
    assert tutils.get_data_home() == jutils.get_data_home()
    monkeypatch.delenv("DEEPINV_CACHE_DIR")
    assert tutils.get_cache_home() == jutils.get_cache_home()


# ----------------------------------------------------------------- plotting --
@pytest.mark.parametrize("case", ["real", "two channels", "complex"])
def test_preprocess_and_prepare_match_jax(case):
    """``rescale_img``, ``preprocess_img`` (min-max with its scales, clip) and
    ``prepare_images`` (the panels, titles, grid and caption) at 1e-6; the
    port takes tensors."""
    c = 2 if case == "two channels" else 1
    x, jx = _pair(10, (2, c, 9, 7), complex_=case == "complex")
    y, jy = _pair(12, (2, c, 9, 7), complex_=case == "complex")
    _close(tutils.rescale_img(x.real * 3), jutils.rescale_img(jx.real * 3), 1e-6)
    _close(tutils.rescale_img(x.real * 3, "clip"), jutils.rescale_img(jx.real * 3, "clip"), 1e-6)
    a, sa = tutils.preprocess_img(x, return_scale=True)
    b, sb = jutils.preprocess_img(jx, return_scale=True)
    _close(a, b, 1e-6)
    np.testing.assert_allclose(sa, sb, rtol=1e-6)
    _close(tutils.preprocess_img(x, "clip", vmin=-0.5, vmax=0.5),
           jutils.preprocess_img(jx, "clip", vmin=-0.5, vmax=0.5), 1e-6)
    for mod in (tutils, jutils):
        with pytest.raises(ValueError, match="rescale_mode"):
            mod.preprocess_img(np.zeros((1, 1, 2, 2)), "bogus")
    pa = tutils.prepare_images(x=x, y=y, x_net=x * 0.5, x_nl=y[:, :, :, :])
    pb = jutils.prepare_images(x=jx, y=jy, x_net=jx * 0.5, x_nl=jy)
    for u, v in zip(pa[0], pb[0]):
        _close(u, v, 1e-6)
    assert pa[1] == pb[1] and pa[3] == pb[3]
    _close(pa[2], pb[2], 1e-6)
    pa = tutils.prepare_images(x=x, y=y[:, :, :4], x_net=x)
    pb = jutils.prepare_images(x=jx, y=jy[:, :, :4], x_net=jx)
    assert pa[1] == pb[1] == ["Ground truth", "Reconstruction"] and pa[3] == pb[3]


def test_plots_write_files(tmp_path):
    """Every figure under Agg, from tensors (bf16 ones too): the images, the
    curves, an unfolded model's parameters, the inset, the scatter, a video
    and an orthogonal view of a volume, each written where asked."""
    import matplotlib

    x = torch.rand(2, 3, 16, 16)
    out = {}
    out["plot"] = tutils.plot([x, x[:, :1].bfloat16()], titles=["a", "b"], suptitle="s",
                              save_fn=str(tmp_path / "plot.png"))
    out["curves"] = tutils.plot_curves({"psnr": torch.rand(2, 5), "loss": [3.0, 2.0, 1.0]},
                                       save_fn=str(tmp_path / "curves.png"))

    class Unfolded:
        params_algo = {"stepsize": torch.linspace(1, 0.5, 4), "lambda": 0.1}

    out["params"] = tutils.plot_parameters(Unfolded(), save_fn=str(tmp_path / "params.png"))
    out["inset"] = tutils.plot_inset([x, x[0, 0]], titles=["a", "b"],
                                     save_fn=str(tmp_path / "inset.png"))
    out["scatter"] = tutils.scatter_plot(torch.rand(20, 2), labels=np.arange(20) % 3,
                                         save_fn=str(tmp_path / "scatter.png"))
    for name, fig in out.items():
        assert isinstance(fig, matplotlib.figure.Figure), name
        assert (tmp_path / f"{name}.png").stat().st_size > 0
    vid = torch.rand(1, 1, 3, 8, 8)
    tutils.plot_videos([vid, vid * 2], titles=["a", "b"], save_fn=str(tmp_path / "v"))
    assert (tmp_path / "v.gif").stat().st_size > 0
    assert tutils.save_videos(vid, save_fn=str(tmp_path / "w")) == str(tmp_path / "w.gif")
    assert (tmp_path / "w.gif").stat().st_size > 0
    vol = torch.rand(1, 1, 6, 8, 10)
    tutils.plot_ortho3D([vol, vol[0, 0]], titles="v", save_fn=str(tmp_path / "ortho.png"))
    assert (tmp_path / "ortho.png").stat().st_size > 0
    assert isinstance(tutils.plot_ortho3D(vol, return_fig=True), matplotlib.figure.Figure)
    assert matplotlib.get_backend().lower() == "agg"


# ------------------------------------------------------------------ Trainer --
def _trainers(tmp_path, **kw):
    """The port's and JAX's Trainer on one tiny denoising problem, 2 epochs."""
    from deepinv_tpu.datasets import ArrayDataset as JArray
    from deepinv_tpu.datasets import DataLoader as JLoader
    from deepinv_tpu.models import ArtifactRemoval as JArtifact
    from deepinv_tpu.models import DnCNN as JDnCNN
    from deepinv_tpu.physics import Denoising as JDen
    from deepinv_tpu.physics import GaussianNoise as JNoise
    from deepinv_tpu.training import Trainer as JTrainer
    from deepinv_tpu_torch.datasets import ArrayDataset, DataLoader
    from deepinv_tpu_torch.models import ArtifactRemoval, DnCNN
    from deepinv_tpu_torch.physics import Denoising, GaussianNoise
    from deepinv_tpu_torch.training import Trainer

    xs = np.random.default_rng(11).random((4, 1, 8, 8)).astype(np.float32)
    m = ArtifactRemoval(DnCNN(1, 1, depth=2, nf=4, device="cpu"))
    t = Trainer(m, Denoising(GaussianNoise(0.1, device="cpu")),
                optimizer=torch.optim.Adam(m.parameters(), lr=1e-3),
                train_dataloader=DataLoader(ArrayDataset(xs), batch_size=2), epochs=2,
                online_measurements=True, verbose=False,
                **{k: (str(v) + "_port" if k == "save_folder_im" else v) for k, v in kw.items()})
    j = JTrainer(JArtifact(JDnCNN(1, 1, depth=2, nf=4, key=jax.random.key(0))),
                 JDen(JNoise(0.1)), train_dataloader=JLoader(JArray(xs), batch_size=2),
                 epochs=2, online_measurements=True, verbose=False,
                 **{k: (str(v) + "_jax" if k == "save_folder_im" else v) for k, v in kw.items()})
    return t, j


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_trainer_saves_images_where_jax_does(tmp_path):
    """``save_folder_im``: ``Training/epoch_{e}.png`` for each epoch in both
    trainers, the image counter at one an epoch."""
    t, j = _trainers(tmp_path, save_folder_im=tmp_path / "im")
    t.train()
    j.train()
    got, want = _tree(str(tmp_path / "im_port")), _tree(str(tmp_path / "im_jax"))
    assert got == want == [os.path.join("Training", "epoch_0.png"),
                           os.path.join("Training", "epoch_1.png")]
    assert t.img_counter == j.img_counter == 1
    assert (tmp_path / "im_port" / "Training" / "epoch_1.png").stat().st_size > 0


def test_trainer_mlops_and_plot_arguments(tmp_path, capsys):
    """wandb and mlflow, not installed: JAX's messages and logging off;
    ``plot_images`` every ``plot_interval`` epochs shows nothing under Agg;
    ``show_progress_bar`` silences the epoch line of ``verbose``."""
    kw = dict(wandb_vis=True, wandb_setup={"project": "p"}, mlflow_vis=True,
              plot_images=True, plot_interval=2, show_progress_bar=True)
    t, j = _trainers(tmp_path, **kw)
    lines = capsys.readouterr().out.splitlines()
    msgs = ["wandb not available; disabling wandb logging",
            "mlflow not available; disabling mlflow logging"]
    assert lines == msgs * 2
    t.verbose = j.verbose = True
    t.train()
    j.train()
    assert capsys.readouterr().out == ""
    t.log_metrics_mlops({"a": 1.0}, step=0)
    assert t._wandb is None and t._mlflow is None


# ------------------------------------------------------------------ repairs --
def test_processing_split_error_names_the_axis():
    """``tiling_dims=-1`` on a width that does not split: the message names
    columns (it named rows before); by rows it names rows."""
    from deepinv_tpu_torch.parallel import DistributedContext, DistributedProcessing

    ctx = DistributedContext(axis_names=("sp",), devices=[torch.device("cpu")] * 4)
    x = torch.rand(1, 1, 16, 18)
    with pytest.raises(ValueError, match="18 columns do not split into 4 bands"):
        DistributedProcessing(lambda v, s=None: v, ctx, tiling_dims=-1)(x)
    with pytest.raises(ValueError, match="14 rows do not split into 4 bands"):
        DistributedProcessing(lambda v, s=None: v, ctx, tiling_dims=-2)(x[..., :14, :16])
