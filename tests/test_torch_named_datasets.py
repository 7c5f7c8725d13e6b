"""The port's named datasets against the JAX package's, on the CPU: fastMRI
(the slice index, the metadata cache, ``torch_shuffle``, ``MRISliceTransform``
and ``save_simple_dataset``), CMRxRecon, SKM-TEA, LIDC-IDRI, NBU, FMD and
Köhler. Each test writes its files from a numpy seed (h5 through h5py,
``.mat`` through scipy and v7.3 through h5py, DICOM through the writer of
tests/test_io_battery.py, PNG through PIL) and both packages read the same
files. Items are held exactly where both sides are numpy, and to 1e-5 where
the port's MRIMixin FFT stands in for ``jnp.fft``. The random masks and
noise are the port's own (a ``torch.Generator`` where JAX has a key): the
transform is held with a stub generator that returns a fixed mask, and the
port's draws by their determinism per sample.
"""

import os
import struct
import warnings

import numpy as np
import pytest
import torch

import deepinv_tpu.datasets as jds
import deepinv_tpu_torch.datasets as tds
from deepinv_tpu_torch.core import TensorList

import test_torch_drunet  # noqa: F401  (each xdist worker takes its share of the cores)


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _same(got, want):
    """Equal structure and bits: tuples, dicts and arrays."""
    if isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _same(got[k], want[k])
    else:
        g, w = _np(got), _np(want)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _close(got, want, rtol):
    """Equal structure; arrays within ``rtol`` of the largest magnitude."""
    if isinstance(want, (tuple, list)):
        for g, w in zip(got, want):
            _close(g, w, rtol)
    elif isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], rtol)
    else:
        g, w = _np(got), _np(want)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol * float(np.abs(w).max()))


# ------------------------------------------------------------------ fastMRI --
@pytest.fixture(scope="module")
def fastmri_root(tmp_path_factory):
    """Two 4-coil volumes of 3 slices (64², one with a reconstruction_rss) and
    a single-coil one of 5 slices (48x56, with neither reconstruction)."""
    import h5py

    root = tmp_path_factory.mktemp("fastmri")
    rng = np.random.default_rng(40)
    for i, (shape, rss) in enumerate([((3, 4, 64, 64), True), ((3, 4, 64, 64), False),
                                      ((5, 48, 56), False)]):
        ksp = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
        with h5py.File(root / f"file{i}.h5", "w") as f:
            f.create_dataset("kspace", data=ksp)
            if rss:
                f.create_dataset("reconstruction_rss",
                                 data=rng.random((shape[0],) + shape[-2:]).astype(np.float32))
    return str(root)


@pytest.mark.parametrize("slice_index", ["all", "middle", "middle+1", 1, [0, 2], "random"])
def test_fastmri_items_match_jax(fastmri_root, slice_index):
    """The same slices in the same order, and each item the same bits: the
    stored RSS target, or the RSS of the inverse FFT in numpy."""
    a = tds.FastMRISliceDataset(fastmri_root, slice_index=slice_index)
    b = jds.FastMRISliceDataset(fastmri_root, slice_index=slice_index)
    assert a.samples == b.samples and len(a) == len(b) > 0
    for i in range(len(b)):
        _same(a[i], b[i])


def test_fastmri_metadata_cache_crosses(fastmri_root, tmp_path):
    """A cache written by one package is read by the other; a cache without
    the root raises the same error, a missing one warns in both."""
    cache = str(tmp_path / "cache.pkl")
    a = tds.FastMRISliceDataset(fastmri_root, save_metadata_to_cache=True,
                                metadata_cache_file=cache)
    b = jds.FastMRISliceDataset(fastmri_root, load_metadata_from_cache=True,
                                metadata_cache_file=cache)
    assert a.samples == b.samples
    c = tds.FastMRISliceDataset(fastmri_root, load_metadata_from_cache=True,
                                metadata_cache_file=cache)
    assert c.samples == a.samples
    for cls in (tds.FastMRISliceDataset, jds.FastMRISliceDataset):
        with pytest.raises(ValueError, match="metadata"):
            cls(str(tmp_path), load_metadata_from_cache=True, metadata_cache_file=cache)
        with pytest.warns(UserWarning, match="Couldn't find dataset cache"):
            cls(fastmri_root, load_metadata_from_cache=True,
                metadata_cache_file=str(tmp_path / "none.pkl"))
    for cls in (tds.FastMRISliceDataset, jds.FastMRISliceDataset):
        with pytest.raises(FileNotFoundError):
            cls(str(tmp_path))


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_torch_shuffle_matches_jax_by_seed(seed):
    """An int seed gives numpy's ``default_rng(seed)`` order in both; a
    ``torch.Generator`` gives a permutation, the same for the same seed."""
    x = [f"file{i}.h5" for i in range(23)]
    assert (tds.FastMRISliceDataset.torch_shuffle(x, seed=seed)
            == jds.FastMRISliceDataset.torch_shuffle(x, seed=seed))
    g1 = tds.FastMRISliceDataset.torch_shuffle(x, torch.Generator().manual_seed(seed))
    g2 = tds.FastMRISliceDataset.torch_shuffle(x, torch.Generator().manual_seed(seed))
    assert g1 == g2 and sorted(g1) == sorted(x)


class _StubMaskGenerator:
    """A mask generator whose step returns a fixed ``(1, H, W)`` mask, with
    the JAX (``key=``) and the port (``generator=``) signatures; it records
    whether each call was seeded."""

    def __init__(self, mask, n_center=None):
        self.mask = mask
        if n_center is not None:
            self.n_center = n_center
        self.seeded = []

    def step(self, batch_size=1, key=None, generator=None, **kwargs):
        self.seeded.append(key is not None or generator is not None)
        return {"mask": self.mask[None]}


TRANSFORMS = {
    "prewhiten": dict(prewhiten=True),
    "normalize": dict(normalize=True, acs=12),
    "normalize by max": dict(normalize=2.0),
    "maps": dict(estimate_coil_maps=10),
    "stub mask": dict(mask=True, seed_mask_generator=True),
    "all": dict(mask=True, prewhiten=(slice(0, 16), slice(0, 16)), normalize=True,
                estimate_coil_maps=True),
}


@pytest.mark.parametrize("case", list(TRANSFORMS))
def test_mri_slice_transform_matches_jax(fastmri_root, case):
    """Prewhitening, normalization, the low-res coil maps and a stub mask
    through the dataset, at 1e-5; the stub is seeded per sample in both."""
    kw = dict(TRANSFORMS[case])
    masks = []
    if kw.pop("mask", False):
        mask = (np.random.default_rng(41).random((64, 64)) < 0.4).astype(np.float32)
        masks = [_StubMaskGenerator(mask, n_center=8) for _ in range(2)]
    outs = []
    for pkg, stub in zip((tds, jds), masks or [None, None]):
        tf = pkg.MRISliceTransform(mask_generator=stub, **kw)
        ds = pkg.FastMRISliceDataset(fastmri_root, slice_index="middle+1", transform=tf)
        outs.append([ds[i] for i in range(6)])  # the two 4-coil volumes
    _close(outs[0], outs[1], 1e-5)
    if masks:
        assert masks[0].seeded == masks[1].seeded == [True] * 6


def test_port_mask_seeded_per_sample(fastmri_root):
    """The port's per-sample mask: the same for one sample twice (and from a
    second dataset), different across samples; unseeded, the generator's own
    seed gives one mask for all."""
    from deepinv_tpu_torch.physics.generator import GaussianMaskGenerator

    gen = GaussianMaskGenerator((2, 64, 64), acceleration=4, device="cpu")
    ds = tds.FastMRISliceDataset(fastmri_root, slice_index="middle+1",
                                 transform=tds.MRISliceTransform(mask_generator=gen))
    again = tds.FastMRISliceDataset(fastmri_root, slice_index="middle+1",
                                    transform=tds.MRISliceTransform(mask_generator=gen))
    masks = [ds[i][2]["mask"] for i in range(6)]
    for i in range(6):
        np.testing.assert_array_equal(masks[i], again[i][2]["mask"])
        assert masks[i].shape == (64, 64) and masks[i].dtype == np.float32
    assert all(not np.array_equal(masks[0], m) for m in masks[1:])
    flat = tds.MRISliceTransform(mask_generator=gen, seed_mask_generator=False)
    ds = tds.FastMRISliceDataset(fastmri_root, slice_index="middle+1", transform=flat)
    np.testing.assert_array_equal(ds[0][2]["mask"], ds[4][2]["mask"])


def test_mri_slice_transform_errors():
    """The same errors: no ACS size, single-coil prewhitening and maps."""
    y1 = np.zeros((2, 16, 16), np.float32)
    for pkg in (tds, jds):
        with pytest.raises(ValueError, match="ACS size"):
            pkg.MRISliceTransform(normalize=True).get_acs()
        with pytest.raises(ValueError, match="multicoil"):
            pkg.MRISliceTransform(prewhiten=True).prewhiten_kspace(y1)
        with pytest.raises(ValueError, match="multicoil"):
            pkg.MRISliceTransform(acs=4).generate_maps(y1)


def test_save_simple_dataset_matches_jax(fastmri_root, tmp_path):
    """The magnitude images rescaled, cropped and padded to 40x52: the same
    ``.npy`` and the same 2-channel items."""
    a = tds.FastMRISliceDataset(fastmri_root).save_simple_dataset(str(tmp_path / "t.npy"),
                                                                  pad_to_size=(40, 52))
    b = jds.FastMRISliceDataset(fastmri_root).save_simple_dataset(str(tmp_path / "j.npy"),
                                                                  pad_to_size=(40, 52))
    np.testing.assert_array_equal(np.load(tmp_path / "t.npy"), np.load(tmp_path / "j.npy"))
    assert len(a) == len(b) == 11
    for i in (0, 10):
        _same(a[i], b[i])
    c = tds.SimpleFastMRISliceDataset(str(tmp_path / "t.npy"))
    _same(c[3], jds.SimpleFastMRISliceDataset(str(tmp_path / "j.npy"))[3])


# --------------------------------------------------------------- CMRxRecon --
def _save_mat73(path, name, arr):
    """A MATLAB 7.3 file: HDF5 with the axes reversed and complex arrays as
    real/imag compounds (tests/test_datasets.py:443)."""
    import h5py

    with h5py.File(path, "w") as f:
        a = arr.transpose(range(arr.ndim - 1, -1, -1))
        if np.iscomplexobj(a):
            buf = np.empty(a.shape, np.dtype([("real", a.real.dtype), ("imag", a.imag.dtype)]))
            buf["real"], buf["imag"] = a.real, a.imag
            f.create_dataset(name, data=buf)
        else:
            f.create_dataset(name, data=a)


W_C, H_C, D_C, T_C = 24, 16, 3, 5


@pytest.fixture(scope="module")
def cmrx_root(tmp_path_factory):
    """Two subjects' single-coil cine volumes (W, H, D, T) and their masks."""
    root = tmp_path_factory.mktemp("cmrx")
    rng = np.random.default_rng(42)
    for p in ("P001", "P002"):
        ddir = root / "SingleCoil/Cine/TrainingSet/FullSample" / p
        mdir = root / "SingleCoil/Cine/TrainingSet/AccFactor04" / p
        ddir.mkdir(parents=True)
        mdir.mkdir(parents=True)
        shape = (W_C, H_C, D_C, T_C)
        _save_mat73(str(ddir / "cine_sax.mat"), "kspace_single_full",
                    rng.normal(size=shape) + 1j * rng.normal(size=shape))
        _save_mat73(str(mdir / "cine_sax_mask.mat"), "mask",
                    (rng.random((T_C, W_C, H_C)) < 0.3).astype(np.float64))
    return str(root)


@pytest.mark.parametrize("kw", [dict(pad_size=(32, 20)), dict(pad_size=None),
                                dict(apply_mask=False, mask_dir=None)], ids=str)
def test_cmrxrecon_matches_jax(cmrx_root, kw):
    """Masks from mask_dir (or none), padding and normalization: the samples'
    metadata equal, the items within 1e-5 (the port's FFT for jnp.fft)."""
    a = tds.CMRxReconSliceDataset(cmrx_root, **kw)
    b = jds.CMRxReconSliceDataset(cmrx_root, **kw)
    assert [tuple(s) for s in a.samples] == [tuple(s) for s in b.samples]
    assert len(a) == 2 * D_C
    for i in (0, 4):
        ga, gb = a[i], b[i]
        assert len(ga) == len(gb) == (3 if kw.get("apply_mask", True) else 2)
        _close(ga, gb, 1e-5)
        if len(ga) == 3:
            _same(ga[2], gb[2])  # the mask read from its file: exact


def test_cmrxrecon_mask_generator_and_noise(cmrx_root):
    """A stub mask generator gives JAX's items (1e-5); the port's noise draws
    from a generator seeded by the sample's name: the same noise for one
    sample twice, another for the next, of the model's sigma."""
    from deepinv_tpu_torch.physics import GaussianNoise

    mask = (np.random.default_rng(43).random((W_C, H_C)) < 0.5).astype(np.float32)
    stubs = [_StubMaskGenerator(mask) for _ in range(2)]
    a = tds.CMRxReconSliceDataset(cmrx_root, mask_dir=None, mask_generator=stubs[0],
                                  pad_size=None)
    b = jds.CMRxReconSliceDataset(cmrx_root, mask_dir=None, mask_generator=stubs[1],
                                  pad_size=None)
    _close(a[1], b[1], 1e-5)
    assert stubs[0].seeded == stubs[1].seeded == [True]

    for pkg in (tds, jds):
        with pytest.raises(ValueError, match="Only one of"):
            pkg.CMRxReconSliceDataset(cmrx_root, mask_generator=stubs[0])
        with pytest.raises(ValueError, match="does not exist"):
            pkg.CMRxReconSliceDataset(cmrx_root, data_dir="nowhere")
        with pytest.warns(UserWarning, match="apply_mask is False"):
            pkg.CMRxReconSliceDataset(cmrx_root, apply_mask=False)

    sigma = 0.05
    noisy = tds.CMRxReconSliceDataset(cmrx_root, pad_size=None,
                                      noise_model=GaussianNoise(sigma, device="cpu"))
    clean = tds.CMRxReconSliceDataset(cmrx_root, pad_size=None)
    x0, y0, p0 = noisy[0]
    np.testing.assert_array_equal(y0, noisy[0][1])
    _, y1, _ = noisy[1]
    assert not np.array_equal(y0 - clean[0][1], y1 - clean[1][1])
    m = p0["mask"] > 0
    resid = (y0 - clean[0][1])[m]
    assert abs(float(resid.std()) / sigma - 1) < 0.1 and abs(float(resid.mean())) < 0.02
    assert np.abs(y0[~m]).max() == 0


# ----------------------------------------------------------------- SKM-TEA --
@pytest.fixture(scope="module")
def skmtea_root(tmp_path_factory):
    import h5py

    root = tmp_path_factory.mktemp("skmtea")
    rng = np.random.default_rng(44)
    S, H, W, E, N = 2, 20, 16, 2, 4
    for name in ("scan0.h5", "scan1.h5"):
        c = lambda shape: (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
            np.complex64)
        with h5py.File(root / name, "w") as f:
            f["kspace"] = c((S, H, W, E, N))
            f["target"] = c((S, H, W, E, 1))
            f["maps"] = c((S, H, W, N, 1))
            f["masks/poisson_6.0x"] = rng.random((16, 12)) < 0.4
            f["masks/poisson_8.0x"] = rng.random((16, 12)) < 0.3
    return str(root)


@pytest.mark.parametrize("echo,acc", [(0, 6), (1, 8)])
def test_skmtea_matches_jax(skmtea_root, tmp_path, echo, acc):
    """Echo and mask selection, the zero-padded mask and the maps: the same
    bits; ``filter_id`` and the metadata cache as in JAX."""
    cache = str(tmp_path / "sk.pkl")
    a = tds.SKMTEASliceDataset(skmtea_root, echo=echo, acc=acc, save_metadata_to_cache=True,
                               metadata_cache_file=cache)
    b = jds.SKMTEASliceDataset(skmtea_root, echo=echo, acc=acc, load_metadata_from_cache=True,
                               metadata_cache_file=cache)
    assert [tuple(s) for s in a.samples] == [tuple(s) for s in b.samples] and len(a) == 4
    for i in range(4):
        _same(a[i], b[i])
    keep = lambda s: s.slice_ind == 1
    assert len(tds.SKMTEASliceDataset(skmtea_root, filter_id=keep)) == 2
    z = np.random.default_rng(45).random((2, 5, 7)).astype(np.float32)
    _same(tds.SKMTEASliceDataset.zero_pad(z, (9, None)),
          jds.SKMTEASliceDataset.zero_pad(z, (9, None)))


# --------------------------------------------------------------- LIDC-IDRI --
def _write_dicom(path, arr, slope=1.0, intercept=0.0):
    """Explicit-VR little-endian DICOM part 10 of a signed int16 slice (the
    writer of tests/test_io_battery.py:191)."""

    def elem(group, el, vr, value):
        head = struct.pack("<HH", group, el) + vr
        if vr in (b"OB", b"OW"):
            return head + b"\x00\x00" + struct.pack("<I", len(value)) + value
        return head + struct.pack("<H", len(value)) + value

    def ds_value(x):
        s = f"{x:g}".encode()
        return s + b" " if len(s) % 2 else s

    rows, cols = arr.shape
    body = (elem(0x0028, 0x0010, b"US", struct.pack("<H", rows))
            + elem(0x0028, 0x0011, b"US", struct.pack("<H", cols))
            + elem(0x0028, 0x0100, b"US", struct.pack("<H", 16))
            + elem(0x0028, 0x0103, b"US", struct.pack("<H", 1))
            + elem(0x0028, 0x1052, b"DS", ds_value(intercept))
            + elem(0x0028, 0x1053, b"DS", ds_value(slope))
            + elem(0x7FE0, 0x0010, b"OW", arr.astype("<i2").tobytes()))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"\x00" * 128 + b"DICM" + body)


@pytest.fixture(scope="module")
def lidc_root(tmp_path_factory):
    """Two CT subjects (listed out of order, with Windows and POSIX paths) of
    3 slices each and a non-CT row."""
    root = tmp_path_factory.mktemp("lidc")
    rng = np.random.default_rng(46)
    rows = []
    for subject, sep in (("LIDC-IDRI-0002", "\\"), ("LIDC-IDRI-0001", "/")):
        scan = os.path.join("LIDC-IDRI", subject, "study", "series")
        for i in range(3):
            _write_dicom(str(root / scan / f"1-{i:03d}.dcm"),
                         rng.integers(-1000, 2000, (10, 12), dtype=np.int16), 1.0, -1024.0)
        rows.append(f"{subject},CT,{scan.replace(os.sep, sep)}")
    rows.append("LIDC-IDRI-0003,DX,ignored")
    (root / "metadata.csv").write_text("Subject ID,Modality,File Location\n"
                                       + "\n".join(rows) + "\n")
    return str(root)


@pytest.mark.parametrize("hu", [False, True])
def test_lidc_idri_matches_jax(lidc_root, hu):
    """CT rows sorted by subject, the slices in order: the same identifiers
    and bits (raw int16 or float32 HU), each item the port's ``load_dicom``
    of its file; a transform applies."""
    from deepinv_tpu_torch.utils import load_dicom

    a = tds.LidcIdriSliceDataset(lidc_root, hounsfield_units=hu)
    b = jds.LidcIdriSliceDataset(lidc_root, hounsfield_units=hu)
    assert [tuple(s) for s in a.sample_identifiers] == [tuple(s) for s in b.sample_identifiers]
    assert len(a) == 6 and a.sample_identifiers[0].patient_id == "LIDC-IDRI-0001"
    for i in range(6):
        _same(a[i], b[i])
        fname, folder, _ = a.sample_identifiers[i]
        ref = load_dicom(os.path.join(folder, fname), apply_rescale=hu,
                         dtype=None if hu else np.int16)
        np.testing.assert_array_equal(a[i], ref)
    assert a[0].dtype == (np.float32 if hu else np.int16)
    tf = lambda v: np.clip((v + 1000) / 2000, 0, 1)
    _same(tds.LidcIdriSliceDataset(lidc_root, tf, hu)[2],
          jds.LidcIdriSliceDataset(lidc_root, tf, hu)[2])
    for pkg in (tds, jds):
        with pytest.raises(ValueError, match="doesn't exist"):
            pkg.LidcIdriSliceDataset(os.path.join(lidc_root, "nowhere"))


# --------------------------------------------------------------------- NBU --
@pytest.fixture(scope="module")
def nbu_root(tmp_path_factory):
    from scipy.io import savemat

    root = tmp_path_factory.mktemp("nbu")
    rng = np.random.default_rng(47)
    for sat, top in (("gaofen-1", 1023), ("ikonos", 2047)):
        for sub in ("MS_256", "PAN_1024"):
            (root / sat / sub).mkdir(parents=True)
        for name in ("1.mat", "2.mat", "10.mat"):
            savemat(str(root / sat / "MS_256" / name),
                    {"imgMS": (rng.random((16, 16, 4)) * top).astype(np.uint16)})
            savemat(str(root / sat / "PAN_1024" / name),
                    {"imgPAN": (rng.random((64, 64)) * top).astype(np.uint16)})
    return str(root)


@pytest.mark.parametrize("sat", ["gaofen-1", "ikonos"])
def test_nbu_matches_jax(nbu_root, sat):
    """The natural order, the 10- or 11-bit normalization: the same bits; with
    ``return_pan`` a port TensorList of the MS and PAN images."""
    a = tds.NBUDataset(nbu_root, satellite=sat)
    b = jds.NBUDataset(nbu_root, satellite=sat)
    assert a.image_paths == b.image_paths and len(a) == 3
    for i in range(3):
        _same(a[i], b[i])
    pa = tds.NBUDataset(nbu_root, satellite=sat, return_pan=True)[2]
    pb = jds.NBUDataset(nbu_root, satellite=sat, return_pan=True)[2]
    assert isinstance(pa, TensorList) and len(pa) == 2
    for u, v in zip(pa, pb):
        np.testing.assert_array_equal(_np(u), _np(v))
    for pkg in (tds, jds):
        with pytest.raises(RuntimeError):
            pkg.NBUDataset(nbu_root, satellite=sat, download=True)
        with pytest.raises(ValueError, match="satellite"):
            pkg.NBUDataset(nbu_root, satellite="landsat")
        with pytest.raises(FileNotFoundError):
            pkg.NBUDataset(nbu_root, satellite="quickbird")


# ------------------------------------------------------------- FMD, Köhler --
def _save_png(path, arr):
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path)


def test_fmd_matches_jax(tmp_path):
    """The noisy PNGs paired with their field of view's ``gt/avg50.png``: the
    same identifiers and pixels; the same errors."""
    rng = np.random.default_rng(48)
    t = "Confocal_BPAE_B"
    for fov in (1, 2):
        for noise_dir in ("raw", "avg2", "avg4"):
            for i in range(2):
                _save_png(str(tmp_path / t / noise_dir / str(fov) / f"HV{i:05d}.png"),
                          rng.integers(0, 256, (6, 7), np.uint8))
        _save_png(str(tmp_path / t / "gt" / str(fov) / "avg50.png"),
                  rng.integers(0, 256, (6, 7), np.uint8))
    kw = dict(img_types=[t], noise_levels=(1, 4), fovs=(1, 2), transform=np.asarray,
              target_transform=np.asarray)
    a, b = tds.FMD(str(tmp_path), **kw), jds.FMD(str(tmp_path), **kw)
    assert [tuple(s) for s in a.noisy_sample_identifiers] == [
        tuple(s) for s in b.noisy_sample_identifiers] and len(a) == 8
    for i in range(8):
        _same(a[i], b[i])
    for pkg in (tds, jds):
        with pytest.raises(ValueError, match="img_types"):
            pkg.FMD(str(tmp_path), img_types=["NotAType"])
        with pytest.raises(ValueError, match="noise level"):
            pkg.FMD(str(tmp_path), img_types=[t], noise_levels=(3,))
        with pytest.raises(FileNotFoundError):
            pkg.FMD(str(tmp_path), img_types=[t], noise_levels=(8,))
        with pytest.raises(RuntimeError):
            pkg.FMD(str(tmp_path), img_types=[t], download=True)


@pytest.mark.parametrize("ordering", ["printout_first", "trajectory_first"])
def test_kohler_matches_jax(tmp_path, ordering):
    """Indexing by printout and trajectory, the frame-count table and frame
    selection: the same pixels for each frame choice; the same errors."""
    rng = np.random.default_rng(49)
    for p, t, count in ((1, 1, 199), (1, 10, 198), (2, 1, 199)):
        for f in (1, (count + 1) // 2, count):
            _save_png(str(tmp_path / f"Image{p}" / f"Kernel{t}" / f"GroundTruth{p}_{t}_{f}.png"),
                      rng.integers(0, 256, (8, 9, 3), np.uint8))
        _save_png(str(tmp_path / f"Blurry{p}_{t}.png"), rng.integers(0, 256, (8, 9, 3), np.uint8))
    a = tds.Kohler(str(tmp_path), ordering=ordering, transform=np.asarray)
    b = jds.Kohler(str(tmp_path), ordering=ordering, transform=np.asarray)
    assert len(a) == len(b) == 48
    idx = (0, 12) if ordering == "printout_first" else (0, 1)   # (1, 1) and (2, 1)
    for i in idx:
        _same(a[i], b[i])
    for frames in ("first", "last", ["first", "middle"], 1):
        _same(a.get_item(1, 10, frames=frames), b.get_item(1, 10, frames=frames))
    for p, t in ((2, 11), (1, 10), (4, 4)):
        for f in ("first", "middle", "last", 7):
            assert tds.Kohler.select_frame(p, t, f) == jds.Kohler.select_frame(p, t, f)
    for pkg in (tds, jds):
        with pytest.raises(RuntimeError):
            pkg.Kohler(str(tmp_path), download=True)
        with pytest.raises(ValueError, match="ordering"):
            pkg.Kohler(str(tmp_path), ordering="random")
        with pytest.raises(ValueError, match="frame selection"):
            pkg.Kohler.select_frame(1, 1, "second")


def test_dataset_items_feed_the_loader(lidc_root, fastmri_root):
    """The named datasets' numpy items batch through the port's DataLoader
    (LIDC-IDRI slices; fastMRI ``(x, y)`` pairs)."""
    batch = next(iter(tds.DataLoader(tds.LidcIdriSliceDataset(lidc_root, hounsfield_units=True),
                                     batch_size=4)))
    assert tuple(batch.shape) == (4, 10, 12)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        x, y = next(iter(tds.DataLoader(tds.FastMRISliceDataset(fastmri_root, slice_index=0),
                                        batch_size=2)))
    assert tuple(x.shape) == (2, 1, 64, 64) and tuple(y.shape) == (2, 2, 4, 64, 64)
