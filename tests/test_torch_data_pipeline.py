"""The port's data pipeline, loggers and kernel cost records against the JAX
package's, on the CPU: HDF5 files crossing both ways, the patch samplers and
the split, ``ImageFolder`` on PNG and JPEG files the test writes (the native
decoder the same bits as JAX's, PIL too), the native prefetcher, the CSV
logger and the progress printer, and the K1-K4 costs ``compiled_cost``
records against JAX's record sites. Also the names: the port imports no JAX
and none of the optional packages at import time, and it exports every
public name of the JAX package's ``parallel``, ``datasets``, ``utils`` and
top level.
"""

import os
import subprocess
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepinv_tpu.datasets as jds
import deepinv_tpu.native as jnative
import deepinv_tpu.utils as jutils
import deepinv_tpu_torch.datasets as tds
import deepinv_tpu_torch.native as tnative
import deepinv_tpu_torch.utils as tutils
from deepinv_tpu.models import autocast as jax_autocast
from deepinv_tpu_torch.models import autocast

from test_torch_drunet_configs import _jax_pallas_forward
from test_torch_drunet import _pair


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """Six images: RGB and gray PNGs and RGB JPEGs of odd sizes, written by PIL."""
    from PIL import Image

    root = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(0)
    for i in range(6):
        h, w = 20 + 3 * i, 27 + 2 * i
        if i % 3 == 1:
            Image.fromarray(rng.integers(0, 256, (h, w), np.uint8), "L").save(root / f"g{i}.png")
        else:
            img = Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8), "RGB")
            img.save(root / (f"c{i}.jpg" if i % 3 == 2 else f"c{i}.png"))
    return str(root)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_hdf5_files_cross(tmp_path, direction):
    """generate_dataset of one package read by the other's HDF5Dataset, two
    operators round robin and a sigma generator: the same items (x, y and
    the ``sigma`` member) from both readers, train and test splits."""
    from deepinv_tpu.physics import Denoising as JDen
    from deepinv_tpu.physics import GaussianNoise as JNoise
    from deepinv_tpu.physics.generator import SigmaGenerator as JSigma
    from deepinv_tpu_torch.physics import Denoising, GaussianNoise
    from deepinv_tpu_torch.physics.generator import SigmaGenerator

    xs = np.random.default_rng(2).random((7, 1, 8, 8)).astype(np.float32)
    if direction == "jax_to_port":
        paths = jds.generate_dataset(jds.ArrayDataset(xs), [JDen(JNoise(0.1)), JDen(JNoise(0.2))],
                                     str(tmp_path), test_dataset=jds.ArrayDataset(xs[:3]),
                                     physics_generator=JSigma(0.01, 0.1), batch_size=2)
    else:
        dev = "cpu"
        paths = tds.generate_dataset(
            tds.ArrayDataset(xs), [Denoising(GaussianNoise(0.1, device=dev)),
                                   Denoising(GaussianNoise(0.2, device=dev))], str(tmp_path),
            test_dataset=tds.ArrayDataset(xs[:3]),
            physics_generator=SigmaGenerator(0.01, 0.1, device=dev), batch_size=2,
            generator=torch.Generator().manual_seed(0))
    assert len(paths) == 2
    for i, path in enumerate(paths):
        for train in (True, False):
            a = tds.HDF5Dataset(path, train=train, load_physics_generator_params=True)
            b = jds.HDF5Dataset(path, train=train, load_physics_generator_params=True)
            assert len(a) == len(b) == (len(range(i, 7, 2)) if train else 3)
            for k in range(len(a)):
                (xa, ya, pa), (xb, yb, pb) = a[k], b[k]
                np.testing.assert_array_equal(xa, xb)
                np.testing.assert_array_equal(ya, yb)
                assert set(pa) == set(pb) == {"sigma"}
                np.testing.assert_array_equal(pa["sigma"], pb["sigma"])
            xb0 = xs[list(range(i, 7, 2))[0]] if train else xs[0]
            np.testing.assert_array_equal(a[0][0], xb0)
            a.close()
            b.close()
    batch = next(iter(tds.DataLoader(tds.HDF5Dataset(paths[0]), batch_size=2)))
    assert batch[0].shape == (2, 1, 8, 8) and batch[1].shape == (2, 1, 8, 8)


def test_patch_samplers_and_split(tmp_path):
    """RandomPatchSampler on 2-D and 3-D .npy volumes (x alone, x and y, a
    slice patch squeezed), PatchDataset and random_split: the same arrays
    as the JAX package's, item for item."""
    rng = np.random.default_rng(3)
    for d in ("x", "y", "v"):
        (tmp_path / d).mkdir()
    for i in range(4):
        np.save(tmp_path / "x" / f"{i}.npy", rng.random((24, 30)).astype(np.float32))
        np.save(tmp_path / "y" / f"{i}.npy", rng.random((24, 30)).astype(np.float32))
        np.save(tmp_path / "v" / f"{i}.npy", rng.random((6, 16, 16, 2)).astype(np.float32))
    cases = [dict(x_dir=str(tmp_path / "x"), patch_size=8, seed=1),
             dict(x_dir=str(tmp_path / "x"), y_dir=str(tmp_path / "y"), patch_size=(8, 12), seed=2),
             dict(y_dir=str(tmp_path / "v"), patch_size=(1, 8, 8), ch_axis=-1, seed=3)]
    for kw in cases:
        a, b = tds.RandomPatchSampler(**kw), jds.RandomPatchSampler(**kw)
        for _ in range(2):
            for k in range(len(a)):
                for pa, pb in zip(*(v if isinstance(v, tuple) else (v,) for v in (a[k], b[k]))):
                    np.testing.assert_array_equal(pa, pb)
    np.testing.assert_array_equal(a.load(a.files[0][1], (2, 3, 4), (1, 5, None)),
                                  b.load(b.files[0][1], (2, 3, 4), (1, 5, None)))
    imgs = rng.random((3, 2, 20, 18)).astype(np.float32)
    pa, pb = tds.PatchDataset(imgs, 8, 4), jds.PatchDataset(imgs, 8, 4)
    assert len(pa) == len(pb) and pa.get_num_patches((20, 18)) == pb.get_num_patches((20, 18))
    for k in (0, 7, len(pa) - 1):
        np.testing.assert_array_equal(pa[k], pb[k])
    sa, sb = tds.random_split(pa, [10, 20], seed=4), jds.random_split(pb, [10, 20], seed=4)
    for u, v in zip(sa, sb):
        np.testing.assert_array_equal(u.indices, v.indices)
        np.testing.assert_array_equal(u[3], v[3])


@pytest.mark.parametrize("backend", ["native", "pil"])
def test_image_folder_matches_jax(images, backend):
    """ImageFolder in RGB and in gray, with a fixed size and without: the
    same float32 arrays as the JAX package's, bit for bit."""
    if backend == "native":
        assert tnative.native_available() and jnative.native_available()
    for kw in (dict(size=(16, 20)), dict(size=12, grayscale=True), dict()):
        a = tds.ImageFolder(images, backend=backend, **kw)
        b = jds.ImageFolder(images, backend=backend,
                            **{**kw, "size": (12, 12)} if kw.get("size") == 12 else kw)
        assert a.paths == b.paths and len(a) == 6
        for k in range(len(a)):
            xa, xb = a[k], b[k]
            assert xa.dtype == np.float32 and xa.shape == xb.shape
            np.testing.assert_array_equal(xa, xb)
    with pytest.raises(ValueError):
        tds.ImageFolder(images, backend="bogus")
    with pytest.raises(RuntimeError):
        tds.DIV2K(images, download=True)
    assert not tds.DIV2K(images).verify_split_dataset_integrity()


def test_native_prefetcher_batches(images):
    """The port's NativePrefetcher on the CPU: every batch the same bits as
    the JAX package's prefetcher and as decode_batch, the last one short,
    into a caller-owned buffer too; crop mode matches decode_image."""
    a = tds.ImageFolder(images, size=(16, 16), backend="native")
    pf = a.batches(4, n_threads=2, device="cpu")
    jpf = jds.ImageFolder(images, size=(16, 16), backend="native").batches(4, n_threads=2)
    got, want = list(pf), list(jpf)
    assert [tuple(g.shape) for g in got] == [(4, 3, 16, 16), (2, 3, 16, 16)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_array_equal(torch.cat(got).numpy(),
                                  tnative.decode_batch(a.paths, (3, 16, 16), n_threads=2))
    buf = torch.empty((4, 3, 16, 16))
    out = pf.get(1, out=buf)
    assert out.data_ptr() == buf.data_ptr() and torch.equal(out, got[1])
    with pytest.raises(ValueError):
        pf.get(0, out=torch.empty((3, 3, 16, 16)))
    pf.close()
    np.testing.assert_array_equal(tnative.decode_image(a.paths[0], (3, 10, 10), mode="crop"),
                                  jnative.decode_image(a.paths[0], (3, 10, 10), mode="crop"))
    assert tnative.probe_image(a.paths[0]) == jnative.probe_image(a.paths[0])


def test_csv_logger_and_progress_meter(tmp_path, capsys):
    """CSVLogger writes the JAX package's file (a header once, rows
    appended); ProgressMeter prints its line."""
    out = {}
    for name, mod in (("port", tutils), ("jax", jutils)):
        path = tmp_path / name / "log.csv"
        for run in range(2):
            log = mod.CSVLogger(str(path), ["epoch", "psnr"])
            log.log(epoch=run, psnr=20.5 + run)
            log.close()
        out[name] = path.read_text()
        m = mod.AverageMeter("loss")
        m.update(0.25)
        mod.ProgressMeter(10, [m], prefix="Epoch 1 ").display(3)
        out[name + " printed"] = capsys.readouterr().out
    assert out["port"] == out["jax"] == "epoch,psnr\n0,20.5\n1,21.5\n"
    assert out["port printed"] == out["jax printed"] == "Epoch 1 [3/10]  loss 0.25 (avg 0.25)\n"


@pytest.mark.parametrize("mode", ["down", "both", "sandwich"])
def test_recorded_kernel_costs_match_jax(mode, monkeypatch):
    """One bf16 DRUNet call at 1x3x32², nc (64, 128, 32, 32), in each
    configuration: the flops and bytes the port's K1-K4 ops record equal what
    JAX's record sites give ``compiled_cost`` on its folded Pallas forward;
    each op's count alone at B=2 is twice B=1's."""
    from deepinv_tpu.utils import compiled_cost as jcost
    from deepinv_tpu_torch.ops.kernels.resblock_chain import resblock_chain_cost

    ref, port = _pair(nc=(64, 128, 32, 32), nb=2, seed=4)
    port.fused = mode
    x = np.random.default_rng(6).random((1, 3, 32, 32)).astype(np.float32)
    got = tutils.compiled_cost(lambda v: autocast(port)(v, 0.05), torch.from_numpy(x))
    _jax_pallas_forward(monkeypatch, mode)
    want = jcost(lambda v: jax_autocast(ref)(v, 0.05), jnp.asarray(x))
    assert got["pallas_flops"] == want["pallas_flops"]
    assert got["pallas_bytes"] == want["pallas_bytes"]
    assert got["flops"] > got["pallas_flops"]
    assert resblock_chain_cost(2, 32, 32, 2) == tuple(2 * v for v in
                                                      resblock_chain_cost(1, 32, 32, 2))
    assert "pallas_flops" not in tutils.compiled_cost(lambda: torch.ones(3) * 2)


def test_profiling_trace_and_timeit(tmp_path):
    """trace() writes a Chrome trace; timeit gives a positive median."""
    import json

    with tutils.trace(str(tmp_path / "t")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert "traceEvents" in json.loads((tmp_path / "t" / "trace.json").read_text())
    assert tutils.timeit(lambda a: a @ a, torch.ones(32, 32), repeats=3) > 0


def test_new_modules_import_no_jax():
    """Importing the port's top level, serve, parallel, the datasets, native,
    the utilities and the trainer loads no JAX module, nothing of the JAX
    package and none of the optional packages the readers, the plots and the
    MLOps logging import where they are used."""
    optional = ("jax", "jaxlib", "deepinv_tpu", "h5py", "PIL", "matplotlib", "tifffile",
                "rasterio", "mat73", "nibabel", "pydicom", "wandb", "mlflow")
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import deepinv_tpu_torch, deepinv_tpu_torch.datasets, deepinv_tpu_torch.utils\n"
        "import deepinv_tpu_torch.training\n"
        "import deepinv_tpu_torch.serve, deepinv_tpu_torch.parallel, deepinv_tpu_torch.native\n"
        "import deepinv_tpu_torch.utils.profiling, deepinv_tpu_torch.training.trainer\n"
        "new = set(sys.modules) - before\n"
        f"bad = sorted(m for m in new if m.split('.')[0] in {optional!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=str(Path(__file__).parents[1]))
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_port_file_imports_jax():
    """No file of the port, and not chip_smoke.py, imports jax or anything of
    the JAX package, at its top or inside a function."""
    import ast

    root = Path(__file__).parents[1]
    files = sorted((root / "deepinv_tpu_torch").rglob("*.py")) + [root / "chip_smoke.py"]
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            bad += [f"{f.relative_to(root)}:{node.lineno} {m}" for m in mods
                    if m.split(".")[0] in ("jax", "jaxlib", "deepinv_tpu")]
    assert len(files) > 100 and not bad, bad


def _names(mod) -> set:
    return {n for n in dir(mod) if not n.startswith("_")
            and not isinstance(getattr(mod, n), types.ModuleType) and n != "annotations"}


def test_exports_every_jax_name():
    """``parallel``, ``datasets``, ``utils`` and the top level export every
    public name of their JAX counterparts (at the top level the lazy ones
    and the ``serve`` module too); of ``core`` only ``Module`` and its pytree
    and key helpers stay out, as they do at the top level."""
    import deepinv_tpu as jtop
    import deepinv_tpu.core as jcore
    import deepinv_tpu.parallel as jpar
    import deepinv_tpu_torch as ttop
    import deepinv_tpu_torch.core as tcore
    import deepinv_tpu_torch.parallel as tpar

    for j, t in ((jpar, tpar), (jds, tds), (jutils, tutils)):
        assert _names(j) <= _names(t), sorted(_names(j) - _names(t))
    public = lambda m: {n for n in dir(m) if not n.startswith("_")}
    assert public(jtop) - public(ttop) == {"Module"}
    for n in ("Trainer", "train", "test", "metric", "unfolded", "parallel", "native", "serve",
              "TensorList", "dtype"):
        assert getattr(ttop, n) is not None
    assert ttop.dtype is torch.float32 and ttop.metric is __import__(
        "deepinv_tpu_torch.loss.metric", fromlist=["metric"])
    assert _names(jcore) - _names(tcore) == {
        "Module", "combine", "partition_arrays", "is_array", "split_like", "update",
        "ensure_key", "epoch_key", "transpose_primal"}


def test_dataset_file_helpers_match_jax(tmp_path):
    """The MD5 of a file and of a flat folder equal the JAX package's; a zip
    and a tar archive extract to the same files."""
    import tarfile
    import zipfile

    import deepinv_tpu.datasets.utils as jdu
    import deepinv_tpu_torch.datasets.utils as tdu

    src = tmp_path / "src"
    src.mkdir()
    for i in range(3):
        (src / f"f{i}.bin").write_bytes(np.random.default_rng(i).bytes(1000 + i))
    assert tdu.calculate_md5(str(src / "f1.bin")) == jdu.calculate_md5(str(src / "f1.bin"))
    assert tdu.calculate_md5_for_folder(str(src)) == jdu.calculate_md5_for_folder(str(src))
    assert tdu.check_path_is_a_folder(str(src)) and not tdu.check_path_is_a_folder(str(tmp_path))
    with zipfile.ZipFile(tmp_path / "a.zip", "w") as z:
        z.write(src / "f0.bin", "f0.bin")
    with tarfile.open(tmp_path / "a.tar.gz", "w:gz") as t:
        t.add(src / "f2.bin", "f2.bin")
    tdu.extract_zipfile(str(tmp_path / "a.zip"), str(tmp_path / "out"))
    tdu.extract_tarball(str(tmp_path / "a.tar.gz"), str(tmp_path / "out"))
    assert tdu.calculate_md5_for_folder(str(tmp_path / "out")) == jdu.calculate_md5_for_folder(
        str(tmp_path / "out"))
    assert sorted(os.listdir(tmp_path / "out")) == ["f0.bin", "f2.bin"]
