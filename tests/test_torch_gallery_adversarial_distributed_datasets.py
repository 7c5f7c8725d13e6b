"""The gallery's adversarial, distributed and datasets demos on the port
(``deepinv_tpu_torch/examples``), run in-process on the CPU at their fast
sizes, each held to the claim its JAX demo asserts or prints (see
``tests/test_torch_gallery_basics.py``) and to ``chip_smoke.py`` phase 25's
(``GALLERY25_CLAIMS``); and phase 25's bookkeeping. The deterministic ones
are also held to the JAX package, its distributed layer on the 8 virtual
CPU devices that ``tests/conftest.py`` gives every test, under
``jax.jit``: distributed_pnp's 20 PGD iterations and physics_distributed's
``A``, ``A_adjoint`` and 20-step ``A_dagger`` within 1e-5 (relative L2, the
same arithmetic); denoiser_distributed's halo, basic and micro-batched
medians exactly, on one noisy input handed to both; native_dataloader's
batch means within 1e-5 (the same files); hdf5_convention's members and
shapes exactly, against the JAX demo itself at its fast size.

The JAX demos printed, on the CPU: adversarial_training's loss history
[0.042, 0.023, 0.0156, 0.0133], loss_D 0.589 -> 0.310, PSNR 14.87 -> 19.45;
csgm's residual 1.311 -> 0.209, MSE 0.0000; distributed_pnp's mse 0.0021
against the zero start's 0.0988; physics_distributed's adjointness 26.9564 /
26.9564 and ``A_dagger``'s relative error 0.003; denoiser_distributed's halo
0.00e+00, basic 8.13e-01, micro-batched 0.00e+00; native_dataloader's item
(3, 64, 64) float32 and batch means 0.497, 0.499, 0.498, 0.499; io's npy
maxerr 0, mat keys ['img', 'pixel_size'], tiff uint16 with a rescaled maxerr
7.6e-06, h5 (1, 1, 64, 64); hdf5_convention's members ['sigma_test',
'sigma_train', 'x_test', 'x_train', 'y_test', 'y_train'], params ['sigma']
and ['mask'], the deploy split's NaN ground truth, 2 stacked parts, x (1, 32,
32) against y (1, 64, 64) under the transform.
"""

import contextlib
import functools
import importlib
import io
import math
import os
import re
import shutil
import sys
import tempfile

import numpy as np
import pytest

import test_torch_drunet  # noqa: F401  (each xdist worker takes its share of the cores)

OTHERS = ("adversarial_training", "csgm", "distributed_pnp", "physics_distributed",
          "denoiser_distributed", "native_dataloader", "io", "hdf5_convention")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def demo(name):
    return importlib.import_module(f"deepinv_tpu_torch.examples.demo_{name}")


@functools.lru_cache(maxsize=None)
def run_printed(name):
    """The demo's fast run on the CPU, once a worker (a claim and a parity
    test share it): its numbers and what it printed."""
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        out = demo(name).main(device="cpu", fast=True)
    return out, printed.getvalue()


def run(name):
    return run_printed(name)[0]


def _rel(got, want):
    g, w = np.asarray(got.detach().cpu(), np.float64), np.asarray(want, np.float64)
    assert g.shape == w.shape
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def test_adversarial_training():
    """A finite generator loss an epoch (2 at the fast size), the last below
    the first; the discriminator's loss and the train PSNR, one an epoch."""
    out = run("adversarial_training")
    loss = out["loss_history"]
    assert len(loss) == len(out["loss_d_history"]) == len(out["psnr_history"]) == out["epochs"]
    assert all(map(math.isfinite, loss + out["loss_d_history"])) and loss[-1] < loss[0]
    assert out["psnr_history"][-1] > out["psnr_history"][0]


def test_csgm():
    """The latent fit's measurement residual falls below a quarter of the
    zero image's (asserted in JAX), over 200 steps at the fast size."""
    out = run("csgm")
    assert out["residual"] < 0.25 * out["residual_start"]


def test_distributed_pnp():
    """On 8 mesh entries PnP-PGD's error falls below half the zero start's
    (asserted in JAX)."""
    out = run("distributed_pnp")
    assert out["mesh"] == 8 and out["mse"] < 0.5 * out["mse_zero"]


def test_distributed_pnp_matches_jax():
    """The 20 PGD iterations' output within 1e-5 (relative L2) of the JAX
    package's, its operator stack over the 8 virtual devices."""
    import jax
    import jax.numpy as jnp
    from deepinv_tpu.models import MedianFilter
    from deepinv_tpu.ops import gaussian_blur
    from deepinv_tpu.optim import L2
    from deepinv_tpu.parallel import DistributedContext, distribute
    from deepinv_tpu.physics import Blur
    from deepinv_tpu_torch.datasets import random_circles

    assert len(jax.devices()) == 8
    ctx = DistributedContext(axis_names=("op",))
    dphys = distribute([Blur(filter=gaussian_blur(sigma=1.0, psf_size=(7, 7)),
                             padding="circular") for _ in range(8)], ctx)
    dfid, den = distribute(L2(), ctx), MedianFilter(3)

    @jax.jit
    def pgd(x):
        y, z = dphys.A(x), jnp.zeros_like(x)
        for _ in range(20):
            z = den(z - (0.9 / 8) * dfid.grad(z, y, dphys))
        return z

    want = pgd(jnp.asarray(random_circles(64, seed=0))[None])
    assert _rel(run("distributed_pnp")["x_hat"]["pgd"], want) <= 1e-5


def test_physics_distributed():
    """8 stacked measurements, the adjoint's image, the dot-product test
    within 1e-4 and ``A_dagger``'s relative error below 0.5 (asserted in
    JAX)."""
    out = run("physics_distributed")
    assert out["mesh"] == 8 and out["y_shape"] == [8, 1, 1, 64, 64]
    assert out["adjoint_shape"] == [1, 1, 64, 64]
    assert out["adjointness_gap"] < 1e-4 and out["rel"] < 0.5


def test_physics_distributed_matches_jax():
    """``A``, ``A_adjoint`` (of the port's measurements) and the 20-step
    ``A_dagger`` within 1e-5 (relative L2) of the JAX package's factory-built
    stack over the 8 virtual devices."""
    import jax
    import jax.numpy as jnp
    from deepinv_tpu.ops import gaussian_blur
    from deepinv_tpu.parallel import DistributedContext, distribute
    from deepinv_tpu.physics import Blur
    from deepinv_tpu_torch.datasets import random_circles

    def factory(idx, device, params):
        return Blur(filter=gaussian_blur(sigma=0.5 + 0.25 * idx, psf_size=(7, 7)),
                    padding="circular")

    dphys = distribute(factory, DistributedContext(axis_names=("op",)), num_operators=8,
                       type_object="linear_physics")
    got = run("physics_distributed")["x_hat"]
    y = jnp.asarray(got["A"].numpy())
    assert _rel(got["A"], jax.jit(dphys.A)(jnp.asarray(random_circles(64, seed=0))[None])) <= 1e-5
    assert _rel(got["A_adjoint"], jax.jit(dphys.A_adjoint)(y)) <= 1e-5
    assert _rel(got["A_dagger"], jax.jit(lambda v: dphys.A_dagger(v, max_iter=20))(y)) <= 1e-5


def test_denoiser_distributed():
    """The halo-exchanged bands equal the single-device median (< 1e-5) and
    the basic bands show their seams (> 1e-5), as JAX asserts; the
    micro-batched batch of 12 matches too."""
    out = run("denoiser_distributed")
    assert out["mesh"] == 8 and out["err_halo"] < 1e-5 < out["err_basic"]
    assert out["err_microbatch"] < 1e-5 and out["microbatch_shape"] == [12, 1, 512, 512]


def test_denoiser_distributed_matches_jax():
    """The halo, basic and micro-batched outputs equal the JAX package's
    (exactly: a median selects) on the demo's own noisy image, over the 8
    virtual devices."""
    import jax
    import jax.numpy as jnp
    import torch
    from deepinv_tpu.models import MedianFilter
    from deepinv_tpu.parallel import DistributedContext, distribute
    from deepinv_tpu_torch.datasets import random_circles

    m = demo("denoiser_distributed")
    x = torch.from_numpy(random_circles(512, seed=1))[None]
    noisy = jnp.asarray((x + 0.15 * torch.randn(x.shape, generator=m._util.generator(0))).numpy())
    ctx, den = DistributedContext(axis_names=("sp",)), MedianFilter(kernel_size=5)
    calls = {"halo": (distribute(den, ctx, tiling_strategy="overlap_tiling", overlap=8), noisy),
             "basic": (distribute(den, ctx, tiling_strategy="basic"), noisy),
             "microbatch": (distribute(den, ctx, overlap=8, max_batch_size=4),
                            jnp.repeat(noisy, 12, axis=0))}
    got = run("denoiser_distributed")["x_hat"]
    for key, (d, v) in calls.items():
        want = np.asarray(jax.jit(lambda u: d(u, 0.15))(v))
        assert np.array_equal(got[key].numpy(), want), key


def test_native_dataloader():
    """The native decoder reads 4 batches of (8, 3, 64, 64) from the 32
    PNGs; an item is (3, 64, 64) float32; the means are those of uniform
    noise."""
    out = run("native_dataloader")
    assert out["native"] and out["item_shape"] == [3, 64, 64] and out["item_dtype"] == "float32"
    assert out["batch_shapes"] == [[8, 3, 64, 64]] * 4
    assert all(abs(m - 0.5) < 0.01 for m in out["batch_means"])


def test_native_dataloader_matches_jax():
    """The batch means within 1e-5 (relative) of the JAX package's
    ``ImageFolder.batches`` on the same 32 files."""
    from deepinv_tpu.datasets import ImageFolder
    from PIL import Image

    with tempfile.TemporaryDirectory() as root:
        rng = np.random.default_rng(0)
        for i in range(32):
            Image.fromarray((rng.uniform(0, 1, (96, 128, 3)) * 255).astype(np.uint8)).save(
                os.path.join(root, f"{i:03d}.png"))
        want = [float(np.asarray(b).mean()) for b in ImageFolder(root, size=(64, 64)).batches(8)]
    assert run("native_dataloader")["batch_means"] == pytest.approx(want, rel=1e-5)


def test_io():
    """The four readers give the printed shapes, and the errors lie within
    the printed ones (npy 0, the 16-bit TIFF 7.6e-06 rescaled)."""
    out = run("io")
    assert out["npy_shape"] == out["mat_img_shape"] == out["tiff_shape"] == [64, 64]
    assert out["npy_maxerr"] == 0.0 and out["mat_keys"] == ["img", "pixel_size"]
    assert out["tiff_dtype"] == "uint16" and out["tiff_maxerr"] < 1e-5
    assert out["h5_shape"] == out["img_shape"] == [1, 1, 64, 64]


def test_hdf5_convention():
    """The JAX demo's asserts (the transform halves x, not y) and its
    printed members, parameters, NaN ground truth and stacked parts, at the
    fast size (H = 32, the JAX demo's own fast size)."""
    out = run("hdf5_convention")
    H = out["H"]
    assert H == 32
    assert out["members"] == ["sigma_test", "sigma_train", "x_test", "x_train", "y_test",
                              "y_train"]
    assert out["train_item"]["params"] == ["sigma"] and out["val"]["params"] == ["mask"]
    assert out["deploy_x_nan"] and out["stacked_parts"] == [[1, H, H]] * 2
    assert out["transform"] == {"x": [1, H // 2, H // 2], "y": [1, H, H]}


def test_hdf5_convention_matches_jax(monkeypatch):
    """The members and every printed shape equal the JAX demo's, run at its
    fast size (H = 32): the same files' layout, read back the same way. The
    JAX demo reads its fast mode from the environment and puts ``examples/``
    on ``sys.path`` to import its ``_util``; both are undone after the test."""
    monkeypatch.setenv("DEEPINV_TPU_DEMO_FAST", "1")
    monkeypatch.setattr(sys, "path", list(sys.path))
    had_util = "_util" in sys.modules
    spec = importlib.util.spec_from_file_location(
        "jax_demo_hdf5_convention", os.path.join(ROOT, "examples", "demo_hdf5_convention.py"))
    mod = importlib.util.module_from_spec(spec)
    jax_out = io.StringIO()
    try:
        spec.loader.exec_module(mod)
        with contextlib.redirect_stdout(jax_out):
            path = mod.main()
    finally:
        if not had_util:
            sys.modules.pop("_util", None)
    shutil.rmtree(os.path.dirname(path), ignore_errors=True)
    out, port_out = run_printed("hdf5_convention")
    shape = re.compile(r"\(\d+(?:, \d+)*,?\)")
    members = [l for l in jax_out.getvalue().splitlines() if l.startswith("members:")]
    assert members and members[0] == f"members: {out['members']}"
    assert shape.findall(port_out) == shape.findall(jax_out.getvalue())
    assert len(shape.findall(jax_out.getvalue())) == 10


@pytest.mark.parametrize("name", OTHERS)
def test_phase_25_claim_holds_on_the_fast_run(name):
    """``chip_smoke.py`` phase 25's claim of the demo reads the keys of its
    fast CPU run and holds there."""
    import chip_smoke

    what, claim = chip_smoke.GALLERY25_CLAIMS[name]
    assert claim(run(name)) is True, what


def test_phase_25_bookkeeping():
    """Phase 25's claims cover exactly its 21 demos, the last 21 of the
    gallery, none at its fast size; phases 23 and 24 still select their 30
    and 32; the demos that need a package (or the native decoder) are the
    four datasets-side ones of this phase and custom_dataset, each with its
    packages; the three phases run every demo of the gallery once."""
    import chip_smoke
    from deepinv_tpu_torch.examples import GALLERY

    names = chip_smoke.gallery_names(25)
    assert len(names) == 21 and set(names) == set(chip_smoke.GALLERY25_CLAIMS)
    assert set(names) == set(OTHERS) | set(importlib.import_module(
        "test_torch_gallery_selfsup").SELFSUP)
    assert chip_smoke.GALLERY25_FAST == () and chip_smoke.GALLERY_PHASES[25][2] == ()
    assert 25 not in chip_smoke.GALLERY_CPU_GROUPS
    assert chip_smoke.gallery_cpu_runs(25) == (None, [])
    n23, n24 = chip_smoke.gallery_names(23), chip_smoke.gallery_names(24)
    assert (len(n23), len(n24)) == (30, 32)
    assert set(n23) == set(chip_smoke.GALLERY_CLAIMS)
    assert set(n24) == set(chip_smoke.GALLERY24_CLAIMS)
    assert sorted(n23 + n24 + names) == sorted(GALLERY)
    assert chip_smoke.GALLERY_PACKAGES == {
        "custom_dataset": ("h5py",), "microscopy_denoising": ("PIL",),
        "native_dataloader": ("PIL",), "io": ("PIL", "h5py", "scipy"),
        "hdf5_convention": ("h5py",)}
    assert chip_smoke.GALLERY_NATIVE == ("native_dataloader",)


def test_phase_25_names_what_the_host_lacks(monkeypatch):
    """On a host without PIL and h5py (the card's, as phase 25 expects) the
    four demos that need them are named with the missing packages, in their
    order; without the native decoder native_dataloader names it and why;
    a demo that needs nothing is run."""
    import importlib.util

    import chip_smoke
    import deepinv_tpu_torch.native as native

    find_spec = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda n, *a: None if n in ("PIL", "h5py") else find_spec(n, *a))
    assert {n: chip_smoke.gallery_missing(n) for n in chip_smoke.gallery_names(25)
            if chip_smoke.gallery_missing(n)} == {
        "microscopy_denoising": ["PIL"], "native_dataloader": ["PIL"], "io": ["PIL", "h5py"],
        "hdf5_convention": ["h5py"]}
    monkeypatch.setattr(importlib.util, "find_spec", find_spec)
    monkeypatch.setattr(native, "native_available", lambda: False)
    monkeypatch.setitem(native._state, "error", "libpng16.so.16: cannot open shared object file")
    assert chip_smoke.gallery_missing("native_dataloader") == [
        "native image decoder (libpng16.so.16: cannot open shared object file)"]
    assert chip_smoke.gallery_missing("selfsup_ei") == []
