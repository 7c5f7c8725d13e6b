"""The gallery's models and performance demos on the port, run in-process on
the CPU at their fast sizes, each held to the claim its JAX demo asserts or
prints (see ``tests/test_torch_gallery_basics.py``); the two that run the TV
prox (the Chambolle kernel on the card) are also held to the JAX package on
their own noisy images.

The JAX demos printed, on the CPU, at their full sizes (dB): classic
denoisers on the 96x96 phantom 20.06 noisy, median 20.86, db4 24.00, TV
26.90, BM3D 29.32; the denoiser tour 20.09 noisy, median 24.28, bilateral
24.06, TV 29.53, TGV 28.81, db8 24.01, wavelet dictionary 24.95, BM3D 27.66,
fitted EPLL 22.62; DEAL's denoised range 0.0 to 0.769 and a (1, 1, 32, 32)
reconstruction; the trainer's test PSNR 18.67 reproduced on resume; RAM's
three outputs of their inputs' shapes; super-resolution adjoint and dagger
20.56 and 21.15 (Gaussian), 22.02 and 22.45 (bicubic), 11.50 and 11.50
(none), PnP-HQS 22.12 against the dagger's 20.76; the volumetric CNNs'
inflation within 1.19e-07, noisy 13.85, slice-wise 2-D 18.18, fine-tuned
3-D 20.38; the batched throughput on the CPU 20.3 images/s at B=1 and 18.9
at B=8, PSNR 17.94 at both.
"""

import functools
import importlib

import numpy as np

import test_torch_drunet  # noqa: F401  (each xdist worker takes its share of the cores)


def demo(name):
    return importlib.import_module(f"deepinv_tpu_torch.examples.demo_{name}")


@functools.lru_cache(maxsize=None)
def run(name):
    """The demo's fast run on the CPU, once a worker (a claim and a parity
    test share it)."""
    return demo(name).main(device="cpu", fast=True)


def _rel(got, want):
    g, w = np.asarray(got.detach().cpu(), np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def test_classic_denoisers():
    """Each denoiser beats the noisy input, in the printed order: median,
    db4, TV, BM3D."""
    out = run("classic_denoisers")
    p = out["psnr"]
    assert out["psnr_y"] < p["median 3x3"] < p["wavelet db4"] < p["TV (Chambolle)"] < p["BM3D"]


def test_denoiser_tour():
    """Each of the eight beats the noisy input, and TV is the best of them."""
    out = run("denoiser_tour")
    assert len(out["psnr"]) == 8 and min(out["psnr"].values()) > out["psnr_y"]
    assert max(out["psnr"], key=out["psnr"].get) == "TV"


def test_deal_reconstruction():
    """The denoised image lies in [0, 1] (DEAL clamps its output) and the
    reconstruction from the inpainting measurement has the image's shape and
    is finite."""
    out = run("deal_reconstruction")
    assert 0.0 <= out["denoised_min"] <= out["denoised_max"] <= 1.0
    assert out["denoised_shape"] == out["xhat_shape"] == [1, 1, 32, 32] and out["xhat_finite"]


def test_training():
    """A fresh trainer that loads the last checkpoint reproduces the test
    PSNR within 1e-3 (asserted in JAX), and the training loss falls."""
    out = run("training")
    assert abs(out["psnr_resumed"] - out["psnr"]) < 1e-3
    assert out["loss_history"][-1] < out["loss_history"][0] and "ckp_best.pkl" in out["checkpoints"]


def test_foundation_model():
    """Each of the three tasks gives a finite output of its input's shape
    (asserted in JAX)."""
    out = run("foundation_model")
    assert len(out["shape_ok"]) == 3
    assert all(out["shape_ok"].values()) and all(out["finite"].values())


def test_super_resolution():
    """The pseudo-inverse is at least the rescaled adjoint for each filter,
    and PnP-HQS beats the pseudo-inverse under noise."""
    out = run("super_resolution")
    for name in ("gaussian", "bicubic", "none"):
        assert out[f"psnr_dagger_{name}"] >= out[f"psnr_adjoint_{name}"] - 1e-4, name
    assert out["psnr_xhat"] > out["psnr_dagger"]


def test_3d_cnn_denoisers():
    """The inflated 3-D network reproduces the slice-wise 2-D one within
    1e-5 before fine-tuning, and the fine-tuned 3-D network beats the
    slice-wise 2-D (at the fast size, 10 and 8 steps)."""
    out = run("3d_cnn_denoisers")
    assert out["inflation_max_diff"] < 1e-5
    assert out["psnr_3d_finetuned"] > out["psnr_2d"]


def test_batched_throughput():
    """Both batches run and report a rate and a PSNR; the first image's
    reconstruction does not depend on its batch (within 1e-5). Whether
    images/s climb with the batch is a property of the device: the card's
    run holds that claim."""
    out = run("batched_throughput")
    assert set(out["images_per_s"]) == {"1", "4"} and min(out["images_per_s"].values()) > 0
    assert out["first_image_rel_diff"] < 1e-5 and min(out["psnr"].values()) > 10


def test_the_port_prints_no_tpu_numbers():
    """No docstring or printed string of these demos carries the JAX demos'
    TPU figures or a TPU label."""
    for name in ("classic_denoisers", "batched_throughput"):
        text = " ".join(open(demo(name).__file__).read().split())
        for word in ("TPU", "v5e", "MFU", "pallas", "434"):
            assert word not in text, (name, word)


def test_classic_denoisers_tv_matches_jax():
    """demo_classic_denoisers' TV output (100 Chambolle steps at 0.12, the
    96x96 phantom) within 1e-5 (relative L2) of the JAX package's on the
    demo's own noisy image."""
    import jax
    import jax.numpy as jnp
    import torch
    from deepinv_tpu.models import TVDenoiser as JTV
    from deepinv_tpu_torch.datasets import shepp_logan

    m = demo("classic_denoisers")
    out = run("classic_denoisers")
    x = torch.from_numpy(shepp_logan(96))[None, None]
    y = x + m.SIGMA * torch.randn(x.shape, generator=m._util.generator(0))
    want = jax.jit(lambda d, v: d(v, 0.12))(JTV(100), jnp.asarray(y.numpy()))
    assert _rel(out["x_hat"]["tv"], want) <= 1e-5


def test_denoiser_tour_tv_matches_jax():
    """demo_denoiser_tour's TV output (200 Chambolle steps at 25/255) within
    1e-5 (relative L2) of the JAX package's on the demo's own noisy image."""
    import jax
    import jax.numpy as jnp
    import torch
    from deepinv_tpu.models import TVDenoiser as JTV
    from deepinv_tpu_torch.datasets import random_circles

    m = demo("denoiser_tour")
    out = run("denoiser_tour")
    x = torch.from_numpy(random_circles(64, seed=7))[None]
    y = x + m.SIGMA * torch.randn(x.shape, generator=m._util.generator(0))
    want = jax.jit(lambda d, v: d(v, m.SIGMA))(JTV(), jnp.asarray(y.numpy()))
    assert _rel(out["x_hat"]["tv"], want) <= 1e-5
