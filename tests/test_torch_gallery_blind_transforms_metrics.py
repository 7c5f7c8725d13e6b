"""The gallery's blind, transforms and metrics demos on the port, run
in-process on the CPU at their fast sizes, each held to the claim its JAX
demo asserts or prints (see ``tests/test_torch_gallery_basics.py``). None
runs the TV prox.

The JAX demos printed, on the CPU, at their full sizes: blind deblurring's
estimated filters (1, 1, 4, 33, 33) and multipliers (1, 1, 4, 64, 64), PSNR
11.38 blurry against 4.46 reconstructed (untrained networks); blind
denoising's estimates within 7.4% (wavelet-MAD) and 14.1%
(patch-covariance), 18.28 -> 21.92 dB; the calibrated kernel's error 0.2829
-> 0.0031; the shift round trip exact and the equivariant filter 16.95 dB
against the anisotropic 16.20; EI eval PSNRs 13.62, 13.39, 13.38 (shift,
Euclidean, pan-tilt-rotate); the metrics MSE 0.0101, PSNR 19.9385, SSIM
0.4767, LPIPS mild 0.00008 against heavy 0.00158, the sharpness index inf
(see :func:`test_metrics`); the fitted NIQE 0.98 clean, 20.92 noisy, 3.06
blurry, 6.73 denoised.
"""

import functools
import importlib

import numpy as np
import torch

import test_torch_drunet  # noqa: F401  (each xdist worker takes its share of the cores)


def demo(name):
    return importlib.import_module(f"deepinv_tpu_torch.examples.demo_{name}")


@functools.lru_cache(maxsize=None)
def run(name):
    """The demo's fast run on the CPU, once a worker."""
    return demo(name).main(device="cpu", fast=True)


def test_blind_deblur():
    """The kernel identification network estimates four 33x33 kernels and
    their multipliers, and the solve on them is finite and of the image's
    shape (the networks are untrained, so no PSNR is claimed)."""
    out = run("blind_deblur")
    assert out["filters_shape"] == [1, 1, 4, 33, 33]
    assert out["multipliers_shape"] == [1, 1, 4, 64, 64]
    assert out["xhat_shape"] == [1, 3, 64, 64] and out["xhat_finite"]


def test_blind_denoising():
    """Each estimator within 35% and the blind pipeline gains over 2 dB
    (asserted in JAX)."""
    out = run("blind_denoising")
    assert max(out["rel_error"].values()) < 0.35
    assert out["psnr_xhat"] > out["psnr_y"] + 2.0


def test_optimize_physics_parameter():
    """The calibrated kernel's error falls below half the delta's (asserted
    in JAX), as does the loss."""
    out = run("optimize_physics_parameter")
    assert out["kernel_error"] < 0.5 * out["kernel_error_start"]
    assert out["loss_last"] < out["loss_first"]


def test_transforms():
    """A sampled shift inverts within 1e-5 (asserted in JAX). The group
    average with the draw of seed 0 (no turn, no flip) is the filter
    itself, so it equals the anisotropic PSNR; the JAX demo's key drew a
    quarter turn and gained."""
    out = run("transforms")
    assert out["shift_round_trip"] < 1e-5
    assert abs(out["psnr_equivariant"] - out["psnr_anisotropic"]) < 1e-4


def test_transforms_quarter_turn_average_gains():
    """The demo's average with a draw that turns a quarter (seed 1: 90
    degrees, a flip) makes the 1x7 filter more isotropic and gains on the
    phantom, as the JAX demo prints."""
    from deepinv_tpu_torch.datasets import shepp_logan
    from deepinv_tpu_torch.loss import PSNR
    from deepinv_tpu_torch.models import EquivariantDenoiser
    from deepinv_tpu_torch.transform import Reflect, Rotate

    m = demo("transforms")
    x = torch.from_numpy(shepp_logan(64))[None, None]
    y = x + 0.1 * torch.randn(x.shape, generator=m._util.generator(2))
    t = Rotate(multiples=90) + Reflect()
    assert float(t.get_params(y, m._util.generator(1))["p1"]["theta"][0]) == 90.0
    equiv = EquivariantDenoiser(m.box_1x7, transform=t)
    gain = float(PSNR()(equiv(y, 0.1, generator=m._util.generator(1)), x)[0]
                 - PSNR()(m.box_1x7(y), x)[0])
    assert gain > 0.3


def test_ei_projective():
    """Each group's EI training lowers its loss and gives a finite eval
    PSNR."""
    out = run("ei_projective")
    assert set(out["psnr"]) == {"Shift", "Euclidean", "PanTiltRotate"}
    for name, hist in out["loss_history"].items():
        assert hist[-1] < hist[0] and np.isfinite(out["psnr"][name]), name


def test_metrics():
    """LPIPS on random features ranks the mild noise below the heavy; SSIM
    as a training loss is 1 - SSIM; the mean reduction of one image is its
    PSNR; the magnitude PSNR of equal complex images is the 120 dB cap. The
    sharpness index of the phantom saturates: the JAX package prints inf
    (its clip of erfc at 1e-38, a float32 subnormal, flushes to zero on
    XLA's CPU) and the port the clip's finite value."""
    out = run("metrics")
    assert out["LPIPS_mild"] < out["LPIPS_heavy"]
    assert abs(out["SSIM_train_loss"] - (1 - out["SSIM"])) < 1e-6
    assert abs(out["PSNR_mean"] - out["PSNR"]) < 1e-5 and out["PSNR_complex_abs"] == 120.0
    assert 19.5 < out["PSNR"] < 20.5 and np.isfinite(out["SharpnessIndex"])


def test_custom_niqe():
    """The fitted NIQE scores the clean image below the noisy one (asserted
    in JAX), and below the blurred and denoised ones (printed)."""
    out = run("custom_niqe")
    n = out["niqe"]
    assert n["clean"] < n["noisy"] and n["clean"] < min(n["blurry"], n["denoised"])
