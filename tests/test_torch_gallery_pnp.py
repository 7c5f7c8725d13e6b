"""The gallery's plug-and-play demos on the port, run in-process on the
CPU, each held to the claim its JAX demo prints (see
``tests/test_torch_gallery_basics.py``). The JAX demos printed, on the CPU
(dB): DPIR 20.30 -> 21.94; vanilla PnP 13.03 -> 21.57; PnP-MD 25.17 ->
25.85; RED 19.55 against the zero-filled 17.89; coarse-to-fine 20.83
against single-scale 19.21; db4, Haar and TV 21.49, 20.51, 24.72 against
the masked input's 12.72.
"""

import importlib

import numpy as np
import torch

import test_torch_drunet  # noqa: F401  (each xdist worker takes its share of the cores)


def demo(name):
    return importlib.import_module(f"deepinv_tpu_torch.examples.demo_{name}")


def test_pnp_dpir_deblur():
    """DPIR with the TV fallback beats the blurred measurement (64x64)."""
    out = demo("pnp_dpir_deblur").main(device="cpu", fast=True)
    assert out["psnr_xhat"] > out["psnr_y"] + 0.3


def test_vanilla_pnp():
    """The hand-rolled PnP loop beats the measurement (asserted in JAX)."""
    out = demo("vanilla_pnp").main(device="cpu", fast=True)
    assert out["psnr_xhat"] > out["psnr_y"] + 5


def test_pnp_mirror_descent():
    """Mirror descent in Burg's entropy beats the Poisson measurement
    (asserted in JAX)."""
    out = demo("pnp_mirror_descent").main(device="cpu", fast=True)
    assert out["psnr_xhat"] > out["psnr_y"]


def test_red_sr():
    """RED beats the zero-filled upsampling."""
    out = demo("red_sr").main(device="cpu", fast=True)
    assert out["psnr_xhat"] > out["psnr_naive"] + 0.5


def test_pnp_multiscale():
    """Coarse to fine beats 40 fine iterations, and its 10 fine iterations
    improve on the upsampled coarse iterate."""
    out = demo("pnp_multiscale").main(device="cpu", fast=True)
    assert out["psnr_c2f"] > out["psnr_fine"] and out["psnr_c2f"] > out["psnr_coarse_up"]
    assert out["psnr_fine"] > out["psnr_y"] + 5


def test_wavelet_prior():
    """Each prior beats the masked input, and TV beats both wavelets."""
    out = demo("wavelet_prior").main(device="cpu", fast=True)
    for k in ("psnr_db4", "psnr_haar", "psnr_tv"):
        assert out[k] > out["psnr_masked"] + 3
    assert out["psnr_tv"] > max(out["psnr_db4"], out["psnr_haar"])


def _rel(got, want):
    g, w = np.asarray(got.detach().cpu(), np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def test_pnp_dpir_deblur_reconstruction_matches_jax():
    """demo_pnp_dpir_deblur at its fast size (3x64x64, 8 DPIR iterations
    with the TV stand-in) within 1e-5 (relative L2) of the JAX package's
    DPIR on the demo's own measurement (the port's draw from its seed), as
    examples/demo_pnp_dpir_deblur.py calls it."""
    import jax
    import jax.numpy as jnp
    from deepinv_tpu.models import TVDenoiser as JTV
    from deepinv_tpu.ops import gaussian_blur as jblur
    from deepinv_tpu.optim import DPIR as JDPIR
    from deepinv_tpu.physics import BlurFFT as JBlurFFT
    from deepinv_tpu_torch.datasets import shepp_logan
    from deepinv_tpu_torch.ops import gaussian_blur
    from deepinv_tpu_torch.physics import BlurFFT, GaussianNoise

    m = demo("pnp_dpir_deblur")
    out = m.main(device="cpu", fast=True)
    x = torch.from_numpy(shepp_logan(64))[None, None].repeat(1, 3, 1, 1)
    tp = BlurFFT((3, 64, 64), filter=gaussian_blur(sigma=2.0),
                 noise_model=GaussianNoise(0.03, device="cpu"), device="cpu")
    y = jnp.asarray(tp(x, generator=m._util.generator(0)).numpy())
    jp = JBlurFFT(img_size=(3, 64, 64), filter=jblur(sigma=2.0))
    model = JDPIR(sigma=0.03, denoiser=lambda u, s: JTV(30)(u, 0.1 * s))
    want = jax.jit(lambda md, yv, p: md(yv, p))(model, y, jp)
    assert _rel(out["x_hat"]["dpir"], want) <= 1e-5


def test_wavelet_prior_reconstructions_match_jax():
    """demo_wavelet_prior's three PGD reconstructions at its fast size (25
    iterations each of db4, Haar and TV) within 1e-5 (relative L2) of the
    JAX package's on the demo's own mask and measurement, as
    examples/demo_wavelet_prior.py calls them."""
    import jax.numpy as jnp
    from deepinv_tpu.optim import L2 as JL2
    from deepinv_tpu.optim import TVPrior as JTVPrior
    from deepinv_tpu.optim import WaveletPrior as JWavelet
    from deepinv_tpu.optim import optim_builder as jbuild
    from deepinv_tpu.physics import Inpainting as JInpainting
    from deepinv_tpu_torch.datasets import random_circles
    from deepinv_tpu_torch.physics import GaussianNoise, Inpainting

    m = demo("wavelet_prior")
    out = m.main(device="cpu", fast=True)
    x = torch.from_numpy(random_circles(64, seed=4))[None]
    tp = Inpainting((1, 64, 64), mask=0.4, generator=m._util.generator(0),
                    noise_model=GaussianNoise(0.02, device="cpu"), device="cpu")
    y = jnp.asarray(tp(x, generator=m._util.generator(1)).numpy())
    jp = JInpainting(img_size=(1, 64, 64), mask=jnp.asarray(tp.mask.numpy()))
    for key, prior in (("db4", JWavelet(wv="db4", level=3)), ("haar", JWavelet(wv="haar", level=3)),
                       ("tv", JTVPrior())):
        model = jbuild("PGD", data_fidelity=JL2(), prior=prior,
                       params_algo={"stepsize": 1.0, "lambda": 0.02, "g_param": 1.0},
                       max_iter=25)
        assert _rel(out["x_hat"][key], model(y, jp)) <= 1e-5, key
