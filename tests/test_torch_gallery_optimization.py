"""The gallery's optimization demos on the port, run in-process on the
CPU, each held to the claim its JAX demo prints (see
``tests/test_torch_gallery_basics.py``). The JAX demos printed, on the CPU
(dB): PGD, ADMM, CP 23.72, 23.17, 23.15 against 20.31; exact TV 24.09 and
Huber TV 24.40 against 12.66; EPLL 19.92 -> 22.38; MLEM 17.76 against the
FBP's 12.72; DIP 14.35 -> 18.05; the volume 10.44 -> 16.62 (2D), 16.81
(3D), 17.69 (dictionary); unfolded PGD-TV 25.77 against the FBP's 24.03.
"""

import importlib

import numpy as np
import torch

import test_torch_drunet  # noqa: F401  (each xdist worker takes its share of the cores)


def demo(name):
    return importlib.import_module(f"deepinv_tpu_torch.examples.demo_{name}")


def test_tv_minimisation():
    """PGD, ADMM and CP each within 0.5 dB of the measurement or above it
    (asserted in JAX); here each is above it."""
    out = demo("tv_minimisation").main(device="cpu", fast=True)
    for k in ("psnr_pgd", "psnr_admm", "psnr_cp"):
        assert out[k] > out["psnr_y"] - 0.5 and out[k] > out["psnr_y"]


def test_custom_prior():
    """Exact TV and the custom Huber TV beat the measurement by far;
    Tikhonov does not move it by more than 0.5 dB."""
    out = demo("custom_prior").main(device="cpu", fast=True)
    assert out["psnr_tv"] > out["psnr_y"] + 5 and out["psnr_huber_tv"] > out["psnr_y"] + 5
    assert abs(out["psnr_tikhonov"] - out["psnr_y"]) < 0.5


def test_patch_priors():
    """EPLL with the fitted patch GMM denoises (32x32, 10 EM iterations)."""
    out = demo("patch_priors").main(device="cpu", fast=True)
    assert out["psnr_xhat"] > out["psnr_y"] + 1


def test_poisson_mlem():
    """MLEM beats the FBP of the Poisson sinogram."""
    out = demo("poisson_mlem").main(device="cpu", fast=True)
    assert out["psnr_mlem"] > out["psnr_fbp"] + 2


def test_dip():
    """The fitted decoder beats the measurement (asserted in JAX; 100 steps
    here)."""
    out = demo("dip").main(device="cpu", fast=True)
    assert out["psnr_xhat"] > out["psnr_y"]


def test_3d_denoising():
    """3D wavelets beat 2D per-slice ones, the dictionary beats both, and
    all beat the noisy volume."""
    out = demo("3d_denoising").main(device="cpu", fast=True)
    assert out["psnr_dict"] > out["psnr_3d"] > out["psnr_2d"] > out["psnr_noisy"] + 3


def test_ct_fbp_unfolded():
    """The unfolded PGD-TV beats the FBP it starts from (32x32)."""
    out = demo("ct_fbp_unfolded").main(device="cpu", fast=True)
    assert out["psnr_xhat"] > out["psnr_fbp"]


def _rel(got, want):
    g, w = np.asarray(got.detach().cpu(), np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def test_tv_minimisation_reconstructions_match_jax():
    """demo_tv_minimisation's PGD, ADMM and CP reconstructions at its fast
    size (10 iterations, a 20-step TV prox) each within 1e-5 (relative L2)
    of the JAX package's on the demo's own measurement (the port's draw from
    its seed), as examples/demo_tv_minimisation.py calls them."""
    import jax
    import jax.numpy as jnp
    from deepinv_tpu.ops import gaussian_blur as jblur
    from deepinv_tpu.optim import L2 as JL2
    from deepinv_tpu.optim import TVPrior as JTVPrior
    from deepinv_tpu.optim import optim_builder as jbuild
    from deepinv_tpu.physics import BlurFFT as JBlurFFT
    from deepinv_tpu_torch.datasets import random_circles
    from deepinv_tpu_torch.ops import gaussian_blur
    from deepinv_tpu_torch.physics import BlurFFT, GaussianNoise

    m = demo("tv_minimisation")
    out = m.main(device="cpu", fast=True)
    x = torch.from_numpy(random_circles(64, seed=0))[None]
    tp = BlurFFT((1, 64, 64), filter=gaussian_blur(sigma=2.0),
                 noise_model=GaussianNoise(0.02, device="cpu"), device="cpu")
    y = jnp.asarray(tp(x, generator=m._util.generator(0)).numpy())
    jp = JBlurFFT(img_size=(1, 64, 64), filter=jblur(sigma=2.0))
    run = jax.jit(lambda md, yv, p: md(yv, p))
    for algo, params in [("PGD", {"stepsize": 1.0, "lambda": 0.05}),
                         ("ADMM", {"stepsize": 0.5, "lambda": 0.05}),
                         ("CP", {"stepsize": 0.5, "sigma": 1.0, "lambda": 0.05})]:
        model = jbuild(algo, data_fidelity=JL2(), prior=JTVPrior(n_it_max=20),
                       params_algo=params, max_iter=10)
        assert _rel(out["x_hat"][algo.lower()], run(model, y, jp)) <= 1e-5, algo


def test_ct_fbp_unfolded_reconstruction_matches_jax():
    """demo_ct_fbp_unfolded at its fast size (32x32, 60 angles, no noise)
    within 1e-5 (relative L2) of the JAX package's unfolded PGD-TV on the
    same phantom, as examples/demo_ct_fbp_unfolded.py builds it."""
    import jax
    import jax.numpy as jnp
    from deepinv_tpu.models import TVDenoiser as JTV
    from deepinv_tpu.optim import L2 as JL2
    from deepinv_tpu.optim import PnP as JPnP
    from deepinv_tpu.physics import Tomography as JTomography
    from deepinv_tpu.unfolded import unfolded_builder as jbuild
    from deepinv_tpu_torch.datasets import shepp_logan

    out = demo("ct_fbp_unfolded").main(device="cpu", fast=True)
    x = jnp.asarray(shepp_logan(32))[None, None]
    jp = JTomography(angles=60, img_width=32, normalize=True, method="fourier")
    model = jbuild("PGD", data_fidelity=JL2(), prior=JPnP(lambda u, s: JTV(30)(u, 0.003)),
                   params_algo={"stepsize": 0.9, "g_param": 0.05}, max_iter=20,
                   custom_init=lambda yv, p: p.A_dagger(yv))
    want = jax.jit(lambda md, yv, p: md(yv, p))(model, jp.A(x), jp)
    assert _rel(out["x_hat"]["unfolded_pgd_tv"], want) <= 1e-5
