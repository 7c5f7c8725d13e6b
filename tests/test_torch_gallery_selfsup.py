"""The gallery's 13 self-supervised demos on the port
(``deepinv_tpu_torch/examples``), run in-process on the CPU at their fast
sizes, each held to the claim its JAX demo asserts or prints (see
``tests/test_torch_gallery_basics.py``), and to the claim ``chip_smoke.py``
phase 25 holds on the card (``GALLERY25_CLAIMS``). Where a demo's inputs are
deterministic it is also held to the JAX package: microscopy_denoising's
two mean PSNRs (the same files, written by numpy's generator), and
scan_specific's K-weight, the JAX formula on the port's sampling densities.

The JAX demos printed, on the CPU, at their full sizes: selfsup_ei
TotalLoss 0.0436 -> 0.01685, train PSNR 11.95 -> 14.04 dB over 10 epochs;
splitting_loss 0.13269 -> 0.03034, 12.58 -> 14.79, test PSNR 16.47 (std
0.68); sure_denoising SURE [0.0088 0.0072 0.0074 0.0096 0.0102 0.0033 0.0061
0.0062] against the true MSE [0.0095 0.008 0.0066 0.0098 0.0087 0.0031 0.006
0.0067], Poisson SURE 0.00841; r2r_denoising 0.10285 -> 0.05576, 14.54 ->
19.25; n2n_denoising 0.18779 -> 0.06038, 14.91 -> 19.27;
multioperator_imaging 0.03652 -> 0.01965, 12.03 -> 14.23; artifact2artifact
0.00947 -> 0.00764; unsure sigma 0.0637 -> 0.2519, closest visit 0.1006
(true 0.1), PSNR 19.92 -> 18.16 dB; equivariant_splitting 0.08611 ->
0.02633, 12.66 -> 17.30, test 16.57; poisson2sparse noisy 18.65, Anscombe +
median 23.71, Poisson2Sparse 23.99 dB; scan_specific K-weight [1.00, 5.76],
learned scale 1.141 (plain) and 0.867 (K-weighted), MoDL loss 0.04641 ->
0.01402 over 60 steps; microscopy_denoising 8 frames, 26.81 -> 29.67 dB;
lowfieldmri one repetition 16.39, the 3-average 16.87, R2R 21.91 dB.
"""

import functools
import importlib
import math

import numpy as np
import pytest

import test_torch_drunet  # noqa: F401  (each xdist worker takes its share of the cores)

SELFSUP = ("selfsup_ei", "splitting_loss", "sure_denoising", "r2r_denoising", "n2n_denoising",
           "multioperator_imaging", "artifact2artifact", "unsure", "equivariant_splitting",
           "poisson2sparse", "scan_specific", "microscopy_denoising", "lowfieldmri")


def demo(name):
    return importlib.import_module(f"deepinv_tpu_torch.examples.demo_{name}")


@functools.lru_cache(maxsize=None)
def run(name):
    """The demo's fast run on the CPU, once a worker (a claim and a parity
    test share it)."""
    return demo(name).main(device="cpu", fast=True)


def falls_and_rises(out):
    """An epoch's loss and train PSNR for each of at least 2 epochs, all
    finite, and phase 25's claim of them: the last epoch's loss below the
    first's and its train PSNR above."""
    import chip_smoke

    loss, psnr = out["loss_history"], out["psnr_history"]
    assert len(loss) == len(psnr) >= 2 and all(map(math.isfinite, loss + psnr))
    assert chip_smoke._falls_and_rises(out), (loss, psnr)


@pytest.mark.parametrize("name", ["selfsup_ei", "r2r_denoising", "n2n_denoising"])
def test_trainer_demo_learns(name):
    """EI, R2R and Neighbor2Neighbor: the loss falls and the train PSNR
    rises over the fast size's epochs (3, 2 and 2)."""
    falls_and_rises(run(name))


@pytest.mark.parametrize("name", ["splitting_loss", "equivariant_splitting"])
def test_splitting_demo_learns_and_tests(name):
    """The splitting demos learn over 3 epochs and their test PSNR (an
    average over random splits, or over the rotation group) is finite."""
    out = run(name)
    falls_and_rises(out)
    assert math.isfinite(out["psnr_test"]) and out["psnr_test"] > 10


def test_multioperator_imaging():
    """G = 3: the Trainer takes a batch of each of the 3 loaders a step,
    the loss falls and the train PSNR rises."""
    out = run("multioperator_imaging")
    assert out["operators"] == 3
    falls_and_rises(out)


def test_multioperator_batches_reach_their_own_operator(monkeypatch):
    """Each loader's batch is measured by its own operator and scored by the
    measurement-consistency loss with that same operator: the sequence of
    operators that measure equals the sequence that MCLoss sees, and each of
    the 3 takes a third of the batches."""
    from deepinv_tpu_torch.loss import MCLoss
    from deepinv_tpu_torch.training import Trainer

    measured, scored = [], []
    get_samples_online, mc_call = Trainer.get_samples_online, MCLoss.__call__

    def measure(self, batch, physics, *args, **kwargs):
        measured.append(id(physics))
        return get_samples_online(self, batch, physics, *args, **kwargs)

    def score(self, *args, physics=None, **kwargs):
        scored.append(id(physics))
        return mc_call(self, *args, physics=physics, **kwargs)

    monkeypatch.setattr(Trainer, "get_samples_online", measure)
    monkeypatch.setattr(MCLoss, "__call__", score)
    out = demo("multioperator_imaging").main(device="cpu", fast=True, epochs=1)
    assert measured == scored and len(set(measured)) == out["operators"] == 3
    assert sorted(measured.count(i) for i in set(measured)) == [4, 4, 4]  # 32 images / 8


def test_sure_denoising():
    """SURE's mean lies within 0.01 of the true MSE's (asserted in JAX);
    each image's estimate within 0.003 of its MSE; the Poisson variant's
    estimate is finite and of the MSE's order."""
    out = run("sure_denoising")
    assert abs(out["sure_mean"] - out["true_mse_mean"]) < 0.01
    assert np.max(np.abs(np.subtract(out["sure"], out["true_mse"]))) < 3e-3
    assert 0 < out["sure_poisson_mean"] < 0.05


def test_artifact2artifact():
    """The Artifact2Artifact loss falls over the fast size's 20 Adam steps
    (the JAX demo asserts it over 50)."""
    losses = run("artifact2artifact")["losses"]
    assert len(losses) == 20 and losses[-1] < losses[0]


def test_unsure():
    """The learned noise level's closest visit lies nearer the truth than
    its first value (asserted in JAX), over the fast size's 20 steps."""
    out = run("unsure")
    assert abs(out["sigma_closest"] - 0.1) < abs(out["sigmas"][0] - 0.1)
    assert len(out["sigmas"]) == 20 and all(map(math.isfinite, out["sigmas"]))


def test_poisson2sparse():
    """Poisson2Sparse (100 steps at the fast size) and Anscombe + median
    each beat the noisy image."""
    out = run("poisson2sparse")
    assert min(out["psnr_poisson2sparse"], out["psnr_anscombe_median"]) > out["psnr_y"] + 3


def test_scan_specific():
    """The MoDL fine-tune's loss falls (over 10 steps at the fast size); the
    K-weight's range is JAX's [1.00, 5.76]: its bottom exactly, its top
    within 5% (both packages' densities are Monte-Carlo means of 2000 mask
    draws, and the top comes from the least sampled column); the learned
    scales are finite."""
    from chip_smoke import SCAN_K_WEIGHT, SCAN_K_WEIGHT_RTOL

    out = run("scan_specific")
    assert out["finetune_losses"][-1] < out["finetune_losses"][0]
    assert abs(out["k_weight_min"] - SCAN_K_WEIGHT[0]) < 1e-3
    assert abs(out["k_weight_max"] / SCAN_K_WEIGHT[1] - 1) < SCAN_K_WEIGHT_RTOL
    assert all(map(math.isfinite, out["scale"].values()))


def test_scan_specific_k_weight_matches_jax():
    """The port's K-weight formula within 1e-5 (relative) of the JAX
    package's (``WeightedSplittingLoss.compute_weight``, under ``jax.jit``)
    on the same sampling densities, the demo's generators' means over 2000
    draws each, drawn once, by the port (JAX's own 2000 draws take most of
    a minute here); the demo's K-weight range is that of these densities."""
    import jax
    import jax.numpy as jnp
    import torch
    from deepinv_tpu.loss import WeightedSplittingLoss as JW
    from deepinv_tpu_torch.loss import WeightedSplittingLoss
    from deepinv_tpu_torch.loss.mri import _AVERAGE_BATCH
    from deepinv_tpu_torch.physics.generator import (BernoulliSplittingMaskGenerator,
                                                     GaussianMaskGenerator)

    gen = GaussianMaskGenerator((2, 64, 64), acceleration=4, device="cpu")
    split = BernoulliSplittingMaskGenerator((2, 64, 64), split_ratio=0.6, device="cpu")
    P = gen.average(n=2000, batch_size=_AVERAGE_BATCH)["mask"]
    P_tilde = split.average(n=2000, batch_size=_AVERAGE_BATCH)["mask"]
    weight = WeightedSplittingLoss.compute_weight(split, gen, P=P, P_tilde=P_tilde)

    class Given:
        def __init__(self, density):
            self.density = jnp.asarray(density.numpy())

        def average(self, **kwargs):
            return {"mask": self.density}

    want = jax.jit(lambda: JW.compute_weight(Given(P_tilde), Given(P)))()
    out = run("scan_specific")
    assert torch.equal(torch.tensor([out["k_weight_min"], out["k_weight_max"]]),
                       torch.stack([weight.min(), weight.max()]))
    w, v = np.asarray(weight, np.float64), np.asarray(want, np.float64)
    assert w.shape == v.shape == (1, 64)
    assert np.linalg.norm(w - v) / np.linalg.norm(v) <= 1e-5


def test_microscopy_denoising():
    """8 frames read through ``FMD``; the denoised frames beat the noisy."""
    out = run("microscopy_denoising")
    assert out["n_frames"] == 8 and out["psnr_denoised"] > out["psnr_noisy"] + 1


def test_microscopy_denoising_matches_jax():
    """Both mean PSNRs within 1e-5 (relative) of the JAX package's FMD,
    Anscombe and db4 wavelets (under ``jax.jit``) on the same files."""
    import tempfile

    import jax
    import jax.numpy as jnp
    from deepinv_tpu.datasets import FMD
    from deepinv_tpu.loss import PSNR
    from deepinv_tpu.models import AnscombeDenoiser, WaveletDenoiser

    m = demo("microscopy_denoising")
    out = run("microscopy_denoising")
    den = AnscombeDenoiser(WaveletDenoiser("db4", level=3), gain=1 / 30.0)
    denoise = jax.jit(lambda v: den(v, 0.6))
    psnr = PSNR()
    to_arr = lambda im: jnp.asarray(np.asarray(im), jnp.float32)[None] / 255.0
    vals_in, vals_out = [], []
    with tempfile.TemporaryDirectory() as root:
        m.fabricate_fmd(root)
        for clean, noisy in FMD(root, img_types=["Confocal_BPAE_B"], noise_levels=(1, 2),
                                fovs=(1, 2), transform=to_arr, target_transform=to_arr):
            vals_in.append(float(psnr(noisy[None], clean[None])[0]))
            vals_out.append(float(psnr(denoise(noisy[None]), clean[None])[0]))
    assert len(vals_in) == out["n_frames"]
    assert out["psnr_noisy"] == pytest.approx(np.mean(vals_in), rel=1e-5)
    assert out["psnr_denoised"] == pytest.approx(np.mean(vals_out), rel=1e-5)


def test_lowfieldmri():
    """The R2R denoiser (100 steps at the fast size) beats the single
    repetition and the motion-blurred 3-repetition average."""
    out = run("lowfieldmri")
    assert out["psnr_r2r"] > max(out["psnr_single"], out["psnr_average"])
    assert out["psnr_average"] > out["psnr_single"]


@pytest.mark.parametrize("name", SELFSUP)
def test_phase_25_claim_holds_on_the_fast_run(name):
    """``chip_smoke.py`` phase 25's claim of the demo reads the keys of its
    fast CPU run and holds there."""
    import chip_smoke

    what, claim = chip_smoke.GALLERY25_CLAIMS[name]
    assert claim(run(name)) is True, what
