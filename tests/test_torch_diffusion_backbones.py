"""DiffUNet, EDMPrecond and NCSNpp of the port against the JAX package's, on
the CPU, and the samplers over them: DDRM, DiffPIR and DPS over a small
DiffUNet, and PosteriorDiffusion over EDMDiffusionSDE with an NCSNpp, with
the JAX samplers' draws passed in (``test_torch_sampling.py``'s helpers).

Every JAX leaf is redrawn at random and carried by ``load_jax_params``
(``test_torch_attention_models.randomized``). Bounds: the networks within
1e-4 relative max error in f32, the samples within 1e-4 relative L2 (the
sampling tests' f32 bound); the ``pretrained=`` round trip is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepinv_tpu.models as JM
import deepinv_tpu_torch.models as TM
from deepinv_tpu import sampling as jsamp
from deepinv_tpu.core.rng import ensure_key
from deepinv_tpu_torch import sampling as tsamp
from deepinv_tpu_torch.models.convert import ncsnpp_names, upstream_state_dict
from test_torch_attention_models import BOUND, crossed, image, jrun, rel, run
from test_torch_drunet import DEV, jax_built
from test_torch_sampling import SIZE, _first_then_steps, _inpainting, _rel, _solver_draws, _sr, _t

DIFF = dict(nc=(8, 16, 16), num_res_blocks=1)


@pytest.fixture(scope="module")
def diffunets():
    return crossed(jax_built(JM.DiffUNet, key=jax.random.key(0), **DIFF),
                   TM.DiffUNet(device=DEV, **DIFF), 1)


@pytest.fixture(scope="module")
def diffunets_gray():
    kw = dict(DIFF, in_channels=1, out_channels=1)
    return crossed(jax_built(JM.DiffUNet, key=jax.random.key(2), **kw),
                   TM.DiffUNet(device=DEV, **kw), 3)


# sigmas off the midpoints between entries of the timestep table
SIGMAS = np.array([0.0731, 0.4117], np.float32)


@pytest.mark.parametrize("mode,shape", [(None, (2, 3, 16, 16)), (None, (2, 3, 10, 14)),
                                        ("timestep", (2, 3, 16, 16)),
                                        ("noise_level", (2, 3, 16, 16))])
def test_diffunet_matches_jax(diffunets, mode, shape):
    """DiffUNet as a denoiser (log-sigma embedding, ``x - s eps``; a size off
    the 4 grid through ``test_pad``), at raw timesteps and through the DDPM
    schedule's timestep lookup."""
    ref, port = diffunets
    x = image(shape, 4)
    s = np.array([17.0, 503.0], np.float32) if mode == "timestep" else SIGMAS
    got = run(port, x, torch.from_numpy(s), type_t=mode)
    assert got.shape == shape
    assert rel(got, jrun(ref, jnp.asarray(x), jnp.asarray(s), type_t=mode)) <= BOUND


def test_diffunet_defaults_run():
    """At its defaults (two residual blocks a level) the JAX module raises
    (its later up blocks expect the skip's channels again); the port builds
    them for the channels they are fed and runs."""
    with pytest.raises(TypeError):
        JM.DiffUNet(nc=(8, 16, 16))(jnp.zeros((1, 3, 8, 8)), 0.1)
    port = TM.DiffUNet(nc=(8, 16, 16), device=DEV, generator=torch.Generator().manual_seed(0))
    assert np.isfinite(run(port, image((1, 3, 8, 8), 5), 0.1)).all()


def test_diffunet_tables_patches_and_fp16_match_jax(diffunets):
    """``get_alpha_prod``'s tables and ``find_nearest`` against JAX;
    ``patch_forward`` over 8² tiles of a wrap-padded 10x20 input; the bf16
    copy of ``convert_to_fp16`` and back."""
    ref, port = diffunets
    for got, want in zip(port.get_alpha_prod(), ref.get_alpha_prod()):
        # numpy's sequential cumprod against XLA's over 1000 float32 factors
        assert rel(got.numpy(), want) <= 1e-5
    table = port.get_alpha_prod()[3]
    v = np.array([0.013, 0.5, 0.99], np.float32)
    assert np.array_equal(port.find_nearest(table, torch.from_numpy(v)).numpy(),
                          np.asarray(ref.find_nearest(jnp.asarray(table.numpy()), jnp.asarray(v))))
    x = image((1, 3, 10, 20), 6)
    got = port.patch_forward(torch.from_numpy(x), torch.tensor(0.2), patch_size=8)
    want = ref.patch_forward(jnp.asarray(x), 0.2, patch_size=8)
    assert got.shape == x.shape and rel(got.detach().numpy(), want) <= BOUND
    half = port.convert_to_fp16()
    assert all(p.dtype == torch.bfloat16 for p in half.parameters())
    assert all(p.dtype == torch.float32 for p in port.parameters())
    back = half.convert_to_fp32()
    for (k, a), b in zip(back.state_dict().items(), port.state_dict().values()):
        assert torch.equal(a, b.to(torch.bfloat16).float()), k


def test_edm_precond_matches_jax(diffunets):
    """EDMPrecond over the DiffUNet: ``c_noise`` passed as the backbone's
    sigma, which takes its log again (the JAX package's convention)."""
    ref, port = diffunets
    x = image((2, 3, 16, 16), 7)
    s = np.array([0.05, 2.5], np.float32)
    got = run(TM.EDMPrecond(port), x, torch.from_numpy(s))
    assert rel(got, jrun(JM.EDMPrecond(ref), jnp.asarray(x), jnp.asarray(s))) <= BOUND
    tiny = run(TM.EDMPrecond(port), x, 1e-6)
    assert np.abs(tiny - x).max() <= 1e-3


# -- NCSN++ / DDPM++ --------------------------------------------------------------

NCSN = dict(img_resolution=16, model_channels=8, channel_mult=(1, 2), num_blocks=1,
            attn_resolutions=(8,))


@pytest.mark.parametrize("model_type,precond", [("ncsn", "edm"), ("ncsn", "ve-baseline"),
                                                ("ddpm", "edm"), ("ddpm", "ve-baseline")])
def test_ncsnpp_matches_jax(model_type, precond):
    """NCSN++ (Fourier embedding, residual FIR encoder) and DDPM++ (positional
    embedding) under both preconditionings, attention at 8², with
    augmentation labels in one case."""
    kw = dict(NCSN, model_type=model_type, precondition_type=precond)
    ref, port = crossed(jax_built(JM.NCSNpp, key=jax.random.key(8), **kw),
                        TM.NCSNpp(device=DEV, **kw), 9)
    x = image((2, 3, 16, 16), 10)
    aug = np.random.default_rng(11).standard_normal((2, 9)).astype(np.float32)
    extra = {"augment_labels": aug} if precond == "edm" and model_type == "ncsn" else {}
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(SIGMAS),
                   **{k: torch.from_numpy(v) for k, v in extra.items()}).numpy()
    want = jrun(ref, jnp.asarray(x), jnp.asarray(SIGMAS),
                **{k: jnp.asarray(v) for k, v in extra.items()})
    assert rel(got, want) <= BOUND


def test_ncsnpp_fir_resampling_matches_jax():
    """The FIR up and down resampling alone, fused and not, against the JAX
    dilated-conv form."""
    import deepinv_tpu.models.ncsnpp as jn
    import deepinv_tpu_torch.models.ncsnpp as tn

    x = image((1, 4, 8, 8), 12)
    for kw in (dict(up=True), dict(down=True), dict(up=True, fused_resample=True),
               dict(down=True, fused_resample=True)):
        ref, port = crossed(jn.UpDownConv2d(4, 6, 3, resample_filter=(1, 3, 3, 1),
                                            key=jax.random.key(13), **kw),
                            tn.UpDownConv2d(4, 6, 3, resample_filter=(1, 3, 3, 1), **kw), 14)
        assert rel(run(port, x), ref(jnp.asarray(x))) <= BOUND, kw


def test_ncsnpp_pretrained_matches_jax(tmp_path):
    """An NCSN++ written under upstream's names (``map_layer0.weight``,
    ``enc.16x16_block0.affine.weight``, ``map_noise.freqs``) and read by both
    ``pretrained=``: the [-1, 1] convention and pixel_std 0.5 in both, the
    same output as its source."""
    ref, src = crossed(jax_built(JM.NCSNpp, key=jax.random.key(15), **NCSN),
                       TM.NCSNpp(device=DEV, **NCSN), 16)
    sd = upstream_state_dict(src, ncsnpp_names(src))
    assert {"map_layer0.weight", "enc.16x16_block0.affine.weight", "map_noise.freqs",
            "dec.16x16_aux_conv.weight"} <= set(sd)
    path = str(tmp_path / "edm.pt")
    torch.save(sd, path)
    port = TM.NCSNpp(pretrained=path, device=DEV, **NCSN)
    jref = JM.NCSNpp(pretrained=path, **NCSN)
    assert port.pixel_std == jref.pixel_std == 0.5 and port._was_trained_on_minus_one_one
    src.pixel_std, src._was_trained_on_minus_one_one = 0.5, True
    x = image((1, 3, 16, 16), 17)
    want = run(src, x, 0.2)
    assert np.array_equal(run(port, x, 0.2), want)
    assert rel(jrun(jref, jnp.asarray(x), 0.2), want) <= BOUND


# -- the samplers over the backbones ----------------------------------------------


@pytest.mark.parametrize("sampler", ["DDRM", "DiffPIR", "DPS"])
def test_samplers_over_diffunet_match_jax(diffunets_gray, sampler):
    """DDRM on inpainting, DiffPIR and DPS on 2x super-resolution over the
    1-channel DiffUNet, with the JAX draws passed in; each run makes the JAX
    sampler's number of network calls."""
    jden, tden = diffunets_gray
    y, jp, tp = _inpainting() if sampler == "DDRM" else _sr()
    n, key = 4, jax.random.key(18)
    calls = []
    hook = tden.register_forward_pre_hook(lambda m, a: calls.append(1))
    if sampler == "DDRM":
        sig = np.linspace(1, 0, n + 1)
        want = jsamp.DDRM(jden, sigmas=sig)(jnp.asarray(y), jp, key=key)
        ybar = jp.U_adjoint(jnp.asarray(y))
        with torch.no_grad():
            got = tsamp.DDRM(tden, sigmas=sig)(_t(y), tp, draws=_first_then_steps(
                key, n, ybar.shape, ybar.dtype))
        expect = n + 1
    elif sampler == "DiffPIR":
        kw = dict(sigma=0.05, max_iter=n, lambda_=1e4)
        want = jsamp.DiffPIR(jden, **kw)(jnp.asarray(y), jp, key=key)
        with torch.no_grad():
            got = tsamp.DiffPIR(tden, **kw)(_t(y), tp, draws=_first_then_steps(
                key, n - 1, want.shape))
        expect = n - 1
    else:
        want = jsamp.DPS(jden, max_iter=n)(jnp.asarray(y), jp, key=key)
        with torch.no_grad():
            got = tsamp.DPS(tden, max_iter=n)(_t(y), tp, draws=_first_then_steps(
                key, n, (1, 1, SIZE, SIZE)))
        expect = n
    hook.remove()
    assert len(calls) == expect
    assert np.isfinite(got.numpy()).all()
    assert _rel(got.numpy(), want) <= BOUND


def test_posterior_diffusion_over_ncsnpp_matches_jax():
    """PosteriorDiffusion over EDMDiffusionSDE (variance exploding) with
    DPSDataFidelity and an NCSN++ at 16² on inpainting: the prior draw, then
    one draw a step; the weights get no gradient."""
    kw = dict(NCSN, in_channels=1, out_channels=1)
    jden, tden = crossed(jax_built(JM.NCSNpp, key=jax.random.key(19), **kw),
                         TM.NCSNpp(device=DEV, **kw), 20)
    rng = np.random.default_rng(21)
    x = rng.random((1, 1, 16, 16)).astype(np.float32)
    mask = (rng.random((1, 1, 16, 16)) < 0.7).astype(np.float32)
    y = x * mask
    import deepinv_tpu.physics as jphys
    import deepinv_tpu_torch.physics as tphys

    jp = jphys.Inpainting(img_size=(1, 16, 16), mask=jnp.asarray(mask))
    tp = tphys.Inpainting((1, 16, 16), mask=torch.from_numpy(mask), device=DEV)
    ts = np.linspace(1.0, 0.05, 4)

    def make(pkg, den):
        sde = pkg.EDMDiffusionSDE(sigma_t=lambda t: 0.5 * t, sigma_prime_t=lambda t: 0.5,
                                  variance_exploding=True, denoiser=den)
        return pkg.PosteriorDiffusion(sde, pkg.DPSDataFidelity(den), timesteps=ts)

    key = jax.random.key(22)
    want = make(jsamp, jden)(jnp.asarray(y), jp, key=key)
    kp, ks = jax.random.split(ensure_key(key))
    draws = [np.asarray(jax.random.normal(kp, (1, 1, 16, 16)))] + _solver_draws(
        ks, 3, (1, 1, 16, 16))
    got = make(tsamp, tden)(_t(y), tp, draws=draws)
    assert np.isfinite(got.detach().numpy()).all()
    assert _rel(got.detach().numpy(), want) <= BOUND
    assert all(p.grad is None for p in tden.parameters())
