"""Restormer, PromptIR, SwinIR, SCUNet and RAM of the port against the JAX
package's, on the CPU, at small widths, with every JAX leaf redrawn at
random (``randomized``) and carried by ``load_jax_params``, or through
upstream-named checkpoints the test writes and both packages read.

Bound: f32 relative max error (max abs error over the reference's max abs)
within 1e-4 for every model; the ``pretrained=`` round trips are exact.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepinv_tpu.models as JM
import deepinv_tpu.physics as jphys
import deepinv_tpu_torch.models as TM
import deepinv_tpu_torch.physics as tphys
from deepinv_tpu.ops import gaussian_blur as jax_gaussian_blur
from deepinv_tpu_torch.models.convert import (ram_names, restormer_names, scunet_names,
                                              swinir_names, upstream_state_dict)
from deepinv_tpu_torch.ops import gaussian_blur
from test_torch_drunet import DEV, jax_params, numpy_draws

BOUND = 1e-4
# leaves the JAX modules derive from their configuration or draw on purpose
CONSTANT = ("resample_filter", "sqrt_alphas_cumprod", "sqrt_1m_alphas_cumprod", "mean", "freqs")
POSITIVE = ("temperature", "gain", "fact_realign")


@pytest.fixture(autouse=True)
def _numpy_draws():
    """The JAX modules built by numpy's draws (``numpy_draws``): every test
    here redraws their leaves (``randomized``) or reads a checkpoint."""
    with numpy_draws():
        yield


def jrun(ref, *args, **kwargs):
    """The JAX module's forward through ``jax.jit``: one compile, where the
    eager forward compiles every op for every new shape."""
    return jax.jit(lambda m, *a: m(*a, **kwargs))(ref, *args)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _name(path) -> str:
    return ".".join(str(getattr(k, "name", getattr(k, "idx", getattr(k, "key", k))))
                    for k in path)


def randomized(ref, seed: int):
    """The JAX module ``ref`` with every float leaf redrawn: weights normal
    over ``sqrt(fan_in)``, norm scales, temperatures and gains near 1, biases
    near 0; the constants of ``CONSTANT`` kept. Nothing is left at a zero or
    neutral start (zeroed output convs, unit temperatures)."""
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(ref)
    new = []
    for path, v in leaves:
        leaf = _name(path).rsplit(".", 1)[-1]
        a = np.asarray(v)
        if not np.issubdtype(a.dtype, np.floating) or leaf in CONSTANT:
            new.append(v)
            continue
        if leaf in POSITIVE or (a.ndim == 1 and leaf.endswith("weight")):
            r = 1.0 + 0.1 * rng.standard_normal(a.shape)
        elif a.ndim <= 1:
            r = 0.05 * rng.standard_normal(a.shape)
        else:
            r = rng.standard_normal(a.shape) / math.sqrt(max(int(np.prod(a.shape[1:])), 1))
        new.append(jnp.asarray(r, jnp.float32))
    return jax.tree_util.tree_unflatten(treedef, new)


def crossed(ref, port, seed: int):
    """``ref`` randomized and ``port`` given its leaves."""
    ref = randomized(ref, seed)
    return ref, TM.load_jax_params(port, jax_params(ref))


def run(port, x, *args, **kwargs):
    with torch.no_grad():
        return port(torch.from_numpy(x), *args, **kwargs).numpy()


def image(shape, seed: int):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


# -- Restormer and PromptIR ----------------------------------------------------

RESTORMER = dict(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1)


@pytest.mark.parametrize("ln,dual,shape", [("BiasFree", False, (2, 3, 12, 20)),
                                           ("WithBias", False, (1, 3, 16, 24)),
                                           ("WithBias", True, (1, 3, 17, 9))])
def test_restormer_matches_jax(ln, dual, shape):
    """Restormer in both layer norms and the dual-pixel head, on a padded
    (``test_pad`` to 8) and an unpadded input."""
    kw = dict(RESTORMER, LayerNorm_type=ln, dual_pixel_task=dual, bias=ln == "WithBias")
    ref, port = crossed(JM.Restormer(key=jax.random.key(0), **kw), TM.Restormer(device=DEV, **kw),
                        1)
    x = image(shape, 2)
    got = run(port, x)
    assert got.shape == shape
    assert rel(got, jrun(ref, jnp.asarray(x))) <= BOUND


def test_restormer_validators_and_raw_forward_match_jax():
    """``forward_restormer`` refuses sides off the grid and the standard-network
    validators raise the JAX package's messages."""
    port, ref = TM.Restormer(device=DEV, **RESTORMER), JM.Restormer(**RESTORMER)
    with pytest.raises(ValueError, match="divisible by 8"):
        port.forward_restormer(torch.zeros(1, 3, 12, 16))
    std = dict(dim=48, num_blocks=(4, 6, 6, 8), num_refinement_blocks=4, heads=(1, 2, 4, 8),
               ffn_expansion_factor=2.66, bias=False, dual_pixel_task=False)
    cases = [("is_standard_denoising_network", dict(in_channels=2, out_channels=2,
                                                     LayerNorm_type="BiasFree")),
             ("is_standard_denoising_network", dict(in_channels=3, out_channels=3,
                                                     LayerNorm_type="WithBias")),
             ("is_standard_deraining_network", dict(in_channels=3, out_channels=1,
                                                     LayerNorm_type="WithBias")),
             ("is_standard_deblurring_network", dict(in_channels=6, out_channels=3,
                                                      LayerNorm_type="BiasFree"))]
    for method, kw in cases:
        with pytest.raises(ValueError) as want:
            getattr(ref, method)(**std, **kw)
        with pytest.raises(ValueError, match=str(want.value).replace("(", r"\(").replace(
                ")", r"\)").replace("[", r"\[").replace("]", r"\]")):
            getattr(port, method)(**std, **kw)
    port.is_standard_deblurring_network(**dict(std, dual_pixel_task=True), in_channels=6,
                                        out_channels=3, LayerNorm_type="WithBias")


@pytest.mark.parametrize("shape", [(2, 3, 12, 20), (1, 3, 18, 22)])
def test_promptir_matches_jax(shape):
    """PromptIR at dim 8: the prompts resized down (6 from 8) and up, on an
    input on its grid and one padded to 4."""
    ref, port = crossed(JM.PromptIR(dim=8, key=jax.random.key(3)), TM.PromptIR(dim=8, device=DEV),
                        4)
    x = image(shape, 5)
    assert rel(run(port, x), jrun(ref, jnp.asarray(x))) <= BOUND


def test_promptir_loader_round_trip_and_refusals(tmp_path):
    """``load_pretrained`` reads the port's own ``torch.save`` state dict (JAX's
    pickled module crossed through ``load_jax_params``) and refuses the
    authors' checkpoint suffixes and ``"download"``, as the JAX loader does."""
    ref, src = crossed(JM.PromptIR(dim=8, key=jax.random.key(6)), TM.PromptIR(dim=8, device=DEV), 7)
    path = str(tmp_path / "promptir.sd")
    torch.save(src.state_dict(), path)
    port = TM.PromptIR(dim=8, device=DEV).load_pretrained(path)
    x = image((1, 3, 16, 16), 8)
    assert np.array_equal(run(port, x), run(src, x))
    for bad in ("w.ckpt", "w.pth", "w.pt"):
        with pytest.raises(NotImplementedError):
            ref.load_pretrained(bad)
        with pytest.raises(NotImplementedError):
            port.load_pretrained(bad)
    with pytest.raises(ValueError):
        port.load_pretrained("download")


# -- SwinIR ------------------------------------------------------------------

SWIN = dict(embed_dim=12, depths=(2, 2), num_heads=(2, 3), window_size=4)


@pytest.mark.parametrize("img_size,upsampler,upscale,shape", [
    (16, "", 1, (2, 3, 14, 18)),                # off the window grid: reflect pad, shifts
    (4, "", 1, (1, 3, 12, 8)),                  # a window no smaller than the resolution: no shift
    (16, "pixelshuffle", 2, (1, 3, 8, 12)),
    (16, "pixelshuffledirect", 3, (1, 3, 8, 8)),
    (16, "nearest+conv", 4, (1, 1, 8, 8)),
])
def test_swinir_matches_jax(img_size, upsampler, upscale, shape):
    """SwinIR's denoising and super-resolution heads; a size off the window
    grid, and a construction resolution that shrinks the window and drops
    the shift."""
    kw = dict(SWIN, img_size=img_size, upsampler=upsampler, upscale=upscale, in_chans=shape[1])
    ref, port = crossed(JM.SwinIR(key=jax.random.key(9), **kw), TM.SwinIR(device=DEV, **kw), 10)
    assert [b.ws for g in port.layers for b in g.blocks] == \
        [b.ws for g in ref.layers for b in g.blocks]
    assert [b.shift for g in port.layers for b in g.blocks] == \
        [b.shift for g in ref.layers for b in g.blocks]
    x = image(shape, 11)
    got = run(port, x)
    assert got.shape == shape[:2] + (shape[2] * upscale, shape[3] * upscale)
    assert rel(got, jrun(ref, jnp.asarray(x))) <= BOUND
    assert port.flops() == ref.flops()


def test_swinir_tables_and_padding_match_jax():
    """The relative-position index, the shifted-window mask and the reflect
    pad against the JAX module's."""
    import deepinv_tpu.models.swinir as js
    import deepinv_tpu_torch.models.swinir as ts

    for ws in (4, 8):
        assert np.array_equal(ts._rel_pos_index(ws), js._rel_pos_index(ws))
    for H, W, ws, shift in ((16, 24, 4, 2), (8, 8, 8, 4), (16, 16, 8, 0)):
        want = js._attn_mask(H, W, ws, shift)
        got = ts._attn_mask(H, W, ws, shift)
        assert (want is None and got is None) or np.array_equal(got, np.asarray(want))
    port = TM.SwinIR(device=DEV, **SWIN)
    x = image((1, 3, 5, 3), 12)
    assert np.array_equal(port.check_img_size(torch.from_numpy(x)).numpy(),
                          np.asarray(JM.SwinIR(**SWIN).check_img_size(jnp.asarray(x))))


def test_swinir_pretrained_matches_jax(tmp_path):
    """A SwinIR written under upstream's names (``layers.0.residual_group
    .blocks.1.mlp.fc2.weight``, ``upsample.2.weight``) and read by both
    ``pretrained=``: the same output as its source in both packages."""
    kw = dict(SWIN, img_size=16, upsampler="pixelshuffle", upscale=4)
    ref, src = crossed(JM.SwinIR(key=jax.random.key(13), **kw), TM.SwinIR(device=DEV, **kw), 14)
    sd = upstream_state_dict(src, swinir_names(src))
    assert "layers.1.residual_group.blocks.1.mlp.fc2.weight" in sd and "upsample.2.weight" in sd
    path = str(tmp_path / "swinir.pth")
    torch.save({"params": sd}, path)
    port = TM.SwinIR(pretrained=path, device=DEV, **kw)
    jref = JM.SwinIR(pretrained=path, **kw)
    x = image((1, 3, 8, 8), 15)
    want = run(src, x)
    assert np.array_equal(run(port, x), want)
    assert rel(jrun(jref, jnp.asarray(x)), want) <= BOUND


# -- SCUNet ------------------------------------------------------------------

SCUNET = dict(config=(2, 1, 1, 2, 1, 1, 2), dim=16, head_dim=8, input_resolution=64)


@pytest.mark.parametrize("shape", [(1, 3, 40, 24), (1, 1, 64, 64)])
def test_scunet_matches_jax(shape):
    """SCUNet at dim 16 (W and SW blocks; the 8² stage loses its shift), on
    an input replicate-padded to 64 and one on the grid."""
    kw = dict(SCUNET, in_nc=shape[1])
    ref, port = crossed(JM.SCUNet(key=jax.random.key(16), **kw), TM.SCUNet(device=DEV, **kw), 17)
    assert [b.trans_block.msa.type for b in port.m_body] == ["W", "W"]
    assert [b.trans_block.msa.type for b in port.m_down1[:-1]] == ["W", "SW"]
    x = image(shape, 18)
    assert rel(run(port, x), jrun(ref, jnp.asarray(x))) <= BOUND


def test_scunet_and_restormer_pretrained_match_jax(tmp_path):
    """SCUNet and Restormer written under upstream's names
    (``m_down1.0.conv_block.2.weight``, ``encoder_level1.0.attn.qkv_dwconv
    .weight``) and read by both ``pretrained=``."""
    x = image((1, 3, 16, 16), 19)
    for i, (jcls, tcls, kw, names, key) in enumerate((
            (JM.SCUNet, TM.SCUNet, SCUNET, scunet_names, "m_down1.0.conv_block.2.weight"),
            (JM.Restormer, TM.Restormer, dict(RESTORMER, LayerNorm_type="WithBias", bias=True),
             restormer_names, "encoder_level1.0.attn.qkv_dwconv.weight"))):
        ref, src = crossed(jcls(key=jax.random.key(20 + i), **kw), tcls(device=DEV, **kw), 22 + i)
        sd = upstream_state_dict(src, names(src))
        assert key in sd and len(sd) == len(src.state_dict())
        path = str(tmp_path / f"{i}.pth")
        torch.save(sd, path)
        want = run(src, x)
        assert np.array_equal(run(tcls(pretrained=path, device=DEV, **kw), x), want)
        assert rel(jrun(jcls(pretrained=path, **kw), jnp.asarray(x)), want) <= BOUND


# -- RAM ---------------------------------------------------------------------

RAM_NC = dict(nc=(16, 32, 64, 64), nb=2)
SIZE = 32


@pytest.fixture(scope="module")
def rams():
    ref = JM.RAM(key=jax.random.key(24), **RAM_NC)
    return crossed(ref, TM.RAM(device=DEV, **RAM_NC), 25)


def _problem(name, channels=3, batch=1):
    shape = (channels, SIZE, SIZE)
    if name == "Denoising":
        return (jphys.Denoising(noise_model=jphys.GaussianNoise(0.1)),
                tphys.Denoising(noise_model=tphys.GaussianNoise(0.1, device=DEV)))
    if name == "Inpainting":
        mask = (np.random.default_rng(26).random((1,) + shape) < 0.5).astype(np.float32)
        return (jphys.Inpainting(img_size=shape, mask=jnp.asarray(mask),
                                 noise_model=jphys.GaussianNoise(0.05)),
                tphys.Inpainting(shape, mask=torch.from_numpy(mask), device=DEV,
                                 noise_model=tphys.GaussianNoise(0.05, device=DEV)))
    return (jphys.BlurFFT(img_size=shape, filter=jax_gaussian_blur(sigma=1.5),
                          noise_model=jphys.GaussianNoise(0.05)),
            tphys.BlurFFT(shape, filter=gaussian_blur(sigma=1.5), device=DEV,
                          noise_model=tphys.GaussianNoise(0.05, device=DEV)))


@pytest.mark.parametrize("problem,channels,batch", [("Denoising", 3, 2), ("Inpainting", 3, 1),
                                                    ("BlurFFT", 1, 1)])
def test_ram_reconstructs_as_jax(rams, problem, channels, batch):
    """RAM (the demo's widths) as ``model(y, physics)`` on the demo's three
    tasks: the noise level from the physics, the realignment by its
    ``prox_l2`` at a per-sample gamma, the padding to 64 through the
    cropper's Krylov prox and the multiscale Krylov embeddings."""
    ref, port = rams
    jp, tp = _problem(problem, channels, batch)
    x = image((batch, channels, SIZE, SIZE), 27)
    y = np.asarray(jp.A(jnp.asarray(x)))
    y = y + 0.05 * np.random.default_rng(28).standard_normal(y.shape).astype(np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(y), tp).numpy()
    assert got.shape == x.shape and np.isfinite(got).all()
    assert rel(got, jrun(ref, jnp.asarray(y), jp)) <= BOUND


def test_ram_as_denoiser_and_sigma_map_quirk_match_jax(rams):
    """RAM as ``model(y, sigma=...)``: per-sample sigma and gain at 40x32
    (padded to 64), a per-pixel sigma map at 64² (no pad), and a per-pixel map
    at an H off the 16 grid, which both packages pad on the swapped axes and
    then refuse (ram.py:450-465)."""
    ref, port = rams
    y = image((2, 3, 40, 32), 29)
    sigma, gain = np.array([0.05, 0.2], np.float32), np.array([0.01, 0.02], np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(y), sigma=torch.from_numpy(sigma),
                   gain=torch.from_numpy(gain)).numpy()
    assert rel(got, jrun(ref, jnp.asarray(y), sigma=jnp.asarray(sigma),
                         gain=jnp.asarray(gain))) <= BOUND
    y = image((1, 1, 64, 64), 30)
    smap = (0.02 + 0.1 * image((1, 1, 64, 64), 31)).astype(np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(y), sigma=torch.from_numpy(smap)).numpy()
    assert rel(got, jrun(ref, jnp.asarray(y), sigma=jnp.asarray(smap))) <= BOUND
    y, smap = image((1, 1, 56, 64), 32), np.full((1, 1, 56, 64), 0.05, np.float32)
    with pytest.raises(ValueError, match="cannot broadcast sigma"):
        ref(jnp.asarray(y), sigma=jnp.asarray(smap))
    with pytest.raises(ValueError, match="cannot broadcast sigma"):
        port(torch.from_numpy(y), sigma=torch.from_numpy(smap))


def test_ram_pretrained_matches_jax(rams, tmp_path):
    """The RAM written under upstream's names (``m_head.conv2.weight``,
    ``m_up1.enc.1.PhysicsBlock.encoding_conv.head0.conv10.weight``) and read by
    both ``pretrained=``: the same output as its source in both packages."""
    ref, src = rams
    sd = upstream_state_dict(src, ram_names(src))
    assert "m_head.conv2.weight" in sd and "fact_realign" in sd
    assert "m_up1.enc.1.PhysicsBlock.encoding_conv.head0.conv10.weight" in sd
    path = str(tmp_path / "ram.pth.tar")
    torch.save(sd, path)
    port = TM.RAM(pretrained=path, device=DEV, **RAM_NC)
    jref = JM.RAM(pretrained=path, **RAM_NC)
    y = image((1, 3, SIZE, SIZE), 33)
    with torch.no_grad():
        want = src(torch.from_numpy(y), sigma=0.1).numpy()
        assert np.array_equal(port(torch.from_numpy(y), sigma=0.1).numpy(), want)
    assert rel(jrun(jref, jnp.asarray(y), sigma=0.1), want) <= BOUND


def test_krylov_embeddings_match_jax():
    """``cat[x, Kx, K^2 x]`` with and without the shift ``v`` over a 2x
    multiscale blur."""
    import deepinv_tpu.models.ram as jram
    import deepinv_tpu_torch.models.ram as tram

    jp, tp = _problem("BlurFFT", 1)
    jm = jphys.LinearPhysicsMultiScaler(jp, (1, SIZE, SIZE))
    tm = tphys.LinearPhysicsMultiScaler(tp, (1, SIZE, SIZE), device=DEV)
    x = image((1, 1, SIZE // 2, SIZE // 2), 34)
    v = image((1, 1, SIZE // 2, SIZE // 2), 35)
    for kw in ({}, {"v": v}):
        want = jram.krylov_embeddings(jnp.asarray(x), jm, 2, scale=1, N=3,
                                      **{k: jnp.asarray(a) for k, a in kw.items()})
        got = tram.krylov_embeddings(torch.from_numpy(x), tm, 2, scale=1, N=3,
                                     **{k: torch.from_numpy(a) for k, a in kw.items()})
        assert rel(got.numpy(), want) <= BOUND


def test_decomposable_prox_keeps_a_tensor_gammas_device():
    """``Denoising.prox_l2`` (a number as its mask) with a per-sample gamma,
    as RAM's realignment calls it: the gamma stays on its device. It was
    moved to the mask's, the CPU, and the prox raised on the card; the meta
    device shows the same here."""
    from deepinv_tpu_torch.physics.base import _add_inv_gamma

    gamma = torch.full((2, 1, 1, 1), 4.0, device="meta")
    assert _add_inv_gamma(1.0, gamma).device.type == "meta"
    got = _add_inv_gamma(1.0, torch.full((2, 1, 1, 1), 4.0))
    assert torch.equal(got, torch.full((2, 1, 1, 1), 1.25))
    x, y = torch.rand(2, 3, 8, 8), torch.rand(2, 3, 8, 8)
    g = torch.tensor([0.5, 2.0]).reshape(2, 1, 1, 1)
    want = (x + g * y) / (1 + g)
    assert torch.allclose(tphys.Denoising().prox_l2(x, y, gamma=g), want, atol=1e-6)


def test_blurfft_takes_half_precision_inputs():
    """``BlurFFT``'s transforms take a bf16 input in float32 (cuFFT and the
    JAX package's FFT refuse bf16; a network under ``torch.autocast``, as RAM
    in ``chip_smoke.py`` phase 18, hands the physics bf16 tensors): the same
    numbers as the float32 input, in float32."""
    jp, tp = _problem("BlurFFT", 1)
    x = torch.from_numpy(image((2, 1, SIZE, SIZE), 36))
    xb = x.to(torch.bfloat16)
    for fn in (tp.A, tp.A_adjoint, lambda v: tp.prox_l2(v, v, 0.5), tp.V_adjoint):
        got, want = fn(xb), fn(xb.float())
        assert got.dtype == want.dtype and torch.equal(got, want)
    with pytest.raises(ValueError):
        jp.A(jnp.asarray(x.numpy(), jnp.bfloat16))

