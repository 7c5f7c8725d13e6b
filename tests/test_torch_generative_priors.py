"""The untrained and classic priors of the port against the JAX package's, on
the CPU, in f32, at small sizes: ``ConvDecoder`` and ``DeepImagePrior``
(``models/dip.py``), ``ConvLista`` and ``Poisson2Sparse``
(``models/poisson2sparse.py``), ``DEAL`` and its parts (``models/deal.py``),
``KernelIdentificationNetwork`` (``models/kernel_network.py``) and ``BM3D``
(``models/bm3d.py``). Weights cross by ``load_jax_params``; the random draws
(DIP's latent, Poisson2Sparse's neighbour choices) are the JAX model's own,
handed in.

Bounds: 1e-5 relative (max abs error over the reference's max abs) for the
forwards, the splines, the CG solve and BM3D; ``MultiConv2d``'s adjointness
within 1e-5 of ``<Wx, y>``; the fits (three Adam steps of DIP, two of
Poisson2Sparse) and the DEAL solves (their stop tests compare f32 residuals
with 1e-5-1e-8 tolerances) within 1e-4. BM3D's groups are held equal on an
input whose distances do not tie.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepinv_tpu.models as JM
import deepinv_tpu.models.layers as jlayers
import deepinv_tpu.physics as jphys
import deepinv_tpu_torch.models as TM
import deepinv_tpu_torch.physics as tphys
from deepinv_tpu.models.deal import _batched_cg as jax_cg
from deepinv_tpu_torch.core.linalg import loop_stats
from deepinv_tpu_torch.utils.profiling import counters
from deepinv_tpu_torch.models.convert import (deal_names, kernel_network_names, port_deal,
                                              upstream_state_dict)
from deepinv_tpu_torch.models.deal import _batched_cg as port_cg
from deepinv_tpu_torch.models.dip import resize_nearest
from test_torch_adversarial import _name, numpy_he_init  # noqa: F401 (an autouse fixture)
from test_torch_drunet import DEV, jax_params

BOUND = 1e-5
FIT_BOUND = 1e-4


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def image(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def cross(ref, port):
    return TM.load_jax_params(port, jax_params(ref))


def _decoder(seed=0):
    """A ConvDecoder whose three resizes (4 -> 7 -> 13 -> 20) divide unevenly,
    with its affine leaves moved off 1 and 0."""
    kw = dict(in_size=(4, 4), channels=8, layers=3)
    ref = JM.ConvDecoder((1, 20, 20), key=jax.random.key(seed), **kw)
    rng = np.random.default_rng(seed)
    ref.gammas = [jnp.asarray(1 + 0.1 * rng.standard_normal(g.shape), jnp.float32)
                  for g in ref.gammas]
    ref.betas = [jnp.asarray(0.1 * rng.standard_normal(b.shape), jnp.float32) for b in ref.betas]
    return ref, cross(ref, TM.ConvDecoder((1, 20, 20), device=DEV, **kw))


def test_conv_decoder_matches_jax():
    """The decoder's forward, and its nearest resize equal to
    ``jax.image.resize``'s at the 256² default's sizes (4 -> 51 and 154 ->
    205 land on exact half-pixel boundaries)."""
    ref, port = _decoder()
    z = np.random.default_rng(1).standard_normal((2, 8, 4, 4)).astype(np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(z))
    assert rel(got, jax.jit(lambda m, v: m(v))(ref, jnp.asarray(z))) <= BOUND
    v = np.random.default_rng(2).standard_normal((1, 1, 154, 4)).astype(np.float32)
    for size in ((205, 51), (51, 4), (7, 3)):
        want = jax.image.resize(jnp.asarray(v), (1, 1) + size, "nearest")
        assert np.array_equal(resize_nearest(torch.from_numpy(v), size).numpy(), np.asarray(want))


def test_deep_image_prior_matches_jax():
    """Three Adam steps on 30% inpainting from the JAX call's own latent;
    the decoder's weights unchanged after the call."""
    ref, port = _decoder(seed=2)
    mask = (np.random.default_rng(3).random((1, 20, 20)) > 0.3).astype(np.float32)
    y = image((1, 1, 20, 20), 4) * mask
    key = jax.random.key(5)
    want = JM.DeepImagePrior(ref, iterations=3)(jnp.asarray(y), jphys.Inpainting(
        (1, 20, 20), mask=jnp.asarray(mask)), key=key)
    z = np.asarray(jax.random.normal(key, ref.latent_shape(1)) * 0.1)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    got = TM.DeepImagePrior(port, iterations=3)(
        torch.from_numpy(y), tphys.Inpainting((1, 20, 20), mask=torch.from_numpy(mask),
                                              device=DEV), z=torch.from_numpy(z))
    assert rel(got, want) <= FIT_BOUND
    assert all(torch.equal(v, before[k]) for k, v in port.state_dict().items())


def test_poisson2sparse_with_the_draws_passed_in_matches_jax():
    """Two training steps of a small ConvLista, each step's neighbour choices
    the JAX call's (``fold_in(key, i)``), handed in by ``draws=``; and the
    ConvLista forward alone."""
    ref = JM.Poisson2Sparse(n_iter=2, n_filters=4, train_steps=2, key=jax.random.key(6))
    port = TM.Poisson2Sparse(n_iter=2, n_filters=4, train_steps=2, device=DEV)
    cross(ref.net, port.net)
    y = image((1, 1, 16, 16), 7)
    with torch.no_grad():
        assert rel(port.net(torch.from_numpy(y)), ref.net(jnp.asarray(y))) <= BOUND
    key = jax.random.key(8)
    draws = []
    for i in range(2):
        kc, ko = jax.random.split(jax.random.fold_in(key, i))
        draws += [np.asarray(jax.random.randint(kc, (1, 1, 8, 8), 0, 4)),
                  np.asarray(jax.random.randint(ko, (1, 1, 8, 8), 1, 4))]
    want = ref(jnp.asarray(y), key=key)
    got = port(torch.from_numpy(y), draws=draws)
    assert rel(got, want) <= FIT_BOUND


def _deal(seed=9, max_iter=2):
    ref = JM.DEAL(max_iter=max_iter, key=jax.random.key(seed))
    rng = np.random.default_rng(seed)
    for s in ("spline1", "spline2", "spline3", "spline_lambda", "spline_scaling"):
        sp = getattr(ref, s)
        sp.coefficients = jnp.asarray(np.asarray(sp.coefficients)
                                      + 0.02 * rng.standard_normal(sp.coefficients.shape),
                                      jnp.float32)
    return ref, cross(ref, TM.DEAL(max_iter=max_iter, device=DEV))


def test_deal_splines_and_multiconv_match_jax():
    """The five splines (slope-clamped, extrapolating) on values across and
    past their knots, ``MultiConv2d``'s convolution, transpose (adjoint to
    it) and spectral norm, and the mask."""
    ref, port = _deal()
    rng = np.random.default_rng(10)
    for s in ("spline1", "spline2", "spline3", "spline_lambda", "spline_scaling"):
        c = 128 if s == "spline_scaling" else 1
        v = (rng.standard_normal((2, c, 3, 3)) * 30).astype(np.float32)
        with torch.no_grad():
            assert rel(getattr(port, s)(torch.from_numpy(v)),
                       getattr(ref, s)(jnp.asarray(v))) <= BOUND, s
    x = image((2, 1, 16, 16), 11)
    yv = rng.standard_normal((2, 128, 16, 16)).astype(np.float32)
    with torch.no_grad():
        L = port.W1.spectral_norm()
        assert rel(L, ref.W1.spectral_norm()) <= BOUND
        wx = port.W1.convolution(torch.from_numpy(x), L)
        wty = port.W1.transpose(torch.from_numpy(yv), L)
    assert rel(wx, ref.W1.convolution(jnp.asarray(x), jnp.asarray(L.numpy()))) <= BOUND
    assert rel(wty, ref.W1.transpose(jnp.asarray(yv), jnp.asarray(L.numpy()))) <= BOUND
    lhs, rhs = float((wx * torch.from_numpy(yv)).sum()), float((torch.from_numpy(x) * wty).sum())
    assert abs(lhs - rhs) <= BOUND * abs(lhs)
    assert rel(port.mask(torch.from_numpy(x[:1]), 0.05), ref.mask(jnp.asarray(x[:1]), 0.05)) \
        <= BOUND


def test_deal_cg_matches_jax():
    """Per-sample CG on an SPD operator (a shifted Laplacian per sample),
    one sample converging long before the other; and the loop's counts."""
    scale = np.array([1.0, 50.0], np.float32).reshape(2, 1, 1, 1)

    def lap(v, xp):
        pad = xp.pad(v, ((0, 0), (0, 0), (1, 1), (1, 1)))
        return (4.5 * v - pad[..., :-2, 1:-1] - pad[..., 2:, 1:-1]
                - pad[..., 1:-1, :-2] - pad[..., 1:-1, 2:]) * scale

    b = image((2, 1, 16, 16), 12)
    want = jax_cg(lambda v: lap(v, jnp), jnp.asarray(b), jnp.zeros_like(jnp.asarray(b)), 40, 1e-8)
    tpad = lambda v: (4.5 * v - torch.nn.functional.pad(v, (0, 0, 1, -1))
                      - torch.nn.functional.pad(v, (0, 0, -1, 1))
                      - torch.nn.functional.pad(v, (1, -1, 0, 0))
                      - torch.nn.functional.pad(v, (-1, 1, 0, 0))) * torch.from_numpy(scale)
    loop_stats.reset()
    counters.reset()
    got = port_cg(tpad, torch.from_numpy(b), torch.zeros(2, 1, 16, 16), 40, 1e-8)
    assert rel(got, want) <= BOUND
    assert counters["loop.loops"] == 1 and 0 < loop_stats.iterations < 40


@pytest.mark.parametrize("mode", ["denoise", "inpainting"])
def test_deal_solve_matches_jax(mode):
    """Denoising at sigma 0.1 (``model(y, sigma)``, 60 outer and 200 CG
    iterations at most, the outer loop stopping on its tolerance), and
    reconstruction of 16² inpainting (``max_iter=1``: one outer iteration of
    20 CG iterations, which run to their count at tolerance 1e-8: over
    longer runs the JAX f32 CG drifts from a float64 solve past the
    bound, further than the port's)."""
    ref, port = _deal(seed=13, max_iter=1)
    x = image((1, 1, 16, 16), 14)
    if mode == "denoise":
        y = (x + 0.1 * np.random.default_rng(15).standard_normal(x.shape)).astype(np.float32)
        want = jax.jit(lambda m, v: m(v, 0.1))(ref, jnp.asarray(y))
        got = port(torch.from_numpy(y), 0.1)
    else:
        mask = (np.random.default_rng(16).random((1, 16, 16)) > 0.5).astype(np.float32)
        y = x * mask
        want = jax.jit(lambda m, v, p: m(v, p))(
            ref, jnp.asarray(y), jphys.Inpainting((1, 16, 16), mask=jnp.asarray(mask)))
        got = port(torch.from_numpy(y), tphys.Inpainting((1, 16, 16),
                                                         mask=torch.from_numpy(mask), device=DEV))
    assert rel(got, want) <= FIT_BOUND


def test_deal_checkpoint_names_round_trip():
    """An upstream-named DEAL state dict (the first W1/M1 kernels under their
    zero-mean parametrization, with the ``model.`` prefix) read by
    ``port_deal`` gives the same weights; ``pretrained=`` raises."""
    _, src = _deal(seed=17)
    sd = {f"model.{k}": v for k, v in upstream_state_dict(src, deal_names(src)).items()}
    assert "model.W1.conv_layers.0.parametrizations.weight.original" in sd
    dst = port_deal(TM.DEAL(device=DEV), sd)
    assert all(torch.equal(v, src.state_dict()[k]) for k, v in dst.state_dict().items())
    with pytest.raises(ValueError, match="port_deal"):
        TM.DEAL(pretrained="deal_gray.pth", device=DEV)


@pytest.mark.parametrize("size,bilinear", [(33, False), (65, True)])
def test_kernel_identification_network_matches_jax(size, bilinear, monkeypatch):
    """Four kernels of 33² (transposed-conv upsampling) or 65² (bilinear) from
    a 64² RGB image: the filters and multipliers (the JAX forward jitted);
    the output plugs into ``SpaceVaryingBlur``; the upstream names map every
    tensor. The weights go the other way here: the port's seeded draws (its
    biases redrawn off zero) into a JAX network built at zero, whose 80M
    weights would otherwise be drawn twice."""
    monkeypatch.setattr(jlayers, "he_init",
                        lambda key, shape, fan_in, dtype=jnp.float32: np.zeros(shape, np.float32))
    kw = dict(filters=4, blur_kernel_size=size, bilinear=bilinear)
    g = torch.Generator().manual_seed(18)
    port = TM.KernelIdentificationNetwork(generator=g, device=DEV, **kw)
    with torch.no_grad():
        for name, p in port.named_parameters():
            if name.endswith("bias"):
                p.normal_(0.0, 0.05, generator=g)
    sd = port.state_dict()
    ref = JM.KernelIdentificationNetwork(key=jax.random.key(18), **kw)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(ref)
    ref = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(sd[_name(path)].numpy())
                                                 for path, _ in leaves])
    y = image((1, 3, 64, 64), 19)
    with torch.no_grad():
        got = port(torch.from_numpy(y))
    want = jax.jit(lambda m, v: m(v))(ref, jnp.asarray(y))
    for k in ("filters", "multipliers"):
        assert got[k].shape == want[k].shape, k
        assert rel(got[k], want[k]) <= BOUND, k
    with torch.no_grad():
        blur = tphys.SpaceVaryingBlur(padding="reflect", device=DEV).update(**got)
        assert torch.isfinite(blur.A(torch.from_numpy(y))).all()
    names = kernel_network_names(port)
    assert sorted(names) == sorted(sd) and len(set(names.values())) == len(names)
    assert names["down3.conv2.weight"] == "down3.double_conv.2.weight"
    assert names["kernels_end.2.bias"] == "kernels_end.4.bias"
    assert names["kernel_up4.feat.weight"] == "kernel_up4.feat.0.weight"
    assert names["inc_rgb.weight"] == "inc_rgb.0.weight" and names["feat.bias"] == "feat.0.bias"
    if not bilinear:
        assert names["up2.up.weight"] == "up2.up.weight"


def _bm3d_input():
    """Two 32² planes: a smooth image with noise, whose patch distances do
    not tie."""
    yy, xx = np.mgrid[0:32, 0:32] / 32
    clean = np.stack([np.sin(3 * xx + 2 * yy), np.cos(4 * yy) * xx])[None]
    noisy = clean + 0.1 * np.random.default_rng(20).standard_normal(clean.shape)
    return noisy.astype(np.float32)


def test_bm3d_groups_and_output_match_jax():
    """Both stages at a search radius of 3: the hard-thresholding stage's
    groups (the K nearest offsets of each reference, the zero offset first),
    equal, and the denoised planes within 1e-5; a window too small for a
    group raises."""
    kw = dict(search_radius=3, ht_group_size=8, wiener_group_size=16)
    ref, port = JM.BM3D(**kw), TM.BM3D(**kw)
    y = _bm3d_input()
    refs = port._refs(32, 32)
    match = jax.jit(ref._match, static_argnums=2)
    for plane in range(2):
        want = np.asarray(match(jnp.asarray(y[0, plane]), jnp.asarray(refs), 8))
        got = port._match(torch.from_numpy(y[0, plane:plane + 1]), torch.from_numpy(refs), 8)[0]
        assert np.array_equal(got.numpy(), want)
        lin = refs[:, 0] * 25 + refs[:, 1]
        assert np.array_equal(got[:, 0].numpy(), lin)  # each reference leads its group
    assert rel(port(torch.from_numpy(y), 0.1), jax.jit(lambda v: ref(v, 0.1))(jnp.asarray(y))) \
        <= BOUND
    # a corner reference at radius 1 has 4 candidates: a group of 8 cannot be
    # filled (the JAX gather would take out-of-image candidates in silently)
    with pytest.raises(ValueError, match="candidates"):
        TM.BM3D(search_radius=1, ht_group_size=8)(torch.from_numpy(y), 0.1)
