"""The port's network layers, the 2D -> 3D weight inflation and the models
exports against the JAX package's, on the CPU; and the kernel ops' second
derivative, which raises (the gradient-step denoisers then take the layers).

Weights cross by ``load_jax_params``; f32 bounds are 1e-5 (max abs error over
the reference's max), pooling and reshuffles are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepinv_tpu.models as JM
import deepinv_tpu_torch.models as TM
import deepinv_tpu_torch.ops.kernels.conv_chain as ck
from deepinv_tpu_torch.ops.kernels.resblock_chain import resblock_chain
from deepinv_tpu_torch.ops.kernels.tv import chambolle_prox
from deepinv_tpu_torch.ops.kernels.up_resblock_chain import up_resblock_chain
from deepinv_tpu_torch.ops.kernels.up_sandwich import up_sandwich
from test_torch_drunet import DEV, jax_params


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _crossed(jmod, tmod):
    arrays = jax_params(jmod)
    if arrays:
        TM.load_jax_params(tmod, arrays)
    return tmod


def _bn(n, seed):
    """A JAX BatchNorm2d with random statistics and affine terms."""
    rng = np.random.default_rng(seed)
    bn = JM.BatchNorm2d(n)
    bn.weight = jnp.asarray(rng.random(n) + 0.5, jnp.float32)
    bn.bias = jnp.asarray(rng.standard_normal(n), jnp.float32)
    bn.running_mean = jnp.asarray(rng.standard_normal(n), jnp.float32)
    bn.running_var = jnp.asarray(rng.random(n) + 0.5, jnp.float32)
    return bn


K = jax.random.key(3)
LAYERS = {
    "conv2d_groups": (lambda: JM.Conv2d(4, 6, 3, 1, 1, groups=2, key=K),
                      lambda: TM.Conv2d(4, 6, 3, 1, 1, groups=2), (2, 4, 9, 7)),
    "conv2d_stride": (lambda: JM.Conv2d(3, 5, 2, 2, 0, bias=False, key=K),
                      lambda: TM.Conv2d(3, 5, 2, 2, 0, bias=False), (2, 3, 8, 6)),
    "conv_transpose2d": (lambda: JM.ConvTranspose2d(4, 3, 2, 2, key=K),
                         lambda: TM.ConvTranspose2d(4, 3, 2, 2), (2, 4, 5, 6)),
    "conv3d": (lambda: JM.Conv3d(2, 3, 3, 1, 1, key=K), lambda: TM.Conv3d(2, 3, 3, 1, 1),
               (1, 2, 6, 5, 7)),
    "conv_transpose3d": (lambda: JM.ConvTranspose3d(3, 2, 2, 2, key=K),
                         lambda: TM.ConvTranspose3d(3, 2, 2, 2), (1, 3, 3, 4, 5)),
    "linear": (lambda: JM.Linear(7, 4, key=K), lambda: TM.Linear(7, 4), (3, 7)),
    "relu": (JM.ReLU, TM.ReLU, (2, 3, 4, 4)),
    "leaky_relu": (lambda: JM.LeakyReLU(0.2), lambda: TM.LeakyReLU(0.2), (2, 3, 4, 4)),
    "gelu": (JM.GELU, TM.GELU, (2, 3, 4, 4)),
    "identity": (JM.Identity, TM.Identity, (2, 3, 4, 4)),
    "avg_pool2d": (lambda: JM.AvgPool2d(2), lambda: TM.AvgPool2d(2), (2, 3, 8, 6)),
    "max_pool2d": (lambda: JM.MaxPool2d(3, 2), lambda: TM.MaxPool2d(3, 2), (2, 3, 9, 7)),
    "max_pool3d": (lambda: JM.MaxPool3d(2), lambda: TM.MaxPool3d(2), (1, 2, 4, 6, 4)),
    "upsample_nearest": (lambda: JM.UpsampleNearest(3), lambda: TM.UpsampleNearest(3),
                         (2, 2, 3, 4)),
    "pixel_shuffle": (lambda: JM.PixelShuffle(2), lambda: TM.PixelShuffle(2), (2, 8, 3, 4)),
    "batch_norm_4d": (lambda: _bn(3, 1), lambda: TM.BatchNorm2d(3), (2, 3, 4, 5)),
    "batch_norm_5d": (lambda: _bn(3, 2), lambda: TM.BatchNorm2d(3), (2, 3, 2, 4, 5)),
    "sequential": (lambda: JM.Sequential(JM.Conv2d(2, 4, 3, 1, 1, key=K), JM.GELU(),
                                         JM.Conv2d(4, 2, 1, 1, 0, key=jax.random.key(4))),
                   lambda: TM.Sequential(TM.Conv2d(2, 4, 3, 1, 1), TM.GELU(),
                                         TM.Conv2d(4, 2, 1, 1, 0)), (1, 2, 6, 6)),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_jax(name):
    """Each layer, 2D and 3D, against the JAX layer with its weights: f32
    within 1e-5; the port's tensors are the JAX leaves, by name."""
    make_j, make_t, shape = LAYERS[name]
    jmod = make_j()
    tmod = _crossed(jmod, make_t())
    assert {n for n, _ in tmod.named_parameters()} == set(jax_params(jmod))
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = np.asarray(jmod(jnp.asarray(x)))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-5


def test_initializations_and_dims():
    """He-normal convs, uniform linear layers and zero biases from the
    caller's generator; ``fix_dim`` and the class factories."""
    g = torch.Generator().manual_seed(0)
    c = TM.Conv3d(16, 32, 3, generator=g)
    assert abs(float(c.weight.std()) / (2 / (16 * 27)) ** 0.5 - 1) < 0.05
    assert float(c.bias.abs().max()) == 0.0
    lin = TM.Linear(100, 400, generator=g)
    assert float(lin.weight.abs().max()) <= 0.1 and float(lin.weight.abs().max()) > 0.099
    assert [TM.fix_dim(d) for d in (2, "3", "2d", "3D")] == [2, 3, 2, 3]
    with pytest.raises(ValueError):
        TM.fix_dim(4)
    assert TM.conv_nd(3) is TM.Conv3d and TM.conv_transpose_nd("2d") is TM.ConvTranspose2d


@pytest.mark.parametrize("isotropic", [False, True])
def test_initialize_3d_from_2d_matches_jax(isotropic):
    """A 3D DnCNN and DRUNet inflated from a 2D model's weights (names the
    JAX tree paths, which are the port's), against JAX's inflation: the
    weights exactly, the outputs within 1e-5."""
    j2 = JM.DnCNN(1, 1, depth=3, nf=4, key=jax.random.key(1))
    ck2 = jax_params(j2)
    j3 = JM.initialize_3d_from_2d(JM.DnCNN(1, 1, depth=3, nf=4, dim=3), ck2, isotropic)
    t3 = TM.initialize_3d_from_2d(TM.DnCNN(1, 1, depth=3, nf=4, dim=3, device=DEV), ck2,
                                  isotropic)
    for k, v in jax_params(j3).items():
        assert np.array_equal(t3.state_dict()[k].numpy(), v), k
    jd = JM.DRUNet(1, 1, nc=(4, 4, 4, 4), nb=1, key=jax.random.key(2))
    ckd = jax_params(jd)
    jd3 = JM.initialize_3d_from_2d(JM.DRUNet(1, 1, nc=(4, 4, 4, 4), nb=1, dim=3), ckd,
                                   isotropic)
    td3 = TM.initialize_3d_from_2d(TM.DRUNet(1, 1, nc=(4, 4, 4, 4), nb=1, dim=3, device=DEV),
                                   ckd, isotropic)
    for k, v in jax_params(jd3).items():
        assert np.allclose(td3.state_dict()[k].numpy(), v, atol=1e-7), k
    x = np.random.default_rng(2).random((1, 1, 8, 8, 8)).astype(np.float32)
    with torch.no_grad():
        got = td3(torch.from_numpy(x), 0.05).numpy()
    assert _rel(got, jd3(jnp.asarray(x), 0.05)) <= 1e-5


def test_axial_inflation_acts_slice_by_slice():
    """Axial inflation places the kernel at depth k // 2, JAX's centre: on a
    depth-constant volume the interior slices equal the 2D model's output."""
    t2 = TM.DnCNN(1, 1, depth=4, nf=8, device=DEV, generator=torch.Generator().manual_seed(1))
    t3 = TM.initialize_3d_from_2d(TM.DnCNN(1, 1, depth=4, nf=8, dim=3, device=DEV),
                                  t2.state_dict())
    x2 = torch.rand((2, 1, 12, 10), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        want = t2(x2)
        got = t3(x2[:, :, None].expand(2, 1, 12, 12, 10).contiguous())
    # the 4 layers' receptive field reaches 4 slices from each face
    assert float((got[:, :, 4:-4] - want[:, :, None]).abs().max()) <= 1e-5


def test_models_exports_every_jax_name_of_this_slice():
    """``deepinv_tpu_torch.models`` exports each JAX ``models`` name of the
    layers, 3D, UNet, unrolled, CNN, wrapper and misc modules."""
    import deepinv_tpu.models.cnns as c
    import deepinv_tpu.models.layers as la
    import deepinv_tpu.models.misc_models as mi
    import deepinv_tpu.models.unet as un
    import deepinv_tpu.models.unrolled as ur
    import deepinv_tpu.models.wrappers_models as wr

    names = set(la.__all__) | set(c.__all__) | set(mi.__all__) | set(un.__all__) \
        | set(ur.__all__) | set(wr.__all__) | {"Conv3d", "ConvTranspose3d", "MaxPool3d",
                                              "fix_dim", "conv_nd", "initialize_3d_from_2d",
                                              "test_pad", "test_onesplit", "DnCNN", "DRUNet",
                                              "GSPnP", "EquivariantReconstructor",
                                              "DiffusersDenoiserWrapper",
                                              "ComplexDenoiserWrapper"}
    assert all(hasattr(JM, n) for n in names - {"he_init"})
    assert sorted(n for n in names if not hasattr(TM, n) and n != "he_init") == []


def test_models_exports_the_diffusion_backbones_and_attention_models():
    """``deepinv_tpu_torch.models`` exports the ten names of the diffusion
    backbones and the attention models, and lacks no public name of the JAX
    ``models`` (since the thirteen of ``gan``, ``dip``, ``bm3d``,
    ``poisson2sparse``, ``deal``, ``kernel_network`` and ``vgg`` came)."""
    import types

    new = {"DiffUNet", "EDMPrecond", "GroupNorm", "ADMUNet", "NCSNpp", "Restormer", "PromptIR",
           "SwinIR", "SCUNet", "RAM"}
    assert new <= set(TM.__all__) and all(hasattr(JM, n) for n in new)
    public = [n for n in dir(JM) if not n.startswith("_")
              and not isinstance(getattr(JM, n), types.ModuleType)]
    assert sorted(n for n in public if not hasattr(TM, n)) == []
    assert {"BM3D", "CSGMGenerator", "ConvDecoder", "ConvLista", "DCGANDiscriminator",
            "DCGANGenerator", "DEAL", "DeepImagePrior", "ESRGANDiscriminator",
            "KernelIdentificationNetwork", "PatchGANDiscriminator", "Poisson2Sparse",
            "VGG16Features"} <= set(TM.__all__)


# -- the repair: no kernel op gives a second derivative without raising ----------

def _bf16(*shape, seed=0, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale).to(torch.bfloat16)


def _ops():
    w = lambda *s: (torch.randn(s, generator=torch.Generator().manual_seed(len(s))) * 0.05)
    return {
        "conv_chain": lambda h: ck.conv_chain(h, w(2, 64, 64, 3, 3).requires_grad_(),
                                              torch.zeros(2, 64).requires_grad_()),
        "resblock_chain": lambda h: resblock_chain(h, w(1, 64, 64, 3, 3).requires_grad_(),
                                                   w(1, 64, 64, 3, 3)),
        "up_resblock_chain": lambda h: up_resblock_chain(
            h[:, :, ::2, ::2].repeat(1, 2, 1, 1).contiguous(), w(128, 64, 2, 2),
            w(1, 64, 64, 3, 3).requires_grad_(), w(1, 64, 64, 3, 3)),
        "up_sandwich": lambda h: up_sandwich(
            h[:, :, ::4, ::4].repeat(1, 4, 1, 1).contiguous(), h, w(256, 128, 2, 2),
            w(1, 128, 128, 3, 3), w(1, 128, 128, 3, 3), w(128, 64, 2, 2),
            w(128, 64, 2, 2).requires_grad_(), w(1, 64, 64, 3, 3), w(1, 64, 64, 3, 3)),
        "chambolle_prox": lambda h: chambolle_prox(h.float(), 0.1, 5),
    }


@pytest.mark.parametrize("name", ["conv_chain", "resblock_chain", "up_resblock_chain",
                                  "up_sandwich", "chambolle_prox"])
def test_kernel_op_second_derivative_raises(name):
    """The first derivative of each kernel op runs, also with
    ``create_graph``; a second one through it raises, whether it is asked for
    the input or by ``backward()``, instead of losing the terms the backward
    does not record."""
    h = _bf16(1, 64, 8, 8, seed=1).requires_grad_()
    out = _ops()[name](h)
    (g1,) = torch.autograd.grad((out.float() ** 2).sum(), h, retain_graph=True)
    (g,) = torch.autograd.grad((out.float() ** 2).sum(), h, create_graph=True)
    assert torch.equal(g.detach(), g1) and torch.isfinite(g1.float()).all()
    with pytest.raises(RuntimeError, match="no second derivative"):
        torch.autograd.grad(g.float().sum(), h, retain_graph=True)
    with pytest.raises(RuntimeError, match="no second derivative"):
        g.float().sum().backward()


def _gs_loss(den, x):
    """``||x - grad_x 1/2 ||x - D(x)||^2||^2``, the gradient-step denoiser's
    output, with the graph of its gradient kept."""
    with torch.enable_grad():
        u = x.clone().requires_grad_()
        (g,) = torch.autograd.grad(0.5 * ((u - den(u, 0.05)) ** 2).sum(), u, create_graph=True)
    return ((x - g) ** 2).sum()


def test_second_derivative_through_bf16_chain_raises():
    """The gradient-step denoiser's training gradient through a bf16 DnCNN's
    fused chain: raises now (it lost 0.67 of the f32 gradient, relative L2,
    against 0.093 for the bf16 layers)."""
    net = TM.DnCNN(1, 1, depth=4, device=DEV, generator=torch.Generator().manual_seed(0))
    x = torch.rand((1, 1, 12, 12), generator=torch.Generator().manual_seed(1))
    loss = _gs_loss(TM.autocast(net), x)
    with pytest.raises(RuntimeError, match="no second derivative"):
        torch.autograd.grad(loss, net.conv_list[0].weight)
    with ck.fused_chains_disabled():
        loss = _gs_loss(TM.autocast(net), x)
    assert torch.isfinite(torch.autograd.grad(loss, net.conv_list[0].weight)[0]).all()


def test_gspnp_over_bf16_dncnn_takes_the_layers_for_second_order():
    """``GSPnP(autocast(DnCNN))``: its training gradient is the layer path's,
    the same bits; its first-order call (no parameter needs a gradient) runs
    the stash op and equals the layers within bf16 rounding."""
    net = TM.DnCNN(1, 1, depth=4, device=DEV, generator=torch.Generator().manual_seed(0))
    gs = TM.GSPnP(TM.autocast(net))
    x = torch.rand((1, 1, 12, 12), generator=torch.Generator().manual_seed(1))

    def grads(chains):
        net.zero_grad()
        with chains:
            ((gs(x, 0.05) - x) ** 2).sum().backward()
        return [p.grad.clone() for p in net.parameters()]

    import contextlib
    calls = []
    orig = ck.conv_chain_stash
    ck.conv_chain_stash = lambda *a, **k: calls.append(1) or orig(*a, **k)
    try:
        fused = grads(contextlib.nullcontext())
        assert calls == []
        layers = grads(ck.fused_chains_disabled())
        assert all(torch.equal(a, b) for a, b in zip(fused, layers))
        for p in net.parameters():
            p.requires_grad_(False)
        out = gs(x, 0.05)
        assert len(calls) == 1
        with ck.fused_chains_disabled():
            ref = gs(x, 0.05)
    finally:
        ck.conv_chain_stash = orig
    assert float((out - ref).abs().max()) <= 3e-2 * float(ref.abs().max())
