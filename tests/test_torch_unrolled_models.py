"""The port's unrolled networks against the JAX package's, on the CPU: MoDL's
reconstruction and its gradients (the schedule's and the DnCNN's) against
``jax.grad``, VarNet on single-coil MRI, PDNet on CT and PanNet on
pansharpening, with weights crossed by ``load_jax_params``.

f32 bounds are 1e-4 (max abs error over the reference's max): the networks
chain FFTs or projectors with a few conv stacks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import deepinv_tpu.models as JM
import deepinv_tpu.physics as JP
import deepinv_tpu_torch.models as TM
import deepinv_tpu_torch.physics as TP
from test_torch_drunet import DEV, jax_params

N = 16


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def modl_arrays(jnet, port) -> dict:
    """A JAX MoDL's leaves under the port's names: the schedule's
    ``params_algo.<k>`` is the port's ``param_<k>``."""
    arrays = {(f"param_{k[len('params_algo.'):]}" if k.startswith("params_algo.") else k): v
              for k, v in jax_params(jnet).items()}
    return {k: arrays[k] for k in port.state_dict()}


def _mri(seed=0, batch=2):
    rng = np.random.default_rng(seed)
    mask = (rng.random((N, N)) < 0.4).astype(np.float32)
    mask[N // 2 - 2:N // 2 + 2] = 1.0
    x = rng.random((batch, 2, N, N)).astype(np.float32)
    jp = JP.MRI(mask=jnp.asarray(mask), img_size=(N, N))
    tp = TP.MRI(mask=torch.from_numpy(mask), img_size=(N, N), device=DEV)
    y = np.asarray(jp.A(jnp.asarray(x)))
    y = (y + 0.01 * rng.standard_normal(y.shape) * (y != 0)).astype(np.float32)
    return x, y, jp, tp


def test_modl_default_recon_matches_jax():
    """``MoDL()``: 3 HQS steps over the depth-7, 64-channel DnCNN, f32; the
    port's parameters are the JAX leaves, by name."""
    x, y, jp, tp = _mri()
    jnet = JM.MoDL(key=jax.random.key(0))
    port = TM.MoDL(device=DEV)
    arrays = modl_arrays(jnet, port)
    assert {n for n, _ in port.named_parameters()} == set(arrays)
    TM.load_jax_params(port, arrays)
    with torch.no_grad():
        got = port(torch.from_numpy(y), tp).numpy()
    assert got.shape == x.shape
    assert _rel(got, jnet(jnp.asarray(y), jp)) <= 1e-4


def test_modl_gradients_match_jax_grad():
    """The first train step's loss and gradients of a MoDL (3 iterations, a
    depth-4 DnCNN with biases) in the schedule (stepsize, g_param, lambda)
    and every DnCNN weight, against ``jax.grad``; f32 within 1e-4."""
    x, y, jp, tp = _mri(1)
    jden = JM.DnCNN(2, 2, depth=4, nf=8, key=jax.random.key(1))
    rng = np.random.default_rng(2)
    for conv in [jden.in_conv, *jden.conv_list, jden.out_conv]:
        conv.bias = jnp.asarray(rng.standard_normal(conv.bias.shape) * 0.02, jnp.float32)
    jnet = JM.MoDL(denoiser=jden)
    port = TM.MoDL(denoiser=TM.DnCNN(2, 2, depth=4, nf=8, device=DEV), device=DEV)
    TM.load_jax_params(port, modl_arrays(jnet, port))

    def jloss(net):
        return jnp.mean((net(jnp.asarray(y), jp) - jnp.asarray(x)) ** 2)

    jl, jg = jax.value_and_grad(jloss)(jnet)
    tl = ((port(torch.from_numpy(y), tp) - torch.from_numpy(x)) ** 2).mean()
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5 * float(jl)
    want = modl_arrays(jg, port)
    names = [n for n, p in port.named_parameters() if p.grad is not None]
    assert {"param_stepsize", "prior.denoiser.conv_list.0.weight"} <= set(names)
    for n, p in port.named_parameters():
        if p.grad is None:    # a schedule entry HQS does not read: JAX's gradient is 0
            assert not np.any(want[n]), n
        else:
            assert _rel(p.grad.numpy(), want[n]) <= 1e-4, n


def test_varnet_matches_jax():
    """``VarNet(num_cascades=2)`` (a 3-scale UNet and a data-consistency
    weight a cascade) on the MRI problem, f32."""
    x, y, jp, tp = _mri(3)
    jnet = JM.VarNet(num_cascades=2, key=jax.random.key(2))
    jnet.blocks[1].dc_weight = jnp.asarray(0.7)
    port = TM.load_jax_params(TM.VarNet(num_cascades=2, device=DEV), jax_params(jnet))
    with torch.no_grad():
        got = port(torch.from_numpy(y), tp).numpy()
    assert _rel(got, jnet(jnp.asarray(y), jp)) <= 1e-4


def test_pdnet_matches_jax():
    """``PDNet(num_iter=2)`` on 16² CT with 10 views, f32."""
    rng = np.random.default_rng(4)
    x = rng.random((2, 1, N, N)).astype(np.float32)
    jp = JP.Tomography(angles=10, img_width=N)
    tp = TP.Tomography(angles=10, img_width=N, device=DEV)
    y = np.asarray(jp.A(jnp.asarray(x)))
    jnet = JM.PDNet(num_iter=2, key=jax.random.key(3))
    port = TM.load_jax_params(TM.PDNet(num_iter=2, device=DEV), jax_params(jnet))
    with torch.no_grad():
        got = port(torch.from_numpy(y), tp).numpy()
    assert got.shape == x.shape
    assert _rel(got, jnet(jnp.asarray(y), jp)) <= 1e-4


def test_pannet_and_its_sampler_match_jax():
    """``PanNet`` (8 channels, 2 blocks) on 4x pansharpening of a 3x16² image,
    its ``highpass``, and ``create_sampler``'s bicubic down- and upsampling,
    f32."""
    rng = np.random.default_rng(5)
    x = rng.random((1, 3, N, N)).astype(np.float32)
    jp = JP.Pansharpen((3, N, N), factor=4)
    tp = TP.Pansharpen((3, N, N), factor=4, device=DEV)
    jy = jp.A(jnp.asarray(x))
    ty = tp.A(torch.from_numpy(x))
    jnet = JM.PanNet(hrms_shape=(3, N, N), nf=8, n_blocks=2, key=jax.random.key(4))
    port = TM.load_jax_params(TM.PanNet(hrms_shape=(3, N, N), nf=8, n_blocks=2, device=DEV),
                              jax_params(jnet))
    with torch.no_grad():
        got = port(ty, tp).numpy()
        assert _rel(port.highpass(torch.from_numpy(x)), jnet.highpass(jnp.asarray(x))) <= 1e-5
        down = port.create_sampler("down", (3, N, N))
        up = port.create_sampler("up", (3, N, N))
        xd = down.A(torch.from_numpy(x))
        assert _rel(xd, jnet.create_sampler("down", (3, N, N)).A(jnp.asarray(x))) <= 1e-5
        assert _rel(up(xd), jnet.create_sampler("up", (3, N, N))(jnp.asarray(xd.numpy()))) <= 1e-5
        noisy = port.create_sampler("down", (3, N, N), noise_gain=0.1)
        assert isinstance(noisy.noise_model, TP.PoissonNoise)
    assert got.shape == x.shape
    assert _rel(got, jnet(jy, jp)) <= 1e-4
