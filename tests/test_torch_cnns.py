"""FFDNet, SRResNet, AutoEncoder and DScCP of the port against the JAX
package's, on the CPU, with weights crossed by ``load_jax_params`` or through
upstream-named checkpoints the test writes.

f32 bounds are 1e-5 (max abs error over the reference's max); DScCP runs from
JAX's power-method starts, handed in by ``draws=``, and is held at 1e-4 (20
power steps and 4 clipped CP steps in f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepinv_tpu.models as JM
import deepinv_tpu_torch.models as TM
from deepinv_tpu_torch.models.convert import (dsccp_names, srresnet_names,
                                              upstream_state_dict)
from test_torch_drunet import DEV, jax_params


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _randomize(ref, seed, skip=()):
    """Every leaf of a JAX module redrawn (biases, norm statistics and PReLU
    slopes included), so that nothing is left at its neutral start."""
    rng = np.random.default_rng(seed)
    for k, v in jax_params(ref).items():
        if k in skip:
            continue
        *path, leaf = k.split(".")
        mod = ref
        for part in path:
            mod = mod[int(part)] if part.isdigit() else getattr(mod, part)
        new = rng.standard_normal(v.shape) * 0.05
        if leaf == "running_var":
            new = rng.random(v.shape) + 0.5
        elif leaf == "weight" and v.ndim == 1:
            new = rng.random(v.shape) * 0.5 + 0.75
        elif leaf == "weight":
            new = v
        if isinstance(mod, list):
            mod[int(leaf)] = jnp.asarray(new, jnp.float32)
        else:
            setattr(mod, leaf, jnp.asarray(new, jnp.float32))
    return ref


def test_ffdnet_matches_jax():
    """FFDNet (depth 5, 16 channels) on an odd-sized RGB batch with a
    per-sample noise level, f32."""
    ref = _randomize(JM.FFDNet(3, 3, nf=16, depth=5, key=jax.random.key(0)), 0)
    port = TM.load_jax_params(TM.FFDNet(3, 3, nf=16, depth=5, device=DEV), jax_params(ref))
    x = np.random.default_rng(1).random((2, 3, 11, 14)).astype(np.float32)
    sigma = np.array([0.05, 0.1], np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(sigma)).numpy()
    assert got.shape == x.shape
    assert _rel(got, ref(jnp.asarray(x), jnp.asarray(sigma))) <= 1e-5


@pytest.mark.parametrize("norm", ["batch_norm", "instance_norm", "layer_norm", None])
def test_srresnet_matches_jax(norm):
    """SRResNet (2 blocks, 16 features, 4x) with each norm and PReLU slopes
    and norm statistics drawn at random; ``final_relu`` with batch norm."""
    relu = norm == "batch_norm"
    ref = _randomize(JM.SRResNet(2, 3, 16, 4, norm=norm, final_relu=relu,
                                 key=jax.random.key(2)), 2)
    port = TM.SRResNet(2, 3, 16, 4, norm=norm, final_relu=relu, device=DEV)
    assert {n for n, _ in port.named_parameters()} == set(jax_params(ref))
    TM.load_jax_params(port, jax_params(ref))
    x = np.random.default_rng(3).random((1, 3, 6, 5)).astype(np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 3, 24, 20)
    assert _rel(got, ref(jnp.asarray(x))) <= 1e-5


def test_srresnet_and_dsccp_pretrained_match_jax(tmp_path):
    """Weights written under upstream's names (``blocks.0.layers.1.running_var``,
    ``conv.2.weight``) and read back by the port's and the JAX ``pretrained=``:
    the same weights exactly."""
    ref = _randomize(JM.SRResNet(2, 3, 8, 2, key=jax.random.key(4)), 4)
    src = TM.load_jax_params(TM.SRResNet(2, 3, 8, 2, device=DEV), jax_params(ref))
    path = str(tmp_path / "srresnet.pth")
    sd = upstream_state_dict(src, srresnet_names(src))
    assert "blocks.1.layers.4.running_var" in sd and "upsampling.0.2.weight" in sd
    torch.save(sd, path)
    jref = JM.SRResNet(2, 3, 8, 2, pretrained=path)
    port = TM.SRResNet(2, 3, 8, 2, pretrained=path, device=DEV)
    for k, v in jax_params(ref).items():
        assert np.array_equal(port.state_dict()[k].numpy(), v), k
        assert np.array_equal(np.asarray(jax_params(jref)[k]), v), k
    dref = JM.DScCP(depth=3, n_channels_per_layer=4, in_channels=1, key=jax.random.key(5))
    dref.mu = jnp.asarray([0.5, 1.5, 2.0], jnp.float32)
    dsrc = TM.load_jax_params(TM.DScCP(3, 4, 1, device=DEV), jax_params(dref))
    path = str(tmp_path / "dsccp.npz")
    np.savez(path, **{k: v.numpy() for k, v in
                      upstream_state_dict(dsrc, dsccp_names(dsrc)).items()})
    port = TM.DScCP(3, 4, 1, pretrained=path, device=DEV)
    jref = JM.DScCP(depth=3, n_channels_per_layer=4, in_channels=1, pretrained=path)
    for k, v in jax_params(dref).items():
        assert np.array_equal(port.state_dict()[k].numpy(), v), k
        assert np.array_equal(np.asarray(jax_params(jref)[k]), v), k


def test_autoencoder_matches_jax():
    """The fully-connected autoencoder on 8² images, residual, f32."""
    ref = _randomize(JM.AutoEncoder(64, 32, 8, key=jax.random.key(6)), 6)
    port = TM.load_jax_params(TM.AutoEncoder(64, 32, 8, device=DEV), jax_params(ref))
    x = np.random.default_rng(7).random((3, 1, 8, 8)).astype(np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert _rel(got, ref(jnp.asarray(x))) <= 1e-5


def test_dsccp_from_jax_power_method_starts():
    """DScCP (4 layers, 8 channels, 20 power steps) from the JAX power
    methods' starts: ``jax.random.normal`` of ``split(key(0), depth)``, handed
    in by ``draws=``; f32 within 1e-4. The gradient reaches every kernel and
    ``mu`` (not through the relaxation coefficient, as in JAX)."""
    depth = 4
    ref = JM.DScCP(depth=depth, n_channels_per_layer=8, in_channels=1, key=jax.random.key(8))
    ref.mu = jnp.asarray([0.3, 0.6, 1.0, 1.4], jnp.float32)
    ref.power_iters = 20
    port = TM.load_jax_params(TM.DScCP(depth, 8, 1, device=DEV), jax_params(ref))
    port.power_iters = 20
    x = np.random.default_rng(9).random((2, 1, 10, 12)).astype(np.float32)
    keys = jax.random.split(jax.random.key(0), depth)
    draws = [np.asarray(jax.random.normal(k, x.shape)) for k in keys]
    got = port(torch.from_numpy(x), 0.1, draws=draws)
    assert _rel(got.detach().numpy(), ref(jnp.asarray(x), 0.1)) <= 1e-4
    got.sum().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in port.parameters())
    # drawn from a generator the result is another, equally valid one
    with torch.no_grad():
        own = port(torch.from_numpy(x), 0.1, generator=torch.Generator().manual_seed(0))
    assert _rel(own.numpy(), got.detach().numpy()) <= 1e-2
