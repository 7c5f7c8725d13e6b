"""3D DnCNN, DRUNet and UNet, ``pretrained=`` checkpoints and the tiling
helpers of the port against the JAX package's, on the CPU.

Weights cross by ``load_jax_params`` or through a checkpoint the test writes
(``.pth`` under upstream's names, or ``.npz``); f32 bounds are 1e-5 (max abs
error over the reference's max), checkpoints must give the same weights
exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepinv_tpu.models as JM
import deepinv_tpu_torch.models as TM
import deepinv_tpu_torch.models.dncnn as dncnn_mod
import deepinv_tpu_torch.models.drunet as drunet_mod
from deepinv_tpu_torch.models.convert import (dncnn_names, drunet_names, port_dncnn,
                                              upstream_state_dict)
from deepinv_tpu_torch.models.utils import stacked_weights
from test_torch_drunet import DEV, jax_params


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _biased(ref, seed=0):
    """Random small biases on every conv of a JAX module that has them."""
    rng = np.random.default_rng(seed)
    for k, v in jax_params(ref).items():
        if k.endswith("bias"):
            mod = ref
            for part in k.split(".")[:-1]:
                mod = mod[int(part)] if part.isdigit() else getattr(mod, part)
            mod.bias = jnp.asarray(rng.standard_normal(v.shape) * 0.05, jnp.float32)
    return ref


@pytest.mark.parametrize("model", ["dncnn", "drunet", "unet"])
def test_3d_models_match_jax(model):
    """f32 forwards of the 3D DnCNN (depth 4), DRUNet (nc 4-8, one block; the
    modulo-16 ``test_pad`` on 5D inputs) and UNet (inference-mode norms with
    random statistics, an odd volume through ``test_pad``) within 1e-5."""
    k = jax.random.key(5)
    if model == "dncnn":
        ref = _biased(JM.DnCNN(1, 1, depth=4, nf=8, dim=3, key=k))
        port = TM.DnCNN(1, 1, depth=4, nf=8, dim=3, device=DEV)
        shape, call = (2, 1, 8, 10, 6), lambda m, v: m(v)
    elif model == "drunet":
        ref = JM.DRUNet(1, 1, nc=(4, 8, 8, 8), nb=1, dim=3, key=k)
        port = TM.DRUNet(1, 1, nc=(4, 8, 8, 8), nb=1, dim=3, device=DEV)
        shape, call = (1, 1, 12, 16, 10), lambda m, v: m(v, 0.05)
    else:
        ref = JM.UNet(1, 1, scales=2, base=4, dim=3, key=k)
        rng = np.random.default_rng(1)
        for dc in [ref.inc, *ref.down, *ref.up]:
            for bn in (dc.bn1, dc.bn2):
                n = bn.weight.shape[0]
                bn.running_mean = jnp.asarray(rng.standard_normal(n) * 0.1, jnp.float32)
                bn.running_var = jnp.asarray(rng.random(n) + 0.5, jnp.float32)
                bn.bias = jnp.asarray(rng.standard_normal(n) * 0.1, jnp.float32)
        port = TM.UNet(1, 1, scales=2, base=4, dim=3, device=DEV)
        shape, call = (1, 1, 6, 5, 7), lambda m, v: m(v)
    TM.load_jax_params(port, jax_params(ref))
    x = np.random.default_rng(2).random(shape).astype(np.float32)
    with torch.no_grad():
        got = call(port, torch.from_numpy(x)).numpy()
    want = np.asarray(call(ref, jnp.asarray(x)))
    assert got.shape == want.shape == shape
    assert _rel(got, want) <= 1e-5


def test_2d_unet_without_norms_matches_jax():
    """The VarNet cascade's UNet (3 scales, base 16, no norms, no residual)
    in 2D, on an odd size, within 1e-5."""
    ref = JM.UNet(2, 2, scales=3, base=16, residual=False, batch_norm=False,
                  key=jax.random.key(1))
    port = TM.load_jax_params(TM.UNet(2, 2, scales=3, base=16, residual=False,
                                      batch_norm=False, device=DEV), jax_params(ref))
    x = np.random.default_rng(3).random((2, 2, 13, 10)).astype(np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert _rel(got, ref(jnp.asarray(x))) <= 1e-5


def _write(tmp_path, sd, suffix):
    path = tmp_path / f"ckpt{suffix}"
    if suffix == ".npz":
        np.savez(path, **{k: v.numpy() for k, v in sd.items()})
    else:
        torch.save({"state_dict": sd}, path)
    return str(path)


@pytest.mark.parametrize("suffix", [".pth", ".npz"])
def test_pretrained_2d_checkpoints_match_jax(tmp_path, suffix):
    """A DnCNN's and a DRUNet's weights written under upstream's names
    (``m_down1.0.res.0.weight``; a ``.pth`` wrapped in ``state_dict``, or an
    ``.npz``), read back by the port's and the JAX ``pretrained=``: the same
    weights, exactly, and the same outputs within 1e-5."""
    jd = _biased(JM.DnCNN(1, 1, depth=4, nf=8, key=jax.random.key(7)))
    jr = JM.DRUNet(1, 1, nc=(4, 8, 8, 8), nb=2, key=jax.random.key(8))
    for ref, make_j, make_t, names in (
            (jd, lambda p: JM.DnCNN(1, 1, depth=4, nf=8, pretrained=p),
             lambda p: TM.DnCNN(1, 1, depth=4, nf=8, pretrained=p, device=DEV), dncnn_names),
            (jr, lambda p: JM.DRUNet(1, 1, nc=(4, 8, 8, 8), nb=2, pretrained=p),
             lambda p: TM.DRUNet(1, 1, nc=(4, 8, 8, 8), nb=2, pretrained=p, device=DEV),
             drunet_names)):
        src = TM.load_jax_params(make_t(None), jax_params(ref))
        sd = upstream_state_dict(src, names(src))
        if names is drunet_names:
            assert "m_down1.0.res.0.weight" in sd and "m_up1.2.res.2.weight" in sd
        path = _write(tmp_path, sd, suffix)
        port, jref = make_t(path), make_j(path)
        for k, v in jax_params(jref).items():
            assert np.array_equal(port.state_dict()[k].numpy(), v), k
            assert np.array_equal(v, jax_params(ref)[k]), k
        x = np.random.default_rng(4).random((1, 1, 32, 32)).astype(np.float32)
        with torch.no_grad():
            got = port(torch.from_numpy(x), 0.05).numpy()
        assert _rel(got, jref(jnp.asarray(x), 0.05)) <= 1e-5


def test_pretrained_3d_drunet_isotropic_matches_jax(tmp_path):
    """``DRUNet(dim=3, pretrained=..., pretrained_2d_isotropic=True)`` from a
    2D model's ``.npz`` (the port's names, which JAX's inflation reads):
    the weights exactly as JAX inflates them, the outputs within 1e-5."""
    j2 = JM.DRUNet(1, 1, nc=(4, 4, 4, 4), nb=1, key=jax.random.key(9))
    path = str(tmp_path / "d2.npz")
    np.savez(path, **jax_params(j2))
    for iso in (False, True):
        ref = JM.DRUNet(1, 1, nc=(4, 4, 4, 4), nb=1, dim=3, pretrained=path,
                        pretrained_2d_isotropic=iso)
        port = TM.DRUNet(1, 1, nc=(4, 4, 4, 4), nb=1, dim=3, pretrained=path,
                         pretrained_2d_isotropic=iso, device=DEV)
        for k, v in jax_params(ref).items():
            assert np.allclose(port.state_dict()[k].numpy(), v, rtol=0, atol=1e-7), k
    x = np.random.default_rng(5).random((1, 1, 16, 16, 16)).astype(np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(x), 0.05).numpy()
    assert _rel(got, ref(jnp.asarray(x), 0.05)) <= 1e-5


def test_loading_after_the_first_call_changes_the_output():
    """A bf16 DnCNN at 64 channels keeps its stacked chain weights between
    calls; weights ported into it after a call give the new weights' output,
    the same bits as a model built from them."""
    g = torch.Generator().manual_seed(3)
    net = TM.autocast(TM.DnCNN(1, 1, depth=5, device=DEV, generator=g))
    new = TM.DnCNN(1, 1, depth=5, device=DEV, generator=g)
    x = torch.rand((1, 1, 16, 16), generator=g)
    with torch.no_grad():
        before = net(x)
        port_dncnn(net.denoiser, upstream_state_dict(new, dncnn_names(new)))
        after = net(x)
        want = TM.autocast(new)(x)
    assert not torch.equal(before, after)
    assert torch.equal(after, want)


def test_weight_cache_tells_a_new_tensor_at_an_old_address():
    """The stacked-weight cache misses for another tensor that sits at a
    cached one's address with the same version counter (a fresh bf16 cast of
    new weights does, after ``autocast`` drops its old casts): keyed on the
    address and the version alone it returned the old weights' stacks."""
    buf = np.random.default_rng(7).standard_normal((2, 3)).astype(np.float32)
    owner = torch.nn.Module()
    old = torch.from_numpy(buf)
    (stack_old, _) = stacked_weights(owner, ([old],), None)
    buf[:] = 2.0
    new = torch.from_numpy(buf)
    assert new.data_ptr() == old.data_ptr() and new._version == old._version
    (stack_new, _) = stacked_weights(owner, ([new],), None)
    assert float(stack_old.sum()) != 12.0 and float(stack_new.sum()) == 12.0
    assert stacked_weights(owner, ([new],), None)[0] is stack_new


def test_5d_activations_take_no_kernel():
    """bf16 3D DnCNN and DRUNet at the kernels' 64 channels run their layers:
    the gates refuse 5D activations (conv_chain.py:238's ``x.ndim != 4``)."""
    calls = []

    def counting(orig):
        return lambda *a, **k: calls.append(1) or orig(*a, **k)

    orig_c, orig_r = dncnn_mod.conv_chain, drunet_mod.resblock_chain
    dncnn_mod.conv_chain, drunet_mod.resblock_chain = counting(orig_c), counting(orig_r)
    try:
        x = torch.rand((1, 1, 8, 8, 8), generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            a = TM.autocast(TM.DnCNN(1, 1, depth=4, dim=3, device=DEV))(x)
            b = TM.autocast(TM.DRUNet(1, 1, nc=(64, 16, 16, 16), nb=2, dim=3, device=DEV))(x, 0.05)
            assert calls == []
            TM.autocast(TM.DnCNN(1, 1, depth=4, device=DEV))(x[:, :, 0])
            assert calls == [1]
    finally:
        dncnn_mod.conv_chain, drunet_mod.resblock_chain = orig_c, orig_r
    assert a.shape == b.shape == x.shape and torch.isfinite(a).all() and torch.isfinite(b).all()


def test_test_pad_and_onesplit():
    """``test_pad`` pads 4D and 5D inputs as JAX does; ``test_onesplit``
    reassembles a local model's output from four quadrants exactly (the JAX
    function raises on every input: ROADMAP queue 3)."""
    x = np.random.default_rng(6).random((1, 2, 5, 7, 9)).astype(np.float32)
    f = lambda v: v * (1 + v.shape[-1])
    for shape in ((1, 2, 7, 9), (1, 2, 5, 7, 9)):
        xs = x.reshape(-1)[:np.prod(shape)].reshape(shape)
        got = TM.test_pad(f, torch.from_numpy(xs), modulo=4).numpy()
        assert np.array_equal(got, np.asarray(JM.test_pad(f, jnp.asarray(xs), modulo=4)))
    conv = TM.Conv2d(1, 1, 3, generator=torch.Generator().manual_seed(1))
    img = torch.rand((2, 1, 100, 90), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        assert float((TM.test_onesplit(conv, img, refield=32) - conv(img)).abs().max()) < 1e-6
        up = TM.test_onesplit(lambda v: v.repeat_interleave(2, -1).repeat_interleave(2, -2),
                              img, refield=32, sf=2)
    assert torch.equal(up, img.repeat_interleave(2, -1).repeat_interleave(2, -2))
    with pytest.raises(ValueError):
        JM.test_onesplit(lambda v: v, jnp.asarray(img.numpy()), refield=32)
