"""The port's DnCNN against the JAX package's on the CPU, same weights.

The JAX weights cross by tree path (``load_jax_params``); the biases, zero at
initialization in both packages, are drawn from a numpy seed so the bias
paths are exercised. bf16 activations take the kernel op ``conv_chain`` (its
plain version on the CPU) for the 18 hidden layers, f32 ones the layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepinv_tpu_torch.models.dncnn as dncnn_mod
from deepinv_tpu.models import DnCNN as JaxDnCNN
from deepinv_tpu.models import autocast as jax_autocast
from deepinv_tpu_torch.models import DnCNN, autocast, load_jax_params
from test_torch_drunet import DEV, jax_params


def _pair(channels=1, depth=20, seed=0, nf=64):
    """A JAX DnCNN with random biases and the port's copy of it."""
    ref = JaxDnCNN(channels, channels, depth=depth, nf=nf, key=jax.random.key(seed))
    rng = np.random.default_rng(seed)
    for conv in [ref.in_conv, *ref.conv_list, ref.out_conv]:
        conv.bias = jnp.asarray(rng.standard_normal(conv.bias.shape) * 0.02, jnp.float32)
    port = load_jax_params(DnCNN(channels, channels, depth=depth, nf=nf, device=DEV),
                           jax_params(ref))
    return ref, port


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


def test_load_jax_params_carries_every_weight():
    ref, port = _pair()
    arrays = jax_params(ref)
    state = port.state_dict()
    assert set(state) == set(arrays) and len(state) == 40
    assert "conv_list.17.bias" in state and isinstance(port.conv_list, torch.nn.ModuleList)
    for k, v in arrays.items():
        assert torch.equal(state[k], torch.from_numpy(v))


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_load_jax_params_refuses_mismatch(fault):
    ref, port = _pair(depth=4)
    arrays = jax_params(ref)
    if fault == "missing":
        arrays.pop("conv_list.1.bias")
    elif fault == "extra":
        arrays["conv_list.2.weight"] = arrays["conv_list.1.weight"]
    else:
        arrays["conv_list.0.weight"] = arrays["conv_list.0.weight"][:, :-1]
    with pytest.raises(ValueError if fault == "shape" else KeyError):
        load_jax_params(port, arrays)


@pytest.mark.parametrize("depth,channels", [(6, 2), (20, 1)])
def test_f32_forward_matches_jax(depth, channels):
    """f32 forward on 32 x 32 images, relative error <= 1e-4 (f32 convs
    summed in another order)."""
    ref, port = _pair(channels, depth, seed=depth)
    x = np.random.default_rng(1).random((2, channels, 32, 32)).astype(np.float32)
    want = ref(jnp.asarray(x), 0.05)
    with torch.no_grad():
        got = port(torch.from_numpy(x), 0.05)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= 1e-4


def test_bf16_autocast_forward_matches_jax(monkeypatch):
    """bf16 autocast forward vs the JAX package's. The port rounds each
    biased conv once, after the bias (like the TPU kernel, conv_chain.py:103-109);
    the JAX CPU path rounds the conv and then adds the bias in bf16
    (layers.py:104-115). Relative max error <= 5e-2; observed 2.5e-2."""
    calls = []
    chain = dncnn_mod.conv_chain
    monkeypatch.setattr(dncnn_mod, "conv_chain",
                        lambda *a, **k: calls.append(a[0].dtype) or chain(*a, **k))
    ref, port = _pair(seed=3)
    x = np.random.default_rng(2).random((1, 1, 64, 64)).astype(np.float32)
    want = jax_autocast(ref)(jnp.asarray(x), 0.05)
    den = autocast(port)
    with torch.no_grad():
        got = den(torch.from_numpy(x), 0.05)
        assert calls == [torch.bfloat16]          # the hidden chain went through the op
        port(torch.from_numpy(x), 0.05)
        assert calls == [torch.bfloat16]          # f32 takes the layers
    assert got.dtype == torch.float32
    # the wrapper keeps the module, whose f32 parameters it exposes; the
    # bf16 casts live only inside its calls
    assert den.denoiser is port and port.conv_list[0].bias.dtype == torch.float32
    assert {id(p) for p in den.parameters()} == {id(p) for p in port.parameters()}
    assert _rel(got.numpy(), np.asarray(want, np.float32)) <= 5e-2


@pytest.mark.parametrize("case", ["nf32", "no_bias", "one_hidden"])
def test_hidden_chain_gate(monkeypatch, case):
    """The kernel op takes the hidden chain only at nf = 64, with biases, with
    at least two hidden layers; otherwise the layers run one by one."""
    monkeypatch.setattr(dncnn_mod, "conv_chain", lambda *a, **k: pytest.fail("op called"))
    kw = {"nf32": dict(nf=32), "no_bias": dict(bias=False), "one_hidden": dict(depth=3)}[case]
    den = autocast(DnCNN(1, 1, **{"depth": 5, **kw}, generator=torch.Generator().manual_seed(0),
                         device=DEV))
    with torch.no_grad():
        out = den(torch.rand((1, 1, 16, 16), generator=torch.Generator().manual_seed(1)))
    assert bool(torch.isfinite(out).all())


def test_chain_weights_are_packed_once_per_weight_version(monkeypatch):
    """Inference reuses the stacked chain weights until a weight changes;
    under autograd the stacks are rebuilt so gradients reach each layer."""
    port = DnCNN(1, 1, depth=6, generator=torch.Generator().manual_seed(0), device=DEV)
    h = torch.rand((1, 64, 8, 8)).to(torch.bfloat16)
    stacks = []
    chain = dncnn_mod.conv_chain
    monkeypatch.setattr(dncnn_mod, "conv_chain", lambda h, ws, bs, packed: stacks.append(
        (ws, bs)) or chain(h, ws, bs, packed))
    with torch.no_grad():
        port._hidden_chain(h)
        port._hidden_chain(h)
        assert stacks[0][0] is stacks[1][0] and stacks[0][1] is stacks[1][1]
        port.conv_list[2].bias.add_(1.0)
        port._hidden_chain(h)
    assert stacks[2][1] is not stacks[0][1]
    assert torch.equal(stacks[2][1][2], port.conv_list[2].bias)

    den = autocast(port)
    x = torch.rand((1, 1, 16, 16), generator=torch.Generator().manual_seed(1))
    den(x, 0.05).sum().backward()
    for p in (den.denoiser.conv_list[0].weight, den.denoiser.conv_list[3].bias):
        assert p.grad is not None and bool(torch.isfinite(p.grad.float()).all())
        assert float(p.grad.abs().max()) > 0


def test_random_init_follows_the_jax_scheme():
    """He-normal weights (fan-in), zero biases, channels_last weights;
    ``pretrained`` is a local checkpoint, as in the JAX package (nothing is
    downloaded)."""
    port = DnCNN(2, 2, generator=torch.Generator().manual_seed(0), device=DEV)
    w = port.conv_list[5].weight
    assert abs(float(w.detach().std()) / (2 / (64 * 9)) ** 0.5 - 1) < 0.02
    assert float(port.out_conv.bias.detach().abs().max()) == 0.0
    assert w.is_contiguous(memory_format=torch.channels_last)
    with pytest.raises(FileNotFoundError):
        DnCNN(pretrained="download", device=DEV)
