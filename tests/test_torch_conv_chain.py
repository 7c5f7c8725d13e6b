"""The port's DnCNN conv-chain op against the JAX package's Pallas kernel.

The CUDA kernel itself runs only on a GPU (chip_smoke.py compares it with its
plain version there). Here, on the CPU, the op takes its plain PyTorch
version, which is held to the JAX XLA chain ``_lax_chain``, to the Pallas
kernel run in interpret mode and, for gradients, to ``jax.grad`` through the
kernel's custom_vjp. Inputs come from a numpy seed, at the JAX test's scales
(tests/test_models.py:600-656).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepinv_tpu.ops.pallas.conv_chain import (_lax_chain, _lax_chain_f32,
                                               fused_conv3x3_relu_chain)
from deepinv_tpu_torch.ops.kernels import build
from deepinv_tpu_torch.ops.kernels.conv_chain import (_check_cuda, chain_f32, conv_chain,
                                                      conv_chain_plain, pack_bias,
                                                      pack_weights)


def _inputs(L, seed=0, shape=(1, 64, 16, 16)):
    rng = np.random.default_rng(seed)
    ws = (rng.standard_normal((L, 64, 64, 3, 3)) * 0.08).astype(np.float32)
    bs = (rng.standard_normal((L, 64)) * 0.02).astype(np.float32)
    h = np.array(jnp.asarray(rng.standard_normal(shape), jnp.bfloat16).astype(jnp.float32))
    return h, ws, bs


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


def _port(h, ws, bs, **kw):
    return conv_chain(torch.from_numpy(h).to(torch.bfloat16), torch.from_numpy(ws),
                      torch.from_numpy(bs), **kw)


@pytest.mark.parametrize("L", [4, 5, 18])
def test_plain_chain_matches_lax_chain(L):
    """bf16 plain chain vs ``_lax_chain`` (conv_chain.py:175): the same
    rounding points in two implementations, relative max error <= 2e-2 (the
    JAX test's bound, tests/test_models.py:616)."""
    h, ws, bs = _inputs(L, seed=L)
    want = _lax_chain(jnp.asarray(h, jnp.bfloat16), jnp.asarray(ws), jnp.asarray(bs))
    got = _port(h, ws, bs)
    assert got.dtype == torch.bfloat16 and got.shape == (1, 64, 16, 16)
    assert _rel(got.float().numpy(), want.astype(jnp.float32)) <= 2e-2


@pytest.mark.parametrize("L", [4, 5])
def test_plain_chain_matches_pallas_interpret(L):
    """bf16 plain chain vs the Pallas kernel in interpret mode, including
    its odd-L XLA tail: relative max error <= 2e-2."""
    h, ws, bs = _inputs(L, seed=10 + L)
    want = fused_conv3x3_relu_chain(jnp.asarray(h, jnp.bfloat16), jnp.asarray(ws),
                                    jnp.asarray(bs), True)
    assert _rel(_port(h, ws, bs).float().numpy(), want.astype(jnp.float32)) <= 2e-2


def test_chain_f32_matches_jax_reference():
    """f32 chain vs ``_lax_chain_f32`` (conv_chain.py:189): f32 convs summed
    in another order, relative error <= 1e-4."""
    h, ws, bs = _inputs(5, seed=1)
    want = _lax_chain_f32(jnp.asarray(h), jnp.asarray(ws), jnp.asarray(bs))
    got = chain_f32(torch.from_numpy(h), torch.from_numpy(ws), torch.from_numpy(bs))
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= 1e-4


@pytest.mark.parametrize("L", [4, 5])
def test_gradients_match_jax_custom_vjp(L):
    """Gradients for h, W and b of the autograd.Function vs ``jax.grad``
    through the interpret-mode kernel's custom_vjp (whose backward runs the
    activation gradients in bf16 over stashed activations): relative max
    error <= 3e-2 (tests/test_models.py:656). At L = 4 the h gradient agrees
    exactly; at L = 5 the JAX backward differentiates its odd XLA tail layer
    in f32 (conv_chain.py:418-423), and the h gradients differ by 2.8e-2."""
    h, ws, bs = _inputs(L, seed=20 + L)

    def loss(a, w, b):
        return jnp.sum(fused_conv3x3_relu_chain(a, w, b, True).astype(jnp.float32))

    gh, gw, gb = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(h, jnp.bfloat16),
                                                  jnp.asarray(ws), jnp.asarray(bs))
    ht = torch.from_numpy(h).to(torch.bfloat16).requires_grad_()
    wt = torch.from_numpy(ws).requires_grad_()
    bt = torch.from_numpy(bs).requires_grad_()
    conv_chain(ht, wt, bt).float().sum().backward()
    assert ht.grad.dtype == torch.bfloat16 and wt.grad.dtype == torch.float32
    assert _rel(wt.grad.numpy(), gw) <= 3e-2
    assert _rel(bt.grad.numpy(), gb) <= 3e-2
    assert _rel(ht.grad.float().numpy(), gh.astype(jnp.float32)) <= 3e-2


def test_batch_matches_lax_map():
    """B = 3 in one call vs the JAX package's per-image kernel under
    ``lax.map`` (conv_chain.py:262-272), interpret mode: relative max error
    <= 2e-2."""
    h, ws, bs = _inputs(3, seed=2, shape=(3, 64, 16, 16))
    jw, jb = jnp.asarray(ws), jnp.asarray(bs)
    want = jax.lax.map(lambda hi: fused_conv3x3_relu_chain(hi[None], jw, jb, True)[0],
                       jnp.asarray(h, jnp.bfloat16))
    got = _port(h, ws, bs)
    assert got.shape == (3, 64, 16, 16)
    assert _rel(got.float().numpy(), want.astype(jnp.float32)) <= 2e-2


def test_plain_chain_rounds_once_per_layer():
    """The plain version's rounding: f32 arithmetic on bf16 values and bf16
    weights, the bias in f32, one bf16 rounding after each ReLU."""
    h, ws, bs = _inputs(2, seed=3, shape=(2, 64, 9, 7))
    a = torch.from_numpy(h).to(torch.bfloat16)
    for l in range(2):
        w = torch.from_numpy(ws[l]).to(torch.bfloat16).float()
        b = torch.from_numpy(bs[l])[:, None, None]
        a = torch.relu(torch.nn.functional.conv2d(a.float(), w, padding=1) + b).to(torch.bfloat16)
    got = conv_chain_plain(torch.from_numpy(h), torch.from_numpy(ws), torch.from_numpy(bs))
    assert torch.equal(got, a)


def test_cpu_tensor_takes_the_plain_version():
    """On a CPU tensor the op runs the plain version: no kernel launch is
    counted and nothing is built."""
    h, ws, bs = _inputs(2, shape=(1, 64, 8, 8))
    before = conv_chain.launches
    out = _port(h, ws, bs)
    assert torch.equal(out, conv_chain_plain(torch.from_numpy(h), torch.from_numpy(ws),
                                             torch.from_numpy(bs)))
    assert conv_chain.launches == before
    assert build.load_library.cache_info().currsize == 0


def test_pack_layouts():
    """Kernel layouts: packed[l, ky*3 + kx, co, ci] = w[l, co, ci, ky, kx] in
    bf16; biases as contiguous (L, 64) float32."""
    _, ws, bs = _inputs(3)
    w = torch.from_numpy(ws)
    p = pack_weights(w)
    assert p.shape == (3, 9, 64, 64) and p.dtype == torch.bfloat16 and p.is_contiguous()
    for l, ky, kx, co, ci in [(0, 0, 0, 0, 0), (2, 2, 1, 5, 63), (1, 1, 2, 63, 7)]:
        assert p[l, ky * 3 + kx, co, ci] == w[l, co, ci, ky, kx].to(torch.bfloat16)
    b = pack_bias(torch.from_numpy(bs).to(torch.bfloat16).t().contiguous().t())
    assert b.dtype == torch.float32 and b.is_contiguous() and b.shape == (3, 64)


@pytest.mark.parametrize("case", ["f32", "channels", "strided", "weights", "layers",
                                  "bias_dtype", "bias_shape"])
def test_kernel_input_checks_raise(case):
    """What the CUDA kernel does not take raises before any launch:
    non-bf16 activations, C != 64, non-contiguous, misshapen weights, no
    layers, biases not (L, 64) float32."""
    h = torch.zeros((1, 64, 8, 8), dtype=torch.bfloat16)
    wp = torch.zeros((2, 9, 64, 64), dtype=torch.bfloat16)
    bp = torch.zeros((2, 64))
    bad = {
        "f32": (h.float(), wp, bp),
        "channels": (torch.zeros((1, 32, 8, 8), dtype=torch.bfloat16), wp, bp),
        "strided": (torch.zeros((1, 64, 8, 16), dtype=torch.bfloat16)[..., ::2], wp, bp),
        "weights": (h, wp[:, :8], bp),
        "layers": (h, wp[:0], bp[:0]),
        "bias_dtype": (h, wp, bp.to(torch.bfloat16)),
        "bias_shape": (h, wp, bp[:1]),
    }[case]
    with pytest.raises(TypeError if case == "f32" else ValueError):
        _check_cuda(*bad)
    _check_cuda(h, wp, bp)
    _check_cuda(h.contiguous(memory_format=torch.channels_last), wp, bp)
