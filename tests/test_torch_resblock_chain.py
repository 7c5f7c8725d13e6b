"""The port's resblock-chain op against the JAX package's Pallas kernel.

The CUDA kernel itself runs only on a GPU (chip_smoke.py compares it with
its plain version there). Here, on the CPU, the op takes its plain PyTorch
version, which is held to the JAX kernel run in Pallas interpret mode and to
the JAX f32 reference; its autograd gradients are held to the JAX
custom_vjp's. Inputs come from a numpy seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepinv_tpu_torch.ops.kernels.resblock_chain as rc_mod
from deepinv_tpu.ops.pallas.resblock_chain import (_fold, _lax_resblocks_f32, _unfold,
                                                   fused_resblock_chain_folded)
from deepinv_tpu_torch.ops.kernels import build
from deepinv_tpu_torch.ops.kernels.resblock_chain import (_check_cuda, pack_weights,
                                                          resblock_chain,
                                                          resblock_chain_plain,
                                                          resblocks_f32)
from deepinv_tpu_torch.utils.profiling import counters


def _inputs(R, seed=0, shape=(1, 64, 16, 16)):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal(shape).astype(np.float32)
    w1 = (rng.standard_normal((R, 64, 64, 3, 3)) * 0.08).astype(np.float32)
    w2 = (rng.standard_normal((R, 64, 64, 3, 3)) * 0.08).astype(np.float32)
    return h, w1, w2


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


def test_resblocks_f32_matches_jax_reference():
    """f32 chain vs ``_lax_resblocks_f32`` (resblock_chain.py:139): the same
    f32 convs in another summation order, relative error <= 1e-5."""
    h, w1, w2 = _inputs(2)
    want = _unfold(_lax_resblocks_f32(_fold(jnp.asarray(h)), jnp.asarray(w1), jnp.asarray(w2)))
    got = resblocks_f32(torch.from_numpy(h), torch.from_numpy(w1), torch.from_numpy(w2))
    assert _rel(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("R", [1, 3])
def test_plain_chain_matches_pallas_interpret(R):
    """bf16 plain chain vs the Pallas kernel in interpret mode at
    (1, 16, 8, 128) folded = (1, 64, 16, 16): bf16 rounding in two
    implementations, relative max error <= 2e-2 (the JAX test's bound,
    tests/test_models.py:659-688)."""
    h, w1, w2 = _inputs(R, seed=R)
    hb = jnp.asarray(h, jnp.bfloat16)
    want = _unfold(fused_resblock_chain_folded(_fold(hb), jnp.asarray(w1), jnp.asarray(w2),
                                               True)).astype(jnp.float32)
    got = resblock_chain(torch.tensor(np.asarray(hb.astype(jnp.float32))).to(torch.bfloat16),
                         torch.from_numpy(w1), torch.from_numpy(w2))
    assert got.dtype == torch.bfloat16 and got.shape == (1, 64, 16, 16)
    assert _rel(got.float().numpy(), want) <= 2e-2


def test_gradients_match_jax_custom_vjp():
    """Weight (and input) gradients of the autograd.Function vs ``jax.grad``
    through the JAX kernel's custom_vjp: both are autodiff of the f32 chain,
    relative error <= 3e-2."""
    h, w1, w2 = _inputs(2, seed=7)
    hb = jnp.asarray(h, jnp.bfloat16)

    def loss(v, a, b):
        return jnp.sum(fused_resblock_chain_folded(v, a, b, True).astype(jnp.float32))

    dv, g1, g2 = jax.grad(loss, argnums=(0, 1, 2))(_fold(hb), jnp.asarray(w1), jnp.asarray(w2))
    ht = torch.tensor(np.asarray(hb.astype(jnp.float32))).to(torch.bfloat16).requires_grad_()
    w1t = torch.from_numpy(w1).requires_grad_()
    w2t = torch.from_numpy(w2).requires_grad_()
    resblock_chain(ht, w1t, w2t).float().sum().backward()
    assert ht.grad.dtype == torch.bfloat16 and w1t.grad.dtype == torch.float32
    assert _rel(w1t.grad.numpy(), g1) <= 3e-2
    assert _rel(w2t.grad.numpy(), g2) <= 3e-2
    assert _rel(ht.grad.float().numpy(), _unfold(dv).astype(jnp.float32)) <= 3e-2


def test_plain_chain_rounds_once_per_conv():
    """The plain version's rounding: f32 arithmetic on bf16 values, one bf16
    rounding after conv1's ReLU and one after conv2's residual add."""
    h, w1, w2 = _inputs(1, seed=3, shape=(2, 64, 9, 7))
    hb = torch.from_numpy(h).to(torch.bfloat16)
    w1b = torch.from_numpy(w1).to(torch.bfloat16).float()
    w2b = torch.from_numpy(w2).to(torch.bfloat16).float()
    t = torch.relu(torch.nn.functional.conv2d(hb.float(), w1b[0], padding=1)).to(torch.bfloat16)
    want = (hb.float() + torch.nn.functional.conv2d(t.float(), w2b[0], padding=1)).to(
        torch.bfloat16)
    got = resblock_chain_plain(hb, torch.from_numpy(w1), torch.from_numpy(w2))
    assert torch.equal(got, want)


def test_cpu_tensor_takes_the_plain_version():
    """On a CPU tensor the op runs the plain version: no kernel launch is
    counted and nothing is built."""
    h, w1, w2 = _inputs(1, shape=(1, 64, 8, 8))
    before = counters["kernel.resblock_chain.launches"]
    out = resblock_chain(torch.from_numpy(h).to(torch.bfloat16), torch.from_numpy(w1),
                         torch.from_numpy(w2))
    assert torch.equal(out, resblock_chain_plain(torch.from_numpy(h), torch.from_numpy(w1),
                                                 torch.from_numpy(w2)))
    assert counters["kernel.resblock_chain.launches"] == before
    assert build.load_library.cache_info().currsize == 0


def test_pack_weights_layout():
    """Kernel weight layout: packed[r, ky*3 + kx, co, ci] = w[r, co, ci, ky, kx], bf16."""
    _, w1, _ = _inputs(2)
    w = torch.from_numpy(w1)
    p = pack_weights(w)
    assert p.shape == (2, 9, 64, 64) and p.dtype == torch.bfloat16 and p.is_contiguous()
    for r, ky, kx, co, ci in [(0, 0, 0, 0, 0), (1, 2, 1, 5, 63), (0, 1, 2, 63, 7)]:
        assert p[r, ky * 3 + kx, co, ci] == w[r, co, ci, ky, kx].to(torch.bfloat16)


@pytest.mark.parametrize("case", ["f32", "channels", "strided", "packed"])
def test_kernel_input_checks_raise(case):
    """What the CUDA kernel does not take raises before any launch:
    non-bf16 activations, C != 64, non-contiguous, misshapen weights."""
    h = torch.zeros((1, 64, 8, 8), dtype=torch.bfloat16)
    wp = torch.zeros((2, 9, 64, 64), dtype=torch.bfloat16)
    if case == "f32":
        with pytest.raises(TypeError):
            _check_cuda(h.float(), wp, wp)
    elif case == "channels":
        with pytest.raises(ValueError):
            _check_cuda(torch.zeros((1, 32, 8, 8), dtype=torch.bfloat16), wp, wp)
    elif case == "strided":
        with pytest.raises(ValueError):
            _check_cuda(torch.zeros((1, 64, 8, 16), dtype=torch.bfloat16)[..., ::2], wp, wp)
    else:
        with pytest.raises(ValueError):
            _check_cuda(h, wp, wp[:, :8])


def test_backward_computes_only_the_gradients_asked_for(monkeypatch):
    """With weights that ask for no gradient (a DPS step: the guidance is
    differentiated with respect to x alone), the backward's f32 recompute
    asks autograd for dh only, and dh equals the dh of the backward that
    also computes dW1 and dW2."""
    h, w1, w2 = _inputs(2, seed=11, shape=(1, 64, 12, 10))
    g = torch.from_numpy(np.random.default_rng(12).standard_normal(h.shape).astype(np.float32))
    asked = []
    f32_chain = rc_mod.resblocks_f32
    monkeypatch.setattr(rc_mod, "resblocks_f32",
                        lambda *a: asked.append([v.requires_grad for v in a]) or f32_chain(*a))
    hb = torch.from_numpy(h).to(torch.bfloat16)
    grads = []
    for weights_need_grad in (True, False):
        ht = hb.clone().requires_grad_()
        ws = [torch.from_numpy(w).requires_grad_(weights_need_grad) for w in (w1, w2)]
        (dh,) = torch.autograd.grad((resblock_chain(ht, *ws).float() * g).sum(), ht)
        grads.append(dh)
        assert all(w.grad is None for w in ws)
    assert asked == [[True, True, True], [True, False, False]]
    assert grads[1].dtype == torch.bfloat16 and torch.equal(grads[0], grads[1])
