"""The port's training path of the DnCNN chain (K6 and its stash backward)
against the JAX package's ``custom_vjp``, and the kernel switch.

The CUDA kernel runs only on a GPU (chip_smoke.py holds it to its plain
version there). Here the stash op takes its plain version, which is held to
the Pallas stash kernel ``_fused_fwd_stash_impl`` in interpret mode; the
backward is held to ``_bwd`` fed the same stash, and both to ``jax.grad``.
Inputs come from a numpy seed, at the JAX test's scales
(tests/test_models.py:600-656).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

import deepinv_tpu_torch.models.dncnn as dncnn_mod
import deepinv_tpu_torch.models.drunet as drunet_mod
from deepinv_tpu.ops.pallas.conv_chain import (_acts_to_nhwc, _bwd, _fused_fwd_stash_impl,
                                               fused_conv3x3_relu_chain)
from deepinv_tpu_torch.models import DnCNN, DRUNet, autocast
from deepinv_tpu_torch.ops.kernels import build
from deepinv_tpu_torch.ops.kernels.conv_chain import (conv_chain, conv_chain_plain,
                                                      conv_chain_stash, conv_chain_stash_plain,
                                                      fused_chains_disabled, fused_disabled,
                                                      stash_backward)
from deepinv_tpu_torch.utils.profiling import counters
from test_torch_conv_chain import _inputs, _rel


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


@pytest.mark.parametrize("L", [4, 5])
def test_stash_matches_pallas_interpret(L):
    """Every slot of the plain stash vs the interpret-mode Pallas stash
    through ``_acts_to_nhwc`` (conv_chain.py:377), and the chain's output vs
    the kernel's: relative max error <= 2e-2 (a few bf16 ulps from the order
    of the f32 sums). The TPU stashes the even prefix only (Le = 4 at L = 5)."""
    h, ws, bs = _inputs(L, seed=30 + L)
    out, acts = _fused_fwd_stash_impl(jnp.asarray(h, jnp.bfloat16), jnp.asarray(ws),
                                      jnp.asarray(bs), True)
    want = np.asarray(_acts_to_nhwc(acts, 16, 16).astype(jnp.float32))
    got = conv_chain_stash(_t(h, torch.bfloat16), _t(ws), _t(bs))
    assert got.shape == (L, 1, 16, 16, 64) and got.dtype == torch.bfloat16
    for l in range(want.shape[0]):
        assert _rel(got[l, 0].float().numpy(), want[l]) <= 2e-2, l
    le = L - L % 2
    assert _rel(got[le - 1, 0].permute(2, 0, 1).float().numpy(),
                np.asarray(out[0].astype(jnp.float32))) <= 2e-2
    # the output slot is the K5 chain's output
    plain = conv_chain_plain(_t(h, torch.bfloat16), _t(ws), _t(bs))
    assert torch.equal(got[-1].permute(0, 3, 1, 2), plain)


@pytest.mark.parametrize("L", [2, 4])
def test_backward_matches_bwd_on_the_same_stash(L):
    """``stash_backward`` fed the JAX stash and cotangent vs ``_bwd(True,
    res, g)`` (conv_chain.py:405): the same masks, rounding points and f32
    sums in another order. dW and db within 1e-3, dh within 1e-2 (relative
    max error; dh is rounded to bf16 after every layer)."""
    h, ws, bs = _inputs(L, seed=40 + L)
    hj = jnp.asarray(h, jnp.bfloat16)
    _, acts = _fused_fwd_stash_impl(hj, jnp.asarray(ws), jnp.asarray(bs), True)
    g = np.random.default_rng(L).standard_normal((1, 64, 16, 16)).astype(np.float32)
    dh_j, dw_j, db_j = _bwd(True, (hj, jnp.asarray(ws), jnp.asarray(bs), acts, None),
                            jnp.asarray(g))
    stash = _t(_acts_to_nhwc(acts, 16, 16).astype(jnp.float32), torch.bfloat16)[:, None]
    dh, dw, db = stash_backward(_t(h, torch.bfloat16), _t(ws), stash, _t(g))
    assert dh.dtype == torch.bfloat16 and dw.dtype == db.dtype == torch.float32
    assert _rel(dw.numpy(), dw_j) <= 1e-3
    assert _rel(db.numpy(), db_j) <= 1e-3
    assert _rel(dh.float().numpy(), np.asarray(dh_j, np.float32)) <= 1e-2


def _grads_port(h, ws, bs):
    ht = _t(h, torch.bfloat16).requires_grad_()
    wt, bt = _t(ws).requires_grad_(), _t(bs).requires_grad_()
    conv_chain(ht, wt, bt).float().sum().backward()
    return ht.grad, wt.grad, bt.grad


@pytest.mark.parametrize("B", [1, 3])
def test_gradients_match_jax_grad(B):
    """Gradients of h, W and b through the port's op (stash forward and
    backward) vs ``jax.grad`` through the interpret-mode kernel's custom_vjp,
    at B = 1 and under the JAX package's ``lax.map`` at B = 3 (L = 4):
    relative max error <= 3e-2 (tests/test_models.py:656)."""
    h, ws, bs = _inputs(4, seed=50 + B, shape=(B, 64, 16, 16))

    def loss(a, w, b):
        out = jax.lax.map(lambda hi: fused_conv3x3_relu_chain(hi[None], w, b, True)[0], a)
        return jnp.sum(out.astype(jnp.float32))

    gh, gw, gb = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(h, jnp.bfloat16),
                                                  jnp.asarray(ws), jnp.asarray(bs))
    dh, dw, db = _grads_port(h, ws, bs)
    assert _rel(dw.numpy(), gw) <= 3e-2
    assert _rel(db.numpy(), gb) <= 3e-2
    assert _rel(dh.float().numpy(), np.asarray(gh, np.float32)) <= 3e-2


def test_autograd_takes_the_stash_path(monkeypatch):
    """Under autograd the op's forward is the stash op and its backward
    ``stash_backward``; under ``torch.no_grad()`` neither runs. The output is
    a fresh tensor: an in-place op on it leaves the backward valid."""
    import deepinv_tpu_torch.ops.kernels.conv_chain as cc

    calls = []
    stash, bwd = cc.conv_chain_stash, cc.stash_backward
    monkeypatch.setattr(cc, "conv_chain_stash", lambda *a: calls.append("fwd") or stash(*a))
    monkeypatch.setattr(cc, "stash_backward", lambda *a: calls.append("bwd") or bwd(*a))
    h, ws, bs = _inputs(3, seed=5, shape=(2, 64, 8, 8))
    with torch.no_grad():
        ref = conv_chain(_t(h, torch.bfloat16), _t(ws), _t(bs))
    assert calls == []
    wt = _t(ws).requires_grad_()
    out = conv_chain(_t(h, torch.bfloat16), wt, _t(bs))
    assert calls == ["fwd"] and torch.equal(out.detach(), ref)
    out.mul_(2.0)
    out.float().sum().backward()
    assert calls == ["fwd", "bwd"] and bool(torch.isfinite(wt.grad).all())


def test_forward_mode_raises_a_clear_error():
    """The op has no forward-mode derivative, like the JAX custom_vjp: a JVP
    through it raises, naming the way out."""
    h, ws, bs = _inputs(2, seed=6, shape=(1, 64, 8, 8))
    with fwAD.dual_level():
        hd = fwAD.make_dual(_t(h, torch.bfloat16),
                            torch.ones((1, 64, 8, 8), dtype=torch.bfloat16))
        with pytest.raises(RuntimeError, match="fused_chains_disabled"):
            conv_chain(hd, _t(ws).requires_grad_(), _t(bs))


def test_stash_plain_on_cpu_builds_nothing():
    """On a CPU tensor the stash op runs its plain version: no launch is
    counted and nothing is built."""
    h, ws, bs = _inputs(2, shape=(1, 64, 8, 8))
    before = counters["kernel.conv_chain_stash.launches"]
    got = conv_chain_stash(_t(h, torch.bfloat16), _t(ws), _t(bs))
    assert torch.equal(got, conv_chain_stash_plain(_t(h), _t(ws), _t(bs)))
    assert counters["kernel.conv_chain_stash.launches"] == before
    assert build.load_library.cache_info().currsize == 0


def test_fused_chains_disabled_nests_and_restores():
    assert not fused_disabled()
    with fused_chains_disabled():
        assert fused_disabled()
        with fused_chains_disabled():
            assert fused_disabled()
        assert fused_disabled()
    assert not fused_disabled()
    with pytest.raises(KeyError):
        with fused_chains_disabled():
            raise KeyError("inside")
    assert not fused_disabled()


def _count_ops(monkeypatch):
    """Wrap every kernel op that DnCNN and DRUNet call; returns the call log."""
    calls = []
    for mod, name in ((dncnn_mod, "conv_chain"), (drunet_mod, "resblock_chain"),
                      (drunet_mod, "up_resblock_chain"), (drunet_mod, "up_sandwich")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, fn=fn, name=name, **k: calls.append(name)
                            or fn(*a, **k))
    return calls


@pytest.mark.parametrize("mode", ["both", "sandwich"])
def test_no_kernel_op_inside_fused_chains_disabled(monkeypatch, mode):
    """Inside ``fused_chains_disabled()`` no kernel op of DnCNN or DRUNet is
    called, with or without autograd; outside it the same models call theirs,
    and the outputs agree within the bf16 policy (3e-2)."""
    calls = _count_ops(monkeypatch)
    gen = torch.Generator().manual_seed(0)
    dn = autocast(DnCNN(1, 1, depth=5, generator=gen, device="cpu"))
    dr = autocast(DRUNet(1, 1, nc=(64, 128, 32, 32), nb=1, fused=mode, generator=gen,
                         device="cpu"))
    x = torch.rand((1, 1, 16, 16), generator=gen)
    with fused_chains_disabled():
        with torch.no_grad():
            off = [dn(x, 0.05), dr(x, 0.05)]
        (dn(x, 0.05).sum() + dr(x, 0.05).sum()).backward()
    assert calls == []
    with torch.no_grad():
        on = [dn(x, 0.05), dr(x, 0.05)]
    assert sorted(set(calls)) == sorted({"conv_chain", "resblock_chain",
                                         "up_resblock_chain" if mode == "both" else "up_sandwich"})
    for a, b in zip(on, off):
        assert _rel(a.numpy(), b.numpy()) <= 3e-2


def test_dncnn_fused_false_takes_the_layers(monkeypatch):
    """``DnCNN(fused=False)`` (the JAX ``DEEPINV_TPU_FUSED_DNCNN=0``) runs the
    hidden layers one by one, and computes what the op computes within the
    bf16 policy."""
    calls = _count_ops(monkeypatch)
    gen = torch.Generator().manual_seed(1)
    fused = DnCNN(1, 1, depth=6, generator=gen, device="cpu")
    layers = DnCNN(1, 1, depth=6, device="cpu", fused=False)
    layers.load_state_dict(fused.state_dict())
    x = torch.rand((2, 1, 16, 16), generator=gen)
    with torch.no_grad():
        got = autocast(layers)(x, 0.05)
        assert calls == []
        want = autocast(fused)(x, 0.05)
    assert calls == ["conv_chain"]
    assert _rel(got.numpy(), want.numpy()) <= 3e-2
