"""The port's DRUNet in its ``fused`` configurations against the JAX package.

``DRUNet(fused=...)`` mirrors ``DEEPINV_TPU_FUSED_DRUNET`` (deepinv_tpu/models/
drunet_fold.py:160-178, 192, 215, 260). Widths nc=(64, 128, 32, 32) keep the
kernels' fixed widths (64 at scale 0, 128 at scale 1) and the rest narrow.
Each bf16 forward is held to two JAX forwards with the same weights:

- the JAX CPU bf16 forward (unfused: it rounds each conv, then adds the
  residual in bf16), within 5e-2 as ``test_bf16_autocast_forward_matches_jax``;
- the JAX W-folded forward in the same configuration, with its Pallas kernels
  run in interpret mode. Only the test reaches them: it sets the JAX package's
  environment switches and replaces its CPU gates (``can_fuse_*``) and kernel
  entry points (to pass ``interpret=True``) by monkeypatching; the package is
  not edited. Both sides then round at the same points, so the bound is 2e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepinv_tpu.ops.pallas.resblock_chain as jax_rc
import deepinv_tpu_torch.models.drunet as drunet_mod
from deepinv_tpu.models import autocast as jax_autocast
from deepinv_tpu_torch.models import DRUNet, autocast

from test_torch_drunet import DEV, _pair, _rel

NC = (64, 128, 32, 32)
OPS = ("resblock_chain", "up_resblock_chain", "up_sandwich")
# which of the port's kernel ops one forward calls, per configuration
EXPECTED = {"0": [], "down": ["resblock_chain"], "up": ["up_resblock_chain"],
            "both": ["resblock_chain", "up_resblock_chain"],
            "1": ["resblock_chain", "up_resblock_chain"],
            "sandwich": ["resblock_chain", "up_sandwich"]}
JAX_KERNELS = ("fused_resblock_chain_folded", "fused_up_resblock_chain_folded",
               "fused_up_sandwich_folded")


def _count_ops(monkeypatch):
    """Wrap the port's kernel ops as DRUNet calls them; returns the call log."""
    calls = []
    for name in OPS:
        op = getattr(drunet_mod, name)
        monkeypatch.setattr(drunet_mod, name,
                            lambda *a, op=op, name=name, **k: calls.append(name) or op(*a, **k))
    return calls


def _jax_pallas_forward(monkeypatch, mode):
    """Make the JAX DRUNet take its W-folded forward with the ``mode``
    configuration and its Pallas kernels in interpret mode on the CPU;
    returns the log of kernels it runs."""
    calls = []
    monkeypatch.setenv("DEEPINV_TPU_DRUNET_FOLD", "1")
    monkeypatch.setenv("DEEPINV_TPU_FUSED_DRUNET", mode)
    monkeypatch.setattr(jax_rc, "can_fuse_resblocks", lambda vf, n: n >= 1)
    monkeypatch.setattr(jax_rc, "can_fuse_up_resblocks",
                        lambda v, w, n: v.shape[0] == 1 and w.shape[1] == 64 and n >= 1)
    monkeypatch.setattr(jax_rc, "can_fuse_sandwich",
                        lambda s2, vd, w, n1, n0: s2.shape[0] == 1 and w.shape[1] == 128)
    for name in JAX_KERNELS:
        fn = getattr(jax_rc, name)
        monkeypatch.setattr(jax_rc, name,
                            lambda *a, fn=fn, name=name: calls.append(name) or fn(*a, True))
    return calls


@pytest.mark.parametrize("mode", ["up", "both", "sandwich"])
def test_bf16_configuration_matches_jax(mode, monkeypatch):
    """bf16 forward in ``mode``: the port calls the configuration's kernel
    ops once each (their plain versions on the CPU); it is within 2e-2 of the
    JAX folded forward on its interpret-mode Pallas kernels in the same
    configuration, and within 5e-2 of the JAX CPU bf16 forward."""
    ref, port = _pair(nc=NC, nb=2, seed=4)
    port.fused = mode
    x = np.random.default_rng(6).random((1, 3, 32, 32)).astype(np.float32)
    want_cpu = np.asarray(jax_autocast(ref)(jnp.asarray(x), 0.05), np.float32)
    calls = _count_ops(monkeypatch)
    with torch.no_grad():
        got = autocast(port)(torch.from_numpy(x), 0.05).numpy()
    assert calls == EXPECTED[mode]
    jax_calls = _jax_pallas_forward(monkeypatch, mode)
    want_fused = np.asarray(jax_autocast(ref)(jnp.asarray(x), 0.05), np.float32)
    assert sorted(jax_calls) == sorted(
        {"up": ["fused_up_resblock_chain_folded"],
         "both": ["fused_resblock_chain_folded", "fused_up_resblock_chain_folded"],
         "sandwich": ["fused_resblock_chain_folded", "fused_up_sandwich_folded"]}[mode])
    assert _rel(got, want_fused) <= 2e-2
    assert _rel(got, want_cpu) <= 5e-2


@pytest.mark.parametrize("mode", ["0", "down", "1"])
def test_modes_pick_their_stages(mode, monkeypatch):
    """Each configuration calls exactly its kernel ops on bf16 activations
    and none in f32; ``"1"`` is ``"both"``. Within 5e-2 of the JAX CPU bf16
    forward."""
    ref, port = _pair(nc=NC, nb=1, seed=2)
    port.fused = mode
    x = np.random.default_rng(8).random((1, 3, 32, 32)).astype(np.float32)
    calls = _count_ops(monkeypatch)
    with torch.no_grad():
        got = autocast(port)(torch.from_numpy(x), 0.05).numpy()
        assert calls == EXPECTED[mode]
        port(torch.from_numpy(x), 0.05)
    assert calls == EXPECTED[mode]
    want = np.asarray(jax_autocast(ref)(jnp.asarray(x), 0.05), np.float32)
    assert _rel(got, want) <= 5e-2


def test_fused_defaults_to_down_and_refuses_other_values():
    port = DRUNet(nc=(8, 8, 8, 8), nb=1, device=DEV)
    assert port.fused == "down"
    with pytest.raises(ValueError, match="fused"):
        DRUNet(nc=(8, 8, 8, 8), nb=1, device=DEV, fused="yes")
    with pytest.raises(ValueError, match="fused"):
        port.fused = "upp"


def test_other_widths_run_the_modules(monkeypatch):
    """Where a stage's widths are not its kernel's (scale 1 at 32 channels
    for the sandwich and a projection input not a multiple of 16 for the up
    chain), its modules run one by one, as the JAX gates decide
    (resblock_chain.py:292, :554)."""
    calls = _count_ops(monkeypatch)
    x = torch.rand((1, 3, 32, 32), generator=torch.Generator().manual_seed(0))
    for nc, mode, want in [((64, 32, 32, 32), "sandwich", ["resblock_chain"]),
                           ((64, 24, 32, 32), "up", [])]:
        calls.clear()
        port = DRUNet(nc=nc, nb=1, device=DEV, fused=mode,
                      generator=torch.Generator().manual_seed(1))
        with torch.no_grad():
            out = autocast(port)(x, 0.05)
        assert calls == want and bool(torch.isfinite(out).all())


def test_projection_inputs_past_256_channels_take_the_op(monkeypatch):
    """A projection input wider than 256 channels (scale 1 at 272 for the up
    chain, scale 2 at 272 for the sandwich) still takes the stage's op: the
    wgmma projection kernel streams its weights in chunks of 256 input
    channels, so no width gate stands between the op and the JAX gates'."""
    calls = _count_ops(monkeypatch)
    x = torch.rand((1, 3, 32, 32), generator=torch.Generator().manual_seed(0))
    for nc, mode, want in [((64, 272, 32, 32), "up", ["up_resblock_chain"]),
                           ((64, 128, 272, 32), "sandwich", ["resblock_chain", "up_sandwich"]),
                           ((64, 128, 256, 32), "sandwich", ["resblock_chain", "up_sandwich"])]:
        calls.clear()
        port = DRUNet(nc=nc, nb=1, device=DEV, fused=mode,
                      generator=torch.Generator().manual_seed(1))
        with torch.no_grad():
            out = autocast(port)(x, 0.05)
        assert calls == want and bool(torch.isfinite(out).all())


def test_packed_weights_are_cached_per_call_site():
    """Each kernel call site keeps its own stacks (``stacked_weights`` by
    name), so the sandwich's and the up chain's stacks do not evict each
    other or the down chain's; under autograd, gradients reach every stage."""
    port = DRUNet(nc=NC, nb=1, generator=torch.Generator().manual_seed(0), device=DEV,
                  fused="sandwich")
    den = autocast(port)
    x = torch.rand((1, 3, 32, 32), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        den(x, 0.05)
        cached = dict(den.denoiser._packed)
        den(x, 0.05)
        assert set(cached) == {"down0", "sandwich"}
        assert all(den.denoiser._packed[k] is cached[k] for k in cached)
        den.denoiser.fused = "both"
        den(x, 0.05)
        assert set(den.denoiser._packed) == {"down0", "sandwich", "up0"}
        assert den.denoiser._packed["down0"] is cached["down0"]
    den.denoiser.fused = "sandwich"
    den(x, 0.05).sum().backward()
    for mod in (den.denoiser.m_up2[0], den.denoiser.m_up2[1].conv1, den.denoiser.m_down1[-1],
                den.denoiser.m_up1[1].conv2):
        g = mod.weight.grad
        assert g is not None and bool(torch.isfinite(g.float()).all()) and float(g.abs().max()) > 0
