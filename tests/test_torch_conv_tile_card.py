"""The 64-channel wgmma conv tile on the card, in both plan forms.

``conv_tile_plan`` gives the tile a banded plan or the balanced schedule
(``ops/kernels/conv_tile.py``). On the same inputs the two compute every
output value with the same products in the same order, so the ops on the
tile give the same bits under either; each is also held to its plain
version (``KERNEL_RTOL`` and ``STASH_BWD_RTOL`` of ``chip_smoke.py``), and
the launch counters name the form each layer took.

Every test here is marked ``card`` and skips without a CUDA card. On the
card run it alone, without the suite's ``conftest.py`` (which sets up JAX
for the CPU tests; this file imports no JAX)::

    python -m pytest tests/test_torch_conv_tile_card.py --noconftest -q
"""

import pytest
import torch

from deepinv_tpu_torch.ops.kernels import conv_tile
from deepinv_tpu_torch.ops.kernels.conv_chain import (conv_chain, conv_chain_plain,
                                                      conv_chain_stash, conv_chain_stash_plain,
                                                      stash_backward)
from deepinv_tpu_torch.ops.kernels.resblock_chain import resblock_chain, resblock_chain_plain
from deepinv_tpu_torch.ops.kernels.up_resblock_chain import (up_resblock_chain,
                                                             up_resblock_chain_plain)
from deepinv_tpu_torch.ops.kernels.up_sandwich import up_sandwich, up_sandwich_plain
from deepinv_tpu_torch.utils.profiling import counters

KERNEL_RTOL = 2e-2      # chip_smoke.py: kernel against plain, the order of f32 sums
STASH_BWD_RTOL = 3e-2   # chip_smoke.py: the stash backward against its plain version


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _banded(monkeypatch):
    """Make every op on the tile take the banded plan (the wrappers import
    ``conv_tile_plan`` from its module at each call)."""
    monkeypatch.setattr(conv_tile, "conv_tile_plan",
                        lambda B, H, W, sms=conv_tile.H100_SMS: conv_tile._banded_plan(B, H, W,
                                                                                        sms))


def _randn(gen, shape, std, dev):
    return (torch.randn(shape, generator=gen) * std).to(dev)


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def _inputs(op, B, H, W, dev):
    """The op's call and its plain version's on random inputs at the init
    scales the port's networks use; (B, H, W) is the 64-channel chain's
    activation."""
    gen = torch.Generator().manual_seed(B * 1000 + H + W)
    s0 = (2 / 576) ** 0.5
    if op in ("k5", "k6"):
        h = _randn(gen, (B, 64, H, W), 1.0, dev).to(torch.bfloat16)
        ws, bs = _randn(gen, (18, 64, 64, 3, 3), s0, dev), _randn(gen, (18, 64), 0.01, dev)
        if op == "k5":
            return (lambda: conv_chain(h, ws, bs)), (lambda: conv_chain_plain(h, ws, bs))
        return (lambda: conv_chain_stash(h, ws, bs)), (lambda: conv_chain_stash_plain(h, ws, bs))
    if op == "k1":
        h = _randn(gen, (B, 64, H, W), 1.0, dev).to(torch.bfloat16)
        w1, w2 = (_randn(gen, (4, 64, 64, 3, 3), 0.2 * s0, dev) for _ in range(2))
        return (lambda: resblock_chain(h, w1, w2)), (lambda: resblock_chain_plain(h, w1, w2))
    if op == "k2":
        v = _randn(gen, (B, 128, H // 2, W // 2), 1.0, dev).to(torch.bfloat16)
        wu = _randn(gen, (128, 64, 2, 2), (2 / 512) ** 0.5, dev)
        w1, w2 = (_randn(gen, (4, 64, 64, 3, 3), 0.2 * s0, dev) for _ in range(2))
        return ((lambda: up_resblock_chain(v, wu, w1, w2)),
                (lambda: up_resblock_chain_plain(v, wu, w1, w2)))
    s2 = _randn(gen, (B, 256, H // 4, W // 4), 1.0, dev).to(torch.bfloat16)
    d0 = _randn(gen, (B, 64, H, W), 1.0, dev).to(torch.bfloat16)
    s1 = 0.2 * (2 / 1152) ** 0.5
    wts = (_randn(gen, (256, 128, 2, 2), (2 / 1024) ** 0.5, dev),
           _randn(gen, (4, 128, 128, 3, 3), s1, dev), _randn(gen, (4, 128, 128, 3, 3), s1, dev),
           _randn(gen, (128, 64, 2, 2), (2 / 256) ** 0.5, dev),
           _randn(gen, (128, 64, 2, 2), (2 / 512) ** 0.5, dev),
           _randn(gen, (4, 64, 64, 3, 3), 0.2 * s0, dev),
           _randn(gen, (4, 64, 64, 3, 3), 0.2 * s0, dev))
    return (lambda: up_sandwich(s2, d0, *wts)), (lambda: up_sandwich_plain(s2, d0, *wts))


# (op, B, H, W of the 64-channel chain): K5 at the MRI cell's shape and at
# a ragged 300 wide (a last strip of 44 columns: the narrow product; ranges
# crossing strips and images), K6 there, K1 at B = 14 (balanced at 256²),
# K2/K3 and K4 with their 64-channel chains on the balanced schedule
CASES = [("k5", 16, 320, 320), ("k5", 5, 50, 300), ("k5", 1, 320, 320), ("k6", 5, 50, 300),
         ("k1", 14, 256, 256), ("k2", 5, 50, 300), ("k4", 2, 48, 320)]


@pytest.mark.card
@pytest.mark.parametrize("op,B,H,W", CASES)
def test_plan_forms_give_the_same_bits(card, monkeypatch, op, B, H, W):
    """The op on the balanced schedule (the plan these shapes take) and on
    the banded plan: the same bits; each within KERNEL_RTOL of the plain
    version (relative max error)."""
    assert conv_tile.conv_tile_plan(B, H, W).balanced
    run, plain = _inputs(op, B, H, W, card)
    with torch.no_grad():
        balanced = run().clone()
        want = plain()
        with monkeypatch.context() as m:
            _banded(m)
            banded = run()
        torch.cuda.synchronize()
    assert torch.equal(balanced, banded)
    assert torch.isfinite(balanced.float()).all()
    assert _rel(balanced, want) <= KERNEL_RTOL


@pytest.mark.card
@pytest.mark.parametrize("B,H,W", [(5, 50, 300), (16, 320, 320)])
def test_stash_backward_plan_forms(card, monkeypatch, B, H, W):
    """The stash backward (head, L dX launches of the tile with the kMaskDb
    epilogue and the last on kRound, the fold) in both plan forms on one
    stash: dh and dW the same bits (dW's cuDNN wgrad reads the d_l the tile
    wrote); db sums each CTA's values, and the CTAs differ between the
    forms, so only the order of its f32 sums differs: within 1e-5 of each
    other. Each within STASH_BWD_RTOL of the plain backward."""
    assert conv_tile.conv_tile_plan(B, H, W).balanced
    gen = torch.Generator().manual_seed(B + W)
    L = 4
    h = _randn(gen, (B, 64, H, W), 1.0, card).to(torch.bfloat16)
    ws = _randn(gen, (L, 64, 64, 3, 3), 0.08, card).to(torch.bfloat16)
    bs = _randn(gen, (L, 64), 0.02, card)
    g = _randn(gen, (B, 64, H, W), 1.0, card)
    with torch.no_grad():
        acts = conv_chain_stash(h, ws, bs)
        got = [t.clone() for t in stash_backward(h, ws, acts, g)]
        with monkeypatch.context() as m:
            _banded(m)
            banded = stash_backward(h, ws, acts, g)
        plain = stash_backward(h, ws, acts, g, plain=True)
        torch.cuda.synchronize()
    assert torch.equal(got[0], banded[0]) and torch.equal(got[1], banded[1])
    assert _rel(got[2], banded[2]) <= 1e-5
    for a, b in zip(got, plain):
        assert _rel(a, b) <= STASH_BWD_RTOL


@pytest.mark.card
def test_launch_counters_name_the_plan_form(card):
    """One K5 call at the MRI cell's 16 x 320² adds its 18 layers to
    ``kernel.conv_tile.launches.balanced``; one K1 call at the HQS cell's
    16 x 256² (R = 4) adds its 8 to ``.banded`` and nothing to
    ``.balanced``."""
    k5, _ = _inputs("k5", 16, 320, 320, card)
    k1, _ = _inputs("k1", 16, 256, 256, card)
    for run, balanced, banded in ((k5, 18, 0), (k1, 0, 8)):
        before = counters.snapshot()
        with torch.no_grad():
            run()
        moved = {form: counters[f"kernel.conv_tile.launches.{form}"]
                 - before.get(f"kernel.conv_tile.launches.{form}", 0)
                 for form in ("balanced", "banded")}
        assert moved == {"balanced": balanced, "banded": banded}
