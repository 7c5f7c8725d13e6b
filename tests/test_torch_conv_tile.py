"""The launch plan of the port's 64-channel wgmma conv tile (K1 and K5).

The kernel (``deepinv_tpu_torch/csrc/conv3x3_wgmma.cuh``) runs only on a GPU;
``chip_smoke.py`` holds it to its plain version there. Here, on the CPU, the
plan it is launched with (``conv_tile_plan``) is checked: the strips and
bands cover every output pixel exactly once, shared memory fits an SM, no
TMA box exceeds 256, and the plan agrees with the header's constants. The
kernel's ring protocol (which warpgroup releases which input row) is
replayed under random interleavings, and the tile's arithmetic (output
channels x pixels, one tap a shifted row, zero-filled halo, one rounding
per conv) is emulated in numpy band by band and held to the JAX package's
chains.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepinv_tpu.ops.pallas.conv_chain import _lax_chain
from deepinv_tpu.ops.pallas.resblock_chain import _fold, _lax_resblocks_f32, _unfold
from deepinv_tpu_torch.ops.kernels.conv_tile import (DEPTH, H100_SMS, SMEM_LIMIT, STRIP,
                                                     conv_tile_plan)
from deepinv_tpu_torch.ops.kernels.resblock_chain import pack_weights, tile_args

HEADER = Path(__file__).resolve().parents[1] / "deepinv_tpu_torch" / "csrc" / "conv3x3_wgmma.cuh"

# chip_smoke.py's KERNEL_SHAPES and CHAIN_SHAPES (and the B=8 shape of its
# phase 3), a ragged 37x53, and B up to 16 at 256²
SMOKE = [(1, 256, 256), (2, 256, 256), (1, 40, 56), (8, 256, 256)]
SHAPES = SMOKE + [(1, 37, 53), (3, 37, 53)] + [(b, 256, 256) for b in (3, 4, 5, 7, 12, 16)]


def band_of(plan, H: int, cta: int):
    """``(b, x0, y0, rows)`` of CTA ``cta`` as the kernel (``conv3x3_wgmma``)
    computes them: image b, columns x0 .. x0 + strip - 1 (clipped at W), rows
    y0 .. y0 + rows - 1."""
    col, band = divmod(cta, plan.bands)
    b, s = divmod(col, plan.strips)
    y0 = band * plan.rows_per_cta
    return b, s * plan.strip, y0, min(plan.rows_per_cta, H - y0)


def _coverage(B, H, W, plan):
    seen = np.zeros((B, H, W), np.int32)
    for cta in range(plan.grid):
        b, x0, y0, rows = band_of(plan, H, cta)
        assert rows >= 1 and 0 <= b < B and 0 <= y0 < H and 0 <= x0 < W
        seen[b, y0:y0 + rows, x0:min(x0 + plan.strip, W)] += 1
    return seen


@pytest.mark.parametrize("B,H,W", SHAPES)
def test_plan_covers_every_pixel_once(B, H, W):
    """Every output pixel lies in exactly one CTA's band and strip, no CTA is
    empty, and the grid is one wave of at most 132 CTAs."""
    plan = conv_tile_plan(B, H, W)
    assert plan.strips == -(-W // STRIP) and plan.grid == B * plan.strips * plan.bands
    assert plan.bands == -(-H // plan.rows_per_cta)
    assert (_coverage(B, H, W, plan) == 1).all()
    assert plan.grid <= H100_SMS
    # the band is the shortest that keeps one wave
    if plan.rows_per_cta > 1:
        assert B * plan.strips * -(-H // (plan.rows_per_cta - 1)) > H100_SMS


@pytest.mark.parametrize("B,H,W,sms", [(1, 7, 150, 6), (2, 9, 300, 5), (40, 3, 130, 16),
                                       (1, 1, 1, 132)])
def test_plan_covers_on_other_cards(B, H, W, sms):
    """The same on cards of few SMs, and where the strips alone exceed the
    SMs (then a band is a whole strip, in several waves)."""
    plan = conv_tile_plan(B, H, W, sms=sms)
    assert (_coverage(B, H, W, plan) == 1).all()
    if B * plan.strips > sms:
        assert plan.rows_per_cta == H and plan.grid == B * plan.strips


@pytest.mark.parametrize("B,H,W", SHAPES)
def test_plan_shared_memory_and_boxes(B, H, W):
    """Weights, the ring of 1024-byte-aligned slots, the two output buffers
    and the barriers, with a 1024-byte alignment slack, fit the 227 KB a
    block may have; each ring slot holds its TMA box and each output buffer
    its box, 1024-byte aligned (they follow the weights and the slots); no
    box dimension exceeds 256."""
    plan = conv_tile_plan(B, H, W)
    parts = plan.smem_parts()
    assert plan.smem_bytes == sum(parts.values()) <= SMEM_LIMIT
    assert parts["align"] == 1024 and parts["weights"] % 1024 == 0
    slot = parts["ring"] // plan.depth
    assert slot % 1024 == 0 and slot >= plan.box[0] * plan.box[1] * 2
    out = parts["out"] // 2
    assert out % 1024 == 0 and out == plan.out_box[0] * plan.out_box[1] * 2
    for box in (plan.box, plan.out_box, plan.weight_box):
        assert max(box) <= 256 and box[0] * 2 == 128   # inner extent: one 128-byte swizzle row
    assert plan.box[1] == plan.strip + 2 and plan.out_box[1] == plan.strip
    assert plan.depth == DEPTH >= 3


def test_plan_matches_header_constants():
    """The plan's numbers are the kernel's: NPIX, DEPTH and SMEM_BYTES as the
    header computes them (the kernel also checks the plan at launch)."""
    src = HEADER.read_text()
    consts = {}
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", src):
        consts[name] = int(eval(expr.replace("/", "//"), {}, dict(consts)))
    plan = conv_tile_plan(1, 256, 256)
    assert consts["NPIX"] == plan.strip and consts["DEPTH"] == plan.depth
    assert consts["SMEM_BYTES"] == plan.smem_bytes
    assert consts["BOX_W"] == plan.box[1]


def test_plan_rejects_empty_shapes():
    with pytest.raises(ValueError):
        conv_tile_plan(1, 0, 16)


def test_tile_argument():
    """``tile`` is ``"wgmma"`` (the default) or ``"mma"`` (the earlier tile,
    which takes no plan); anything else raises."""
    h = torch.zeros((1, 64, 4, 4), dtype=torch.bfloat16)
    assert tile_args(h, "mma") == ("", ())
    with pytest.raises(ValueError):
        tile_args(h, "fast")


def _replay_ring(rows: int, rng) -> None:
    """The kernel's ring protocol for a band of ``rows`` output rows, one
    random interleaving: the producer issues load i (input row y0 - 1 + i)
    once the load DEPTH before it in the same slot has 8 releases (4 warps of
    each consumer warpgroup); warpgroup q computes rows q, q + 2, ..., each
    reading loads r, r + 1, r + 2, then releasing loads r and r + 1 (and row 0
    load 0 once more, for the absent row above the band). Checks: every load
    a row reads is in its slot and not yet overwritten, no load is released
    more than 8 times, and the band ends."""
    loads = rows + 2
    issued, released = [], [0] * loads
    nxt = {0: 0, 1: 1}   # each warpgroup's next row
    while True:
        moves = []
        i = len(issued)
        if i < loads and (i < DEPTH or released[i - DEPTH] == 8):
            moves.append("p")
        for q in (0, 1):
            r = nxt[q]
            if r < rows and len(issued) >= r + 3:
                moves.append(q)
        if not moves:
            break
        m = moves[rng.integers(len(moves))]
        if m == "p":
            issued.append(len(issued))
            continue
        r = nxt[m]
        for k in range(3):   # the slot still holds load r + k
            assert len(issued) <= r + k + DEPTH
        released[r] += 4
        released[r + 1] += 4
        if r == 0:
            released[0] += 4
        assert max(released) <= 8
        nxt[m] = r + 2
    assert len(issued) == loads, f"the producer stalled at load {len(issued)} of {loads}"
    assert nxt[0] >= rows and nxt[1] >= rows, "a consumer stalled"
    # every load but the band's last two is released by both warpgroups
    assert all(v == 8 for v in released[:max(rows - 1, 0)])


@pytest.mark.parametrize("rows", [1, 2, 3, 4, 5, 6, 7, 8, 13, 32, 64])
def test_ring_protocol_never_stalls_or_overwrites(rows):
    rng = np.random.default_rng(rows)
    for _ in range(30):
        _replay_ring(rows, rng)


def _bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.bfloat16).float().numpy()


def _emulate_conv(x, wpk, plan, bias=None, residual=None):
    """One conv as the tile computes it, in numpy with f32 sums: x is NHWC
    (bf16 values), wpk one layer packed [tap][co][ci]. Per CTA band and row:
    the haloed ring rows (zero outside the image, as TMA fills them), D[co,
    n] = sum over taps of W[tap] @ ring[dy][n + dx]^T, then the epilogue (the
    NHWC ``residual`` added, or ``bias`` added and ReLU) and one bf16
    rounding, stored where x < W."""
    B, H, W, C = x.shape
    out = np.full_like(x, np.nan)
    for cta in range(plan.grid):
        b, x0, y0, rows = band_of(plan, H, cta)
        for y in range(y0, y0 + rows):
            ring = np.zeros((3, plan.strip + 2, C), np.float32)
            for dy in range(3):
                yy = y + dy - 1
                if 0 <= yy < H:
                    lo, hi = max(x0 - 1, 0), min(x0 + plan.strip + 1, W)
                    ring[dy, lo - (x0 - 1):hi - (x0 - 1)] = x[b, yy, lo:hi]
            d = np.zeros((C, plan.strip), np.float32)
            for tap in range(9):
                dy, dx = divmod(tap, 3)
                d += wpk[tap] @ ring[dy, dx:dx + plan.strip].T
            n = min(plan.strip, W - x0)
            v = d[:, :n].T
            if residual is not None:
                v = v + residual[b, y, x0:x0 + n]
            else:
                v = v + (0 if bias is None else bias)
                v = np.where(v < 0, 0, v)
            out[b, y, x0:x0 + n] = _bf16(v)
    assert not np.isnan(out).any()
    return out


def _emulate_chain(h, ws, bs, plan):
    x = _bf16(h.transpose(0, 2, 3, 1))
    wp = pack_weights(torch.from_numpy(ws)).float().numpy()
    for l in range(ws.shape[0]):
        x = _emulate_conv(x, wp[l], plan, bias=bs[l])
    return x.transpose(0, 3, 1, 2)


def _emulate_resblocks(h, w1, w2, plan):
    a = _bf16(h.transpose(0, 2, 3, 1))
    p1 = pack_weights(torch.from_numpy(w1)).float().numpy()
    p2 = pack_weights(torch.from_numpy(w2)).float().numpy()
    for r in range(w1.shape[0]):
        a = _emulate_conv(_emulate_conv(a, p1[r], plan), p2[r], plan, residual=a)
    return a.transpose(0, 3, 1, 2)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


# (B, H, W, SMs): two strips, the second ragged; bands of several rows with a
# short last one
EMU = [(1, 7, 150, 6), (2, 7, 136, 8)]


@pytest.mark.parametrize("B,H,W,sms", EMU)
def test_emulated_tile_matches_lax_chain(B, H, W, sms):
    """K5 on the tile's decomposition (3 layers) vs the JAX chain
    ``_lax_chain`` (conv_chain.py:175), same rounding points: relative max
    error <= 2e-2 (chip_smoke.py's KERNEL_RTOL)."""
    rng = np.random.default_rng(B * 100 + W)
    plan = conv_tile_plan(B, H, W, sms=sms)
    assert plan.rows_per_cta > 1 and H % plan.rows_per_cta and plan.strips == 2
    h = rng.standard_normal((B, 64, H, W)).astype(np.float32)
    ws = (rng.standard_normal((3, 64, 64, 3, 3)) * (2 / 576) ** 0.5).astype(np.float32)
    bs = (rng.standard_normal((3, 64)) * 0.02).astype(np.float32)
    want = _lax_chain(jnp.asarray(h, jnp.bfloat16), jnp.asarray(ws), jnp.asarray(bs))
    got = _emulate_chain(h, ws, bs, plan)
    assert _rel(got, np.asarray(want.astype(jnp.float32))) <= 2e-2


@pytest.mark.parametrize("B,H,W,sms", EMU)
def test_emulated_tile_matches_lax_resblocks(B, H, W, sms):
    """K1 on the tile's decomposition (2 blocks, conv2 adding into its input
    in place) vs the JAX f32 chain ``_lax_resblocks_f32``
    (resblock_chain.py:139) on the folded layout: relative max error <= 2e-2."""
    rng = np.random.default_rng(B * 10 + W)
    plan = conv_tile_plan(B, H, W, sms=sms)
    h = _bf16(rng.standard_normal((B, 64, H, W)))
    w1 = (rng.standard_normal((2, 64, 64, 3, 3)) * 0.2 * (2 / 576) ** 0.5).astype(np.float32)
    w2 = (rng.standard_normal((2, 64, 64, 3, 3)) * 0.2 * (2 / 576) ** 0.5).astype(np.float32)
    got = _emulate_resblocks(h, w1, w2, plan)
    for b in range(B):
        vf = _fold(jnp.asarray(h[b:b + 1]))
        want = np.asarray(_unfold(_lax_resblocks_f32(vf, jnp.asarray(w1), jnp.asarray(w2))))
        assert _rel(got[b:b + 1], want) <= 2e-2
