"""The launch plans and the arithmetic of the port's wgmma kernels of K2/K3
and K4: the 128-channel 3x3 conv tile (``csrc/conv3x3_c128_wgmma.cuh``, a
cluster of two CTAs that split the output channels) and the 2x2 projections
(``csrc/proj2x2_wgmma.cuh``).

The kernels run only on a GPU; ``chip_smoke.py`` holds them to their plain
versions there. Here, on the CPU, their plans (``conv128_tile_plan``,
``proj_plan``) are checked: every output pixel and channel is covered exactly
once, shared memory fits an SM, no TMA box exceeds 256, and the plans agree
with the headers' constants. The 128-channel tile's ring protocol (multicast
rows, the early release after the dy = 0 group, a slot freed by the consumers
of both CTAs) and the projections' ring are replayed under random
interleavings. The kernels' decompositions (two K-blocks a pixel, shifted
taps, zero halo, one rounding a conv; the up projection's phase scatter and
the skip's down-add epilogue on the (H, W/2, 128) view) are emulated in numpy
and held to the JAX package's ``_lax_sandwich_f32`` and
``_lax_up_resblocks_f32``.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepinv_tpu.ops.pallas.resblock_chain import (_fold, _lax_sandwich_f32,
                                                   _lax_up_resblocks_f32, _unfold)
from deepinv_tpu_torch.ops.kernels.conv_tile import (CLUSTER128, DEPTH128, H100_CLUSTERS128,
                                                     H100_SMS, PROJ_DEPTH, PROJ_KB, PROJ_STRIP,
                                                     SMEM_LIMIT, STRIP128, conv128_tile_plan,
                                                     conv_tile_plan, proj_plan)
from deepinv_tpu_torch.ops.kernels.resblock_chain import pack_weights
from deepinv_tpu_torch.ops.kernels.up_resblock_chain import pack_up_weights
from deepinv_tpu_torch.ops.kernels.up_sandwich import pack_down_weights
from test_torch_conv_tile import replay_ring

CSRC = Path(__file__).resolve().parents[1] / "deepinv_tpu_torch" / "csrc"

# the scale-1 shapes of chip_smoke.py's K4 checks (SANDWICH_SHAPES, B=8, the
# 128-channel tile alone at a ragged two-strip shape), ragged shapes, B up to 16
SHAPES128 = [(1, 128, 128), (2, 128, 128), (1, 20, 28), (8, 128, 128), (1, 70, 100),
             (1, 37, 53), (3, 37, 131)] + [(b, 128, 128) for b in (3, 4, 5, 12, 16)]


def _consts(header: str) -> dict:
    """The ``constexpr int`` constants of a header, evaluated in order."""
    consts = {}
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", (CSRC / header).read_text()):
        consts[name] = int(eval(expr.replace("/", "//"), {}, dict(consts)))
    return consts


def band_of(plan, H: int, unit: int):
    """``(b, x0, y0, rows)`` of band ``unit`` (a cluster of the 128-channel
    tile, a CTA of the 64-channel tile, a CTA's unit of a projection) as the
    kernels compute it: image b, columns x0 .. x0 + strip - 1, rows y0 ..
    y0 + rows - 1."""
    col, band = divmod(unit, plan.bands)
    b, s = divmod(col, plan.strips)
    y0 = band * plan.rows_per_cta
    return b, s * plan.strip, y0, min(plan.rows_per_cta, H - y0)


# ---------------------------------------------------------------- 128-channel plan

def _coverage128(B, H, W, plan):
    seen = np.zeros((B, H, W, 128), np.int32)
    for cta in range(plan.grid):
        unit, rank = divmod(cta, CLUSTER128)
        b, x0, y0, rows = band_of(plan, H, unit)
        assert rows >= 1 and 0 <= b < B and 0 <= y0 < H and 0 <= x0 < W
        seen[b, y0:y0 + rows, x0:min(x0 + plan.strip, W), 64 * rank:64 * rank + 64] += 1
    return seen


@pytest.mark.parametrize("B,H,W", SHAPES128)
def test_plan128_covers_every_pixel_and_channel_once(B, H, W):
    """Bands x strips x the cluster's two halves of the output channels
    cover every output value exactly once; the clusters fit one wave."""
    plan = conv128_tile_plan(B, H, W)
    assert plan.strips == -(-W // STRIP128) and plan.bands == -(-H // plan.rows_per_cta)
    assert plan.grid == CLUSTER128 * B * plan.strips * plan.bands
    assert (_coverage128(B, H, W, plan) == 1).all()
    assert plan.grid // CLUSTER128 <= H100_CLUSTERS128
    if plan.rows_per_cta > 1:   # the band is the shortest that keeps one wave
        assert B * plan.strips * -(-H // (plan.rows_per_cta - 1)) > H100_CLUSTERS128


@pytest.mark.parametrize("B,H,W,clusters", [(1, 7, 100, 3), (40, 3, 70, 16), (1, 1, 1, 66),
                                            (2, 9, 130, 5)])
def test_plan128_covers_on_other_cards(B, H, W, clusters):
    """The same where fewer clusters fit, and where the strips alone exceed
    them (a band is then a whole strip, in several waves)."""
    plan = conv128_tile_plan(B, H, W, clusters=clusters)
    assert (_coverage128(B, H, W, plan) == 1).all()
    if B * plan.strips > clusters:
        assert plan.rows_per_cta == H and plan.grid == CLUSTER128 * B * plan.strips


@pytest.mark.parametrize("B,H,W", SHAPES128)
def test_plan128_shared_memory_and_boxes(B, H, W):
    """Half a layer's weights (144 KB), four ring slots of two K-block boxes
    back to back, two output row-runs and the barriers fit 232,448 bytes
    with no alignment slack; a fifth slot would not; the weights and the
    output buffers stay 1024-byte aligned (the ring's total is a multiple
    of 1024); no TMA box dimension exceeds 256 and each inner extent is one
    128-byte swizzle row."""
    plan = conv128_tile_plan(B, H, W)
    parts = plan.smem_parts()
    assert plan.smem_bytes == sum(parts.values()) <= SMEM_LIMIT and parts["align"] == 0
    assert parts["weights"] == 9 * 64 * 128 * 2 and parts["weights"] % 1024 == 0
    slot = parts["ring"] // plan.depth
    assert slot == 2 * plan.box[0] * plan.box[1] * 2 and parts["ring"] % 1024 == 0
    assert plan.smem_bytes + slot > SMEM_LIMIT
    assert parts["out"] // 2 == plan.out_box[0] * plan.out_box[1] * 2
    for box in (plan.box, plan.out_box, plan.weight_box):
        assert max(box) <= 256 and box[0] * 2 == 128
    assert plan.box[1] == plan.strip + 2 and plan.out_box[1] == plan.strip
    assert plan.depth == DEPTH128 == 4


def test_plan128_matches_header_constants():
    """NPIX, DEPTH, CLUSTER, BOX_W and SMEM_BYTES as conv3x3_c128_wgmma.cuh
    computes them are the plan's (the kernel also checks the plan at launch)."""
    c = _consts("conv3x3_c128_wgmma.cuh")
    plan = conv128_tile_plan(1, 128, 128)
    assert (c["NPIX"], c["DEPTH"], c["CLUSTER"], c["BOX_W"], c["SMEM_BYTES"]) == (
        plan.strip, plan.depth, CLUSTER128, plan.box[1], plan.smem_bytes)
    assert c["CI"] == 2 * 64 and c["KB"] == 2 and c["SMEM_BYTES"] <= SMEM_LIMIT


def test_plan128_rejects_empty_shapes():
    with pytest.raises(ValueError):
        conv128_tile_plan(1, 0, 16)


# ---------------------------------------------------------------- projection plans

def _coverage_proj(plan, B, Hm, Wm, Co):
    """How often each output value is written: "up" writes (B, 2Hm, 2Wm,
    Co), "down_add" (B, Hm, Wm, Co)."""
    up = plan.mode == "up"
    seen = np.zeros((B, 2 * Hm, 2 * Wm, Co) if up else (B, Hm, Wm, Co), np.int32)
    for cta in range(plan.grid):
        unit, g = divmod(cta, plan.groups)
        b, x0, y0, rows = band_of(plan, Hm, unit)
        assert rows >= 1 and 0 <= b < B and 0 <= x0 < Wm
        for y in range(y0, y0 + rows):
            if up:   # group (ph, 64 channels); the two warpgroups: pw = 0, 1
                ph, co0 = g % 2, 64 * (g // 2)
                for pw in (0, 1):
                    xs = 2 * np.arange(x0, min(x0 + plan.strip, Wm)) + pw
                    seen[b, 2 * y + ph, xs, co0:co0 + 64] += 1
            else:    # group of 128 channels; the two warpgroups: its halves
                seen[b, y, x0:min(x0 + plan.strip, Wm), 128 * g:128 * g + 128] += 1
    return seen


# (mode, B, Hm, Wm, K, Co): K2/K3's projection and K4's up2, skip and up1 at
# the smoke shapes (B=1, 2, 8) and ragged ones
PROJ_CASES = ([("up", b, 128, 128, 128, 64) for b in (1, 2, 8)]
              + [("up", b, 64, 64, 256, 128) for b in (1, 8)]
              + [("down_add", b, 128, 128, 256, 128) for b in (1, 8)]
              + [("up", 1, 128, 128, 128, 64), ("up", 1, 10, 14, 128, 64),
                 ("up", 1, 10, 14, 256, 128), ("down_add", 1, 20, 28, 256, 128),
                 ("up", 2, 5, 70, 48, 64), ("down_add", 3, 7, 100, 256, 256)]
              # inputs past 256 channels: the weights stream in chunks of 256
              + [("up", 1, 10, 14, 272, 64), ("up", 2, 5, 70, 512, 128)])


@pytest.mark.parametrize("mode,B,Hm,Wm,K,Co", PROJ_CASES)
def test_proj_plan_covers_every_output_once(mode, B, Hm, Wm, K, Co):
    """Every output value (both pw phases of both ph rows for "up", every
    output pixel for "down_add") in every channel is written exactly once;
    the grid is one wave; the K-blocks cover K."""
    plan = proj_plan(mode, B, Hm, Wm, K, Co)
    assert plan.grid == plan.groups * B * plan.strips * plan.bands <= H100_SMS
    assert plan.kb * 64 >= K > (plan.kb - 1) * 64
    assert (_coverage_proj(plan, B, Hm, Wm, Co) == 1).all()


@pytest.mark.parametrize("mode,B,Hm,Wm,K,Co", PROJ_CASES[:7])
def test_proj_plan_shared_memory_and_boxes(mode, B, Hm, Wm, K, Co):
    """Weights (two slices of up to four 64 x 64 boxes), four ring slots of
    four boxes, two output buffers of 128 pixels x 64 channels and the
    barriers fit 232,448 bytes, each part 1024-byte aligned; no TMA box
    dimension exceeds 256 (an "up" output row-run is 2 x 64 pixels)."""
    plan = proj_plan(mode, B, Hm, Wm, K, Co)
    parts = plan.smem_parts()
    assert plan.smem_bytes == sum(parts.values()) <= SMEM_LIMIT
    assert all(v % 1024 == 0 for k, v in parts.items() if k != "barriers")
    for box in (plan.box, plan.out_box, plan.weight_box):
        assert max(box) <= 256 and box[0] * 2 == 128
    assert plan.out_box[1] == (2 if mode == "up" else 1) * plan.strip
    assert parts["out"] >= 2 * plan.out_box[0] * plan.out_box[1] * 2


def test_proj_plan_matches_header_constants():
    """The plan's constants are the header's, at every K (the shared memory
    does not depend on it); the streamed stages of an input past 256
    channels (a chunk's two weight slices and its input boxes each) fill the
    resident weights' and the ring's space, at least two of them."""
    c = _consts("proj2x2_wgmma.cuh")
    for K in (128, 256, 272, 512):
        plan = proj_plan("up", 1, 128, 128, K, 64)
        assert (c["NPIX"], c["DEPTH"], c["KB_MAX"], c["SMEM_BYTES"]) == (
            PROJ_STRIP, PROJ_DEPTH, PROJ_KB, plan.smem_bytes)
    parts = plan.smem_parts()
    assert c["STAGE_BYTES"] == parts["weights"] + parts["ring"] // PROJ_DEPTH
    assert 2 <= c["SDEPTH"] and c["SDEPTH"] * c["STAGE_BYTES"] <= parts["weights"] + parts["ring"]
    assert c["STAGE_BYTES"] % 1024 == 0


@pytest.mark.parametrize("args", [("up", 1, 4, 4, 24, 64), ("up", 1, 4, 4, 0, 64),
                                  ("up", 1, 4, 4, 128, 96), ("down_add", 1, 4, 4, 128, 128),
                                  ("down_add", 1, 4, 4, 256, 64), ("side", 1, 4, 4, 64, 64),
                                  ("up", 1, 0, 4, 64, 64)])
def test_proj_plan_rejects_what_the_kernel_does_not_take(args):
    with pytest.raises(ValueError):
        proj_plan(*args)


# ---------------------------------------------------------------- ring protocols

@pytest.mark.parametrize("rows", [1, 2, 3, 4, 5, 6, 7, 13, 32])
def test_ring128_protocol_never_stalls_or_overwrites(rows):
    """The kernel's protocol at its ring depth and at 3 slots, the fewest it
    can run with."""
    rng = np.random.default_rng(100 + rows)
    for depth in (DEPTH128, 3):
        for _ in range(25):
            replay_ring(rows, rng, CLUSTER128, depth, early=True)


@pytest.mark.parametrize("protocol,fault", [("no_wait", "too early"),
                                            ("wait_no_release", "stalled")])
def test_ring128_replay_catches_the_faulty_protocols(protocol, fault):
    """In a ring of 3 slots (where the card showed the fault), without
    warpgroup 1's wait for load 0 its first row's parity wait for load 3
    (slot 0) can pass while load 0 is still in flight, and the row reads the
    slot too early. With the wait but without its release, load 3 can land
    first, and the parity wait for load 0 then blocks until load 6, which
    never comes: a stall."""
    rng = np.random.default_rng(5)
    with pytest.raises(AssertionError, match=fault):
        for _ in range(300):
            replay_ring(8, rng, CLUSTER128, 3, early=True, protocol=protocol)


def _replay_ring_proj(rows: int, rng, depth: int = PROJ_DEPTH) -> None:
    """The projections' ring for a band of ``rows`` steps (row-runs, or a
    wide input's chunks of row-runs in ``depth`` streamed stages): the
    producer issues step i into slot i % depth once both warpgroups (4 warps
    each) have released step i - depth; each warpgroup reads every step in
    order and releases it when its products retire."""
    issued, released, nxt = 0, [0] * rows, [0, 0]
    while True:
        moves = []
        if issued < rows and (issued < depth or released[issued - depth] == 8):
            moves.append("p")
        moves += [q for q in (0, 1) if nxt[q] < rows and nxt[q] < issued]
        if not moves:
            break
        m = moves[rng.integers(len(moves))]
        if m == "p":
            issued += 1
            continue
        r = nxt[m]
        assert issued <= r + depth   # the slot still holds step r
        released[r] += 4
        nxt[m] += 1
    assert issued == rows and nxt == [rows, rows] and all(v == 8 for v in released)


@pytest.mark.parametrize("rows", [1, 3, 4, 5, 9, 32])
def test_proj_ring_protocol_never_stalls_or_overwrites(rows):
    """At the ring's depth, and at the streamed stages' (two chunks a
    row-run of a 512-channel input)."""
    rng = np.random.default_rng(200 + rows)
    sdepth = _consts("proj2x2_wgmma.cuh")["SDEPTH"]
    for _ in range(30):
        _replay_ring_proj(rows, rng)
        _replay_ring_proj(2 * rows, rng, sdepth)


# ---------------------------------------------------------------- emulations

def _bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.bfloat16).float().numpy()


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


def emulate_conv(x, wpk, plan, halves: int, relu: bool, residual=None):
    """One 3x3 conv as the wgmma tiles compute it, numpy with f32 sums: x
    NHWC (bf16 values, 64 halves channels), wpk one layer packed
    [(co // 64) 9 + tap][co % 64][ci]. For each band (a cluster of the
    128-channel tile, halves = 2; a CTA of the 64-channel tile, halves = 1),
    each CTA rank (its 64 output channels) and each row: the haloed ring row
    as K-blocks of 64 channels (zero outside the image), D[co, n] = sum over
    taps and K-blocks of A[tap, kb] @ ring[dy][kb][n + dx]^T, the epilogue,
    one bf16 rounding, stored where x < W."""
    B, H, W, C = x.shape
    out = np.full_like(x, np.nan)
    kbs = C // 64
    for unit in range(plan.grid // halves):
        b, x0, y0, rows = band_of(plan, H, unit)
        n = min(plan.strip, W - x0)
        for rank in range(halves):
            co = slice(64 * rank, 64 * rank + 64)
            for y in range(y0, y0 + rows):
                ring = np.zeros((3, kbs, plan.strip + 2, 64), np.float32)
                for dy in range(3):
                    yy = y + dy - 1
                    if 0 <= yy < H:
                        lo, hi = max(x0 - 1, 0), min(x0 + plan.strip + 1, W)
                        for kb in range(kbs):
                            ring[dy, kb, lo - (x0 - 1):hi - (x0 - 1)] = \
                                x[b, yy, lo:hi, 64 * kb:64 * kb + 64]
                d = np.zeros((64, plan.strip), np.float32)
                for tap in range(9):
                    dy, dx = divmod(tap, 3)
                    a = wpk[9 * rank + tap]
                    for kb in range(kbs):
                        d += a[:, 64 * kb:64 * kb + 64] @ ring[dy, kb, dx:dx + plan.strip].T
                v = d[:, :n].T
                if residual is not None:
                    v = v + residual[b, y, x0:x0 + n, co]
                elif relu:
                    v = np.where(v < 0, 0, v)
                out[b, y, x0:x0 + n, co] = _bf16(v)
    assert not np.isnan(out).any()
    return out


def emulate_resblocks(a, w1, w2, plan, halves):
    p1, p2 = (pack_weights(torch.from_numpy(w)).float().numpy() for w in (w1, w2))
    for r in range(w1.shape[0]):
        a = emulate_conv(emulate_conv(a, p1[r], plan, halves, relu=True), p2[r], plan, halves,
                         relu=False, residual=a)
    return a


def emulate_up(src, wpk, plan):
    """The up projection as ``proj2x2_wgmma`` (kUp) computes it: for each CTA
    (group (ph, co0)) and input row-run, the K-blocks of 64 channels (zero
    past K and past the width), warpgroup pw's 64 x 64 product with its
    weight slice, summed in f32 over chunks of PROJ_KB K-blocks, scattered to pixels 2 n + pw of one 2 x 64-pixel output
    row-run of row 2 y + ph, one bf16 rounding, the run stored where it lies
    in the image."""
    B, Hm, Wm, K = src.shape
    Co = wpk.shape[0] // 4
    out = np.full((B, 2 * Hm, 2 * Wm, Co), np.nan, np.float32)
    kk = 64 * plan.kb
    for cta in range(plan.grid):
        unit, g = divmod(cta, plan.groups)
        b, x0, y0, rows = band_of(plan, Hm, unit)
        ph, co0 = g % 2, 64 * (g // 2)
        n = min(plan.strip, Wm - x0)
        for y in range(y0, y0 + rows):
            bm = np.zeros((kk, plan.strip), np.float32)
            bm[:K, :n] = src[b, y, x0:x0 + n].T
            run = np.full((2 * plan.strip, 64), np.nan, np.float32)
            for pw in (0, 1):
                a = np.zeros((64, kk), np.float32)
                a[:, :K] = wpk[(ph * 2 + pw) * Co + co0:(ph * 2 + pw) * Co + co0 + 64]
                d = np.zeros((64, plan.strip), np.float32)
                for k0 in range(0, kk, 64 * PROJ_KB):
                    d += a[:, k0:k0 + 64 * PROJ_KB] @ bm[k0:k0 + 64 * PROJ_KB]
                run[pw::2] = _bf16(d.T)
            out[b, 2 * y + ph, 2 * x0:2 * x0 + 2 * n, co0:co0 + 64] = run[:2 * n]
    assert not np.isnan(out).any()
    return out


def emulate_down_add(d0, wpk, dst, plan):
    """The skip as ``proj2x2_wgmma`` (kDownAdd) computes it: d0 (B, 2Hm, 2Wm,
    64) read as (B, 2Hm, Wm, 128); output row y's K = 256 is K-blocks (view
    row 2y + k // 2, channels 64 (k % 2) ..), in the packed weight's column
    order; warpgroup q of group g adds its 64 channels' product to the
    residual row-run and rounds once."""
    B, Hm, Wm, Co = dst.shape
    view = d0.reshape(B, 2 * Hm, Wm, 128)
    out = np.full_like(dst, np.nan)
    for cta in range(plan.grid):
        unit, g = divmod(cta, plan.groups)
        b, x0, y0, rows = band_of(plan, Hm, unit)
        n = min(plan.strip, Wm - x0)
        for y in range(y0, y0 + rows):
            bm = np.zeros((256, plan.strip), np.float32)
            for k in range(4):
                bm[64 * k:64 * k + 64, :n] = view[b, 2 * y + k // 2, x0:x0 + n,
                                                  64 * (k % 2):64 * (k % 2) + 64].T
            for q in (0, 1):
                co = slice(64 * (2 * g + q), 64 * (2 * g + q) + 64)
                v = (wpk[co] @ bm).T[:n] + dst[b, y, x0:x0 + n, co]
                out[b, y, x0:x0 + n, co] = _bf16(v)
    assert not np.isnan(out).any()
    return out


def _packed(fn, w):
    return fn(torch.from_numpy(w)).float().numpy()


def _n(rng, shape, s=1.0):
    return (rng.standard_normal(shape) * s).astype(np.float32)


# (B, H2, W2, Ci2, SMs, clusters): scale 1 is 2x, scale 0 4x; two strips at
# scale 1 (64 + ragged) and at scale 0 (128 + ragged), bands of several rows
# with a short last one on a card of few SMs
SANDWICH_EMU = [(1, 4, 36, 64, 6, 6), (1, 5, 40, 48, 4, 8), (1, 4, 36, 272, 6, 6)]


@pytest.mark.parametrize("B,H2,W2,Ci2,sms,clusters", SANDWICH_EMU)
def test_emulated_sandwich_matches_lax_sandwich(B, H2, W2, Ci2, sms, clusters):
    """K4 on its wgmma kernels' decompositions: up2 (phase scatter), R1 = 2
    scale-1 blocks on the 128-channel cluster tile (two K-blocks, two
    output-channel halves), the skip's down-add on the (H, W/2, 128) view,
    up1, R0 = 2 scale-0 blocks on the 64-channel tile; against the JAX f32
    reference ``_lax_sandwich_f32`` (resblock_chain.py:510): relative max
    error <= 2e-2 (chip_smoke.py's KERNEL_RTOL)."""
    rng = np.random.default_rng(W2 + Ci2)
    H1, W1 = 2 * H2, 2 * W2
    s2 = _bf16(_n(rng, (B, H2, W2, Ci2)))
    d0 = _bf16(_n(rng, (B, 64, 4 * H2, 4 * W2)))
    ws = (_n(rng, (Ci2, 128, 2, 2), 0.1), _n(rng, (2, 128, 128, 3, 3), 0.03),
          _n(rng, (2, 128, 128, 3, 3), 0.03), _n(rng, (128, 64, 2, 2), 0.05),
          _n(rng, (128, 64, 2, 2), 0.1), _n(rng, (2, 64, 64, 3, 3), 0.05),
          _n(rng, (2, 64, 64, 3, 3), 0.05))
    wb = [_bf16(w) for w in ws]
    p_up2 = proj_plan("up", B, H2, W2, Ci2, 128, sms)
    p1 = conv128_tile_plan(B, H1, W1, clusters)
    p_down = proj_plan("down_add", B, H1, W1, 256, 128, sms)
    p_up1 = proj_plan("up", B, H1, W1, 128, 64, sms)
    p0 = conv_tile_plan(B, 4 * H2, 4 * W2, sms)
    assert p1.strips == 2 and p1.rows_per_cta > 1 and H1 % p1.rows_per_cta
    assert p0.strips == 2 and p_up1.strips == 2 and p_down.rows_per_cta > 1

    a1 = emulate_up(s2, _packed(pack_up_weights, wb[0]), p_up2)
    a1 = emulate_resblocks(a1, wb[1], wb[2], p1, halves=2)
    a1 = emulate_down_add(d0.transpose(0, 2, 3, 1), _packed(pack_down_weights, wb[3]), a1, p_down)
    a0 = emulate_up(a1, _packed(pack_up_weights, wb[4]), p_up1)
    got = emulate_resblocks(a0, wb[5], wb[6], p0, halves=1).transpose(0, 3, 1, 2)
    for b in range(B):
        want = _unfold(_lax_sandwich_f32(jnp.asarray(s2[b:b + 1]), _fold(jnp.asarray(d0[b:b + 1])),
                                         *(jnp.asarray(w) for w in wb)))
        assert _rel(got[b:b + 1], np.asarray(want)) <= 2e-2


@pytest.mark.parametrize("B,H2,W2,Ci,sms", [(1, 4, 70, 128, 8), (2, 3, 20, 48, 4),
                                             (1, 3, 20, 272, 4)])
def test_emulated_up_chain_matches_lax_up_resblocks(B, H2, W2, Ci, sms):
    """K2/K3 on its wgmma kernels: the up projection (K-blocks of 64, the
    last zero-filled where Ci is not a multiple of 64, in chunks of four
    past 256 channels; two pw warpgroups
    filling one output row-run) and R = 2 blocks on the 64-channel tile,
    against ``_lax_up_resblocks_f32`` (resblock_chain.py:270): relative max
    error <= 2e-2."""
    rng = np.random.default_rng(Ci + W2)
    v = _bf16(_n(rng, (B, H2, W2, Ci)))
    wu = _bf16(_n(rng, (Ci, 64, 2, 2), (2 / (4 * Ci)) ** 0.5))
    w1 = _bf16(_n(rng, (2, 64, 64, 3, 3), 0.2 * (2 / 576) ** 0.5))
    w2 = _bf16(_n(rng, (2, 64, 64, 3, 3), 0.2 * (2 / 576) ** 0.5))
    pp = proj_plan("up", B, H2, W2, Ci, 64, sms)
    pc = conv_tile_plan(B, 2 * H2, 2 * W2, sms)
    a = emulate_up(v, _packed(pack_up_weights, wu), pp)
    got = emulate_resblocks(a, w1, w2, pc, halves=1).transpose(0, 3, 1, 2)
    for b in range(B):
        want = _unfold(_lax_up_resblocks_f32(jnp.asarray(v[b:b + 1]), jnp.asarray(wu),
                                             jnp.asarray(w1), jnp.asarray(w2)))
        assert _rel(got[b:b + 1], np.asarray(want)) <= 2e-2


def test_emulated_tile128_taps_and_kblocks_alone():
    """Each tap and each K-block of the 128-channel tile alone (one nonzero
    64 x 64 block of the weight) at a ragged two-strip shape with a short
    last band: the emulated conv equals the plain conv of the same bf16
    values to a bf16 rounding."""
    rng = np.random.default_rng(7)
    B, H, W = 1, 7, 100
    plan = conv128_tile_plan(B, H, W, clusters=4)
    assert plan.strips == 2 and plan.rows_per_cta > 1 and H % plan.rows_per_cta
    x = _bf16(_n(rng, (B, H, W, 128)))
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2))
    for tap in range(9):
        for kb in range(2):
            w = np.zeros((1, 128, 128, 3, 3), np.float32)
            w[0, :, 64 * kb:64 * kb + 64, tap // 3, tap % 3] = _bf16(_n(rng, (128, 64), 0.1))
            got = emulate_conv(x, _packed(pack_weights, w)[0], plan, 2, relu=False,
                               residual=np.zeros_like(x))
            want = torch.nn.functional.conv2d(xt, torch.from_numpy(w[0]), padding=1)
            assert _rel(got.transpose(0, 3, 1, 2), want.numpy()) <= 1e-2, (tap, kb)
