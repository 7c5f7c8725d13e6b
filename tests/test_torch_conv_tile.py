"""The launch plan of the port's 64-channel wgmma conv tile (K1 and K5).

The kernel (``deepinv_tpu_torch/csrc/conv3x3_wgmma.cuh``) runs only on a GPU;
``chip_smoke.py`` holds it to its plain version there. Here, on the CPU, the
plan it is launched with (``conv_tile_plan``) is checked: the strips and
bands cover every output pixel exactly once, shared memory fits an SM, no
TMA box exceeds 256, and the plan agrees with the header's constants. The
conv tiles' ring protocol (which warpgroup waits for and releases which
input row, with parity waits and loads landing out of order; the
128-channel tile's file replays its cluster with :func:`replay_ring`) is
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


def replay_ring(rows: int, rng, cluster: int = 1, depth: int = DEPTH, early: bool = False,
                protocol: str = "kernel", late: tuple = ()) -> None:
    """The conv tiles' ring for one band of ``rows`` output rows in a ring of
    ``depth`` slots, one random interleaving of the producers and consumer
    warpgroups of a ``cluster`` of CTAs, with the mbarriers' phase-parity
    waits and TMA writes that land in any order. The 64-channel tile
    (``conv3x3_wgmma.cuh``) is one CTA whose ring row is one box; the
    128-channel tile (``conv3x3_c128_wgmma.cuh``) a cluster of two whose ring
    row is two K-block halves, CTA p loading half p into both (multicast).

    Producer p issues load i (input row y0 - 1 + i) once its CTA's empty
    barrier of slot i % depth has completed the phase of load i - depth (a
    parity wait); a CTA's full barrier completes a phase when all halves of
    the load are in. Warpgroup q of each CTA computes rows q, q + 2, ...: it
    starts a row once its parity waits on loads r, r + 1, r + 2 pass, and
    releases loads r and r + 1 in every CTA of the cluster (4 warps each),
    load r when its dy = 0 group retires if ``early`` (the 128-channel tile)
    or with load r + 1 when the row retires. Before its first row,
    warpgroup 1 waits for load 0 and releases it (for the absent row above
    the band). Checks: a row finds in its slots the loads it reads, and they
    stay there until it releases them; an empty phase completes on the
    releases of its own load; the band ends. The loads in ``late`` land only
    when nothing else can move. ``protocol`` "no_wait"
    (warpgroup 0 releases load 0 twice instead) and "wait_no_release"
    (warpgroup 1 waits for load 0 but warpgroup 0 releases it twice) are the
    two faulty versions the tests show the replay catching."""
    D, loads, count = depth, rows + 2, cluster * 2 * 4
    slots = [[[None] * cluster for _ in range(D)] for _ in range(cluster)]
    full_done = [[0] * D for _ in range(cluster)]      # completed phases
    empty_done = [[0] * D for _ in range(cluster)]
    empty_arrivals = [[0] * D for _ in range(cluster)]
    released = [[0] * loads for _ in range(cluster)]   # arrivals for each load
    issued = [0] * cluster
    flying = []                           # (CTA, half, load): TMA writes not yet landed
    wgs = {(c, q): {"row": q, "stage": "idle" if q == 0 or protocol == "no_wait" else "w0"}
           for c in range(cluster) for q in (0, 1)}

    def passes(done, i):   # try_wait.parity on the phase of load i (phase i // D of its slot)
        return (done[i % D] & 1) != ((i // D) & 1)

    def holds(c, i):
        return slots[c][i % D] == [i] * cluster

    def release(i):
        for c in range(cluster):
            released[c][i] += 4
            empty_arrivals[c][i % D] += 4
            assert released[c][i] <= count, f"load {i} released too often"
            if empty_arrivals[c][i % D] == count:
                # the phase that completes is that of load i: no mixing of loads
                assert empty_done[c][i % D] == i // D and released[c][i] == count
                empty_done[c][i % D] += 1
                empty_arrivals[c][i % D] = 0

    def release_top(r):   # load r, which no later row of the warpgroup reads
        release(r)
        if r == 0 and protocol != "kernel":
            release(0)

    while True:
        moves = [("land", k) for k, f in enumerate(flying) if f[2] not in late]
        for p in range(cluster):
            i = issued[p]
            if i < loads and (i < D or passes(empty_done[p], i - D)):
                moves.append(("p", p))
        for key, st in wgs.items():
            r = st["row"]
            if r >= rows:
                continue
            if st["stage"] == "w0" and passes(full_done[key[0]], 0):
                moves.append(("w0", key))
            elif st["stage"] == "idle" and all(passes(full_done[key[0]], r + k)
                                               for k in range(3)):
                moves.append(("start", key))
            elif st["stage"] in ("busy", "dy0"):
                moves.append(("step", key))
        if not moves:
            moves = [("land", k) for k in range(len(flying))]
        if not moves:
            break
        kind, who = moves[rng.integers(len(moves))]
        if kind == "p":   # half `who` of load i to every CTA of the cluster, in flight
            flying += [(c, who, issued[who]) for c in range(cluster)]
            issued[who] += 1
            continue
        if kind == "land":   # TMA writes land in any order
            c, half, i = flying.pop(who)
            old = slots[c][i % D][half]   # the slot's old load must be released in this CTA
            assert old is None or released[c][old] == count, "slot overwritten early"
            slots[c][i % D][half] = i
            if holds(c, i):   # all halves in: the full barrier's phase of load i completes
                assert full_done[c][i % D] == i // D
                full_done[c][i % D] += 1
            continue
        c, q = who
        st = wgs[who]
        r = st["row"]
        if kind == "w0":               # warpgroup 1 has seen load 0's phase complete
            assert full_done[c][0] == 1, "the wait for load 0 passed on another phase"
            if protocol == "kernel":
                release(0)
            st["stage"] = "idle"
        elif kind == "start":
            assert all(holds(c, r + k) for k in range(3)), f"row {r} read a slot too early"
            st["stage"] = "busy"
        elif st["stage"] == "busy":   # the dy = 0 group retired
            assert holds(c, r) and holds(c, r + 1) and holds(c, r + 2)
            if early:
                release_top(r)
            st["stage"] = "dy0"
        else:                          # the row retired: load r + 1 is free
            assert holds(c, r + 1) and holds(c, r + 2) and (early or holds(c, r))
            if not early:
                release_top(r)
            release(r + 1)
            st["row"], st["stage"] = r + 2, "idle"
    assert issued == [loads] * cluster and not flying, \
        f"a producer stalled: {issued} of {loads}"
    assert all(st["row"] >= rows for st in wgs.values()), "a consumer stalled"
    # every load but the band's last two is released by all warps of the cluster
    assert all(released[c][i] == count for c in range(cluster) for i in range(max(rows - 1, 0)))


@pytest.mark.parametrize("rows", [1, 2, 3, 4, 5, 6, 7, 8, 13, 32, 64])
def test_ring_protocol_never_stalls_or_overwrites(rows):
    """The 64-channel tile's protocol (one CTA, DEPTH = 7 slots, both
    releases when the row retires), also with load 0 landing last."""
    rng = np.random.default_rng(rows)
    for k in range(30):
        replay_ring(rows, rng, late=(0,) if k % 2 else ())


@pytest.mark.parametrize("protocol,fault", [("no_wait", "too early"),
                                            ("wait_no_release", "stalled")])
def test_ring_replay_catches_the_faulty_protocols(protocol, fault):
    """At the 64-channel tile's 7 slots too: without warpgroup 1's wait for
    load 0, its row 5 waits for load 7 (slot 0, phase 1), which passes while
    load 0 is still in flight (here it lands last), and the row reads the
    slot too early. With the wait but without its release, load 7 can land
    first, and the parity wait for load 0 then blocks until load 14, which
    never comes: a stall."""
    rng = np.random.default_rng(5)
    with pytest.raises(AssertionError, match=fault):
        for _ in range(300):
            replay_ring(8, rng, protocol=protocol, late=(0,) if protocol == "no_wait" else ())


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
