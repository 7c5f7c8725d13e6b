"""The launch plan of the port's 64-channel wgmma conv tile (K1 and K5).

The kernel (``deepinv_tpu_torch/csrc/conv3x3_wgmma.cuh``) runs only on a GPU;
``chip_smoke.py`` and ``test_torch_conv_tile_card.py`` hold it to its plain
version there. Here, on the CPU, the plan it is launched with
(``conv_tile_plan``) is checked in both its forms, the bands and the
balanced schedule: every output pixel is computed exactly once, shared
memory fits an SM, no TMA box exceeds 256, the plan agrees with the
header's constants, and the balanced schedule is taken only where it keeps
more of the SMs' time useful. The conv tiles' ring protocol (which
warpgroup waits for and releases which input row, with parity waits and
loads landing out of order, over a CTA's segments; the 128-channel tile's
file replays its cluster with :func:`replay_ring`) is replayed under random
interleavings, and the tile's arithmetic (output channels x pixels, one tap
a shifted row, zero-filled halo, the narrow product on a strip of at most
64 columns, one rounding per conv) is emulated in numpy segment by segment
and held to the JAX package's chains.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepinv_tpu.ops.pallas.conv_chain import _lax_chain
from deepinv_tpu.ops.pallas.resblock_chain import _fold, _lax_resblocks_f32, _unfold
from deepinv_tpu_torch.ops.kernels.conv_tile import (BALANCE_ABOVE, DEPTH, FULL_COST, H100_SMS,
                                                     NARROW, NARROW_COST, SMEM_LIMIT, STRIP,
                                                     _banded_plan, conv_tile_plan, tile_runs,
                                                     useful_share)
from deepinv_tpu_torch.ops.kernels.resblock_chain import pack_weights, tile_args

HEADER = Path(__file__).resolve().parents[1] / "deepinv_tpu_torch" / "csrc" / "conv3x3_wgmma.cuh"

# chip_smoke.py's KERNEL_SHAPES and CHAIN_SHAPES (and the B=8 shape of its
# phase 3), a ragged 37x53, B = 1 .. 16 at 256², MRI's 320² (2.5 strips) at
# B = 1, 8, 16, DnCNN's 50² training patches and a ragged 37x200
SMOKE = [(1, 256, 256), (2, 256, 256), (1, 40, 56), (8, 256, 256)]
SHAPES = (SMOKE + [(1, 37, 53), (3, 37, 53)]
          + [(b, 256, 256) for b in (3, 4, 5, 6, 7, 9, 10, 11, 12, 13, 14, 15, 16)]
          + [(16, 320, 320), (8, 320, 320), (1, 320, 320), (16, 50, 50), (128, 50, 50),
             (3, 37, 200)])
# the banded plan's rows_per_cta at 256², B = 1 .. 16, before the balanced schedule
BANDED_256 = dict(enumerate((4, 8, 12, 16, 20, 24, 29, 32, 37, 43, 43, 52, 52, 64, 64, 64), 1))


def band_of(plan, B: int, H: int, W: int, cta: int, narrow: bool = True):
    """The ``(b, x0, y0, rows)`` segments of CTA ``cta``, in order, as the
    kernel computes them (``conv3x3_wgmma.cuh``: ``cta_range``,
    ``balanced_start``, ``next_segment``): image b, columns x0 .. x0 + strip
    - 1 (clipped at W), rows y0 .. y0 + rows - 1. Row-run u is row u % H of
    column u / H, column c strip c % strips of image c / strips; a band is
    one segment, a balanced range may cross columns."""
    strips = -(-W // STRIP)

    def balanced_start(i):
        last = NARROW_COST if narrow and W - (strips - 1) * STRIP <= NARROW else FULL_COST
        per_image = H * (FULL_COST * (strips - 1) + last)
        b, rem = divmod(B * per_image * i // plan.grid, per_image)
        s = min(rem // (FULL_COST * H), strips - 1)
        c = last if s == strips - 1 else FULL_COST
        return (b * strips + s) * H + (rem - s * FULL_COST * H + c - 1) // c

    if plan.rows_per_cta > 0:
        bands = -(-H // plan.rows_per_cta)
        y0 = cta % bands * plan.rows_per_cta
        u0 = cta // bands * H + y0
        u1 = u0 + min(plan.rows_per_cta, H - y0)
    else:
        u0, u1 = balanced_start(cta), balanced_start(cta + 1)
    segments = []
    while u0 < u1:
        col, y0 = divmod(u0, H)
        n = min(H - y0, u1 - u0)
        segments.append((col // strips, col % strips * STRIP, y0, n))
        u0 += n
    return segments


def _coverage(B, H, W, plan, narrow=True):
    """How often each output pixel lies in a CTA's segment, in the launches
    that take the narrow product (``narrow``) or in kMaskDb's, which do not."""
    seen = np.zeros((B, H, W), np.int32)
    for cta in range(plan.grid):
        segments = band_of(plan, B, H, W, cta, narrow)
        # the kernel's map is the module's
        assert segments == tile_runs(plan, B, H, W, cta, narrow)
        for b, x0, y0, rows in segments:
            assert rows >= 1 and 0 <= b < B and 0 <= y0 < H and 0 <= x0 < W
            seen[b, y0:y0 + rows, x0:min(x0 + plan.strip, W)] += 1
    return seen


@pytest.mark.parametrize("B,H,W", SHAPES)
def test_plan_covers_every_pixel_once(B, H, W):
    """Every output pixel lies in exactly one CTA's segment, no CTA of the
    banded plan is empty, and the grid is one wave of at most 132 CTAs. The
    plan keeps the banded plan wherever that keeps BALANCE_ABOVE of the SMs'
    time useful (at 256² that is today's plan, field for field, at every B
    but 10, 12, 14 and 15), and its useful share is never below the
    banded plan's; at MRI's 16 x 320² it lifts 60.6% to at least 80%."""
    plan, banded = conv_tile_plan(B, H, W), _banded_plan(B, H, W, H100_SMS)
    share, banded_share = useful_share(plan, B, H, W), useful_share(banded, B, H, W)
    assert plan.strips == -(-W // STRIP)
    assert (_coverage(B, H, W, plan) == 1).all() and (_coverage(B, H, W, plan, False) == 1).all()
    assert plan.grid <= H100_SMS and share >= banded_share
    if plan.balanced:
        assert banded_share < BALANCE_ABOVE and plan.bands == 0
        assert plan.grid == min(H100_SMS, B * plan.strips * H)
    else:
        assert plan == banded and plan.grid == B * plan.strips * plan.bands
        assert plan.bands == -(-H // plan.rows_per_cta)
        assert all(tile_runs(plan, B, H, W, cta) for cta in range(plan.grid))
        # the band is the shortest that keeps one wave
        if plan.rows_per_cta > 1:
            assert B * plan.strips * -(-H // (plan.rows_per_cta - 1)) > H100_SMS
    if (H, W) == (256, 256):
        assert banded.rows_per_cta == BANDED_256[B]
        keeps = B not in (10, 12, 14, 15)
        assert (plan == banded) == (banded_share >= BALANCE_ABOVE) == keeps
    if (B, H, W) == (16, 320, 320):
        assert round(banded_share, 3) == 0.606 and plan.balanced and share >= 0.80


@pytest.mark.parametrize("B,H,W,sms", [(1, 7, 150, 6), (2, 9, 300, 5), (40, 3, 130, 16),
                                       (1, 1, 1, 132), (300, 20, 50, 132)])
def test_plan_covers_on_other_cards(B, H, W, sms):
    """The same on cards of few SMs, and where the strips alone exceed the
    SMs (then a band is a whole strip, in several waves, unless the
    balanced schedule's one wave does better)."""
    plan = conv_tile_plan(B, H, W, sms=sms)
    assert (_coverage(B, H, W, plan) == 1).all() and plan.grid <= max(sms, B * plan.strips)
    if B * plan.strips > sms and not plan.balanced:
        assert plan.rows_per_cta == H and plan.grid == B * plan.strips
    banded = _banded_plan(B, H, W, sms)
    assert useful_share(plan, B, H, W, sms) >= useful_share(banded, B, H, W, sms)


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
    assert consts["NARROW"] == NARROW and consts["SMEM_BYTES"] == plan.smem_bytes
    assert (consts["FULL_COST"], consts["NARROW_COST"]) == (FULL_COST, NARROW_COST)
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


def replay_ring(rows, rng, cluster: int = 1, depth: int = DEPTH, early: bool = False,
                protocol: str = "kernel", late: tuple = ()) -> None:
    """The conv tiles' ring for a CTA's ``rows`` output rows (an int: one
    band; a tuple: the rows of each segment of a balanced range, in order) in
    a ring of ``depth`` slots, one random interleaving of the producers and
    consumer warpgroups of a ``cluster`` of CTAs, with the mbarriers'
    phase-parity waits and TMA writes that land in any order. The 64-channel
    tile (``conv3x3_wgmma.cuh``) is one CTA whose ring row is one box; the
    128-channel tile (``conv3x3_c128_wgmma.cuh``) a cluster of two whose ring
    row is two K-block halves, CTA p loading half p into both (multicast).

    Producer p issues the loads of each segment of n rows (input rows y0 - 1
    .. y0 + n, n + 2 loads), numbered on over the segments; load i once its
    CTA's empty barrier of slot i % depth has completed the phase of load i
    - depth (a parity wait); a CTA's full barrier completes a phase when all
    halves of the load are in. Warpgroup q of each CTA computes the CTA's
    rows q, q + 2, ... counted over the segments: a row whose top input row
    is load i starts once its parity waits on loads i, i + 1, i + 2 pass, and
    releases loads i and i + 1 in every CTA of the cluster (4 warps each),
    load i when its dy = 0 group retires if ``early`` (the 128-channel tile)
    or with load i + 1 when the row retires. Before a row it waits for and
    releases, in order, each load it has not released (load 0, the absent
    row above the band, for warpgroup 1; the last rows of a previous
    segment). Checks: a row finds in its slots the loads it reads, and they
    stay there until it releases them; an empty phase completes on the
    releases of its own load; the range ends. The loads in ``late`` land only
    when nothing else can move. ``protocol`` "no_wait"
    (warpgroup 0 releases load 0 twice instead), "wait_no_release"
    (warpgroup 1 waits for load 0 but warpgroup 0 releases it twice) and
    "no_skip" (the loads of a previous segment that a warpgroup does not
    read are never released) are the faulty versions the tests show the
    replay catching."""
    segments = (rows,) if isinstance(rows, int) else tuple(rows)
    D, loads, count = depth, sum(n + 2 for n in segments), cluster * 2 * 4
    tops = ([], [])                       # each warpgroup's rows: their top input row's load
    done_rows = base = 0
    for n in segments:
        for r in range(n):
            tops[(done_rows + r) % 2].append(base + r)
        done_rows, base = done_rows + n, base + n + 2
    slots = [[[None] * cluster for _ in range(D)] for _ in range(cluster)]
    full_done = [[0] * D for _ in range(cluster)]      # completed phases
    empty_done = [[0] * D for _ in range(cluster)]
    empty_arrivals = [[0] * D for _ in range(cluster)]
    released = [[0] * loads for _ in range(cluster)]   # arrivals for each load
    issued = [0] * cluster
    flying = []                           # (CTA, half, load): TMA writes not yet landed
    wgs = {(c, q): {"k": 0, "next": 0, "stage": "idle"} for c in range(cluster) for q in (0, 1)}

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
            if st["k"] >= len(tops[key[1]]):
                continue
            i, nxt = tops[key[1]][st["k"]], st["next"]
            if st["stage"] == "idle" and nxt < i:
                if passes(full_done[key[0]], nxt) or protocol == "no_skip" or (
                        nxt == 0 and protocol == "no_wait"):
                    moves.append(("skip", key))
            elif st["stage"] == "idle" and all(passes(full_done[key[0]], i + k) for k in range(3)):
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
        i = tops[q][st["k"]]
        if kind == "skip":             # a load the warpgroup does not read: waited for, released
            nxt = st["next"]
            if protocol == "kernel" or (nxt and protocol != "no_skip"):
                assert full_done[c][nxt % D] == nxt // D + 1, \
                    f"the wait for load {nxt} passed on another phase"
                release(nxt)
            elif protocol == "wait_no_release":
                assert full_done[c][0] == 1, "the wait for load 0 passed on another phase"
            st["next"] = nxt + 1
        elif kind == "start":
            assert all(holds(c, i + k) for k in range(3)), f"row at load {i} read a slot too early"
            st["stage"] = "busy"
        elif st["stage"] == "busy":   # the dy = 0 group retired
            assert holds(c, i) and holds(c, i + 1) and holds(c, i + 2)
            if early:
                release_top(i)
            st["stage"] = "dy0"
        else:                          # the row retired: load i + 1 is free
            assert holds(c, i + 1) and holds(c, i + 2) and (early or holds(c, i))
            if not early:
                release_top(i)
            release(i + 1)
            st["k"], st["next"], st["stage"] = st["k"] + 1, i + 2, "idle"
    assert issued == [loads] * cluster and not flying, \
        f"a producer stalled: {issued} of {loads}"
    assert all(st["k"] == len(tops[q]) for (_, q), st in wgs.items()), "a consumer stalled"
    # every load below what both warpgroups have passed is released by all warps of the cluster
    passed = min(st["next"] for st in wgs.values())
    assert all(released[c][i] == count for c in range(cluster) for i in range(passed))


@pytest.mark.parametrize("rows", [1, 2, 3, 4, 5, 6, 7, 8, 13, 32, 64, (3, 5), (1, 1, 1),
                                  (2, 7, 1), (6, 1, 4), (1, 8), (13, 2, 9), (5, 64, 5)])
def test_ring_protocol_never_stalls_or_overwrites(rows):
    """The 64-channel tile's protocol (one CTA, DEPTH = 7 slots, both
    releases when the row retires) over a band, and over the segments of a
    balanced range that crosses columns (a tuple: each segment's rows), also
    with load 0 landing last."""
    rng = np.random.default_rng(rows if isinstance(rows, int) else sum(rows) * len(rows))
    for k in range(30):
        replay_ring(rows, rng, late=(0,) if k % 2 else ())


@pytest.mark.parametrize("protocol,fault", [("no_wait", "too early"),
                                            ("wait_no_release", "stalled"),
                                            ("no_skip", "stalled")])
def test_ring_replay_catches_the_faulty_protocols(protocol, fault):
    """At the 64-channel tile's 7 slots too: without warpgroup 1's wait for
    load 0, its row 5 waits for load 7 (slot 0, phase 1), which passes while
    load 0 is still in flight (here it lands last), and the row reads the
    slot too early. With the wait but without its release, load 7 can land
    first, and the parity wait for load 0 then blocks until load 14, which
    never comes: a stall. Over two segments of 8 rows, a warpgroup that
    leaves the first segment's last loads unreleased stalls the producer."""
    rng = np.random.default_rng(5)
    rows = (8, 8) if protocol == "no_skip" else 8
    with pytest.raises(AssertionError, match=fault):
        for _ in range(300):
            replay_ring(rows, rng, protocol=protocol, late=(0,) if protocol == "no_wait" else ())


def _bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.bfloat16).float().numpy()


def _emulate_conv(x, wpk, plan, bias=None, residual=None):
    """One conv as the tile computes it, in numpy with f32 sums: x is NHWC
    (bf16 values), wpk one layer packed [tap][co][ci]. Per CTA segment and
    row: the haloed ring rows (zero outside the image, as TMA fills them),
    D[co, n] = sum over taps of W[tap] @ ring[dy][n + dx]^T over the row-run's
    128 pixels, or its first 64 where the strip holds at most 64 columns of
    the image (the narrow product), then the epilogue (the NHWC ``residual``
    added, or ``bias`` added and ReLU) and one bf16 rounding, stored where x
    < W."""
    B, H, W, C = x.shape
    out = np.full_like(x, np.nan)
    for cta in range(plan.grid):
        for b, x0, y0, rows in band_of(plan, B, H, W, cta):
            for y in range(y0, y0 + rows):
                _emulate_row(x, wpk, plan, b, x0, y, out, bias, residual)
    assert not np.isnan(out).any()
    return out


def _emulate_row(x, wpk, plan, b, x0, y, out, bias, residual):
    """One row-run of :func:`_emulate_conv`."""
    _, H, W, C = x.shape
    npix = NARROW if W - x0 <= NARROW else plan.strip
    ring = np.zeros((3, plan.strip + 2, C), np.float32)
    for dy in range(3):
        yy = y + dy - 1
        if 0 <= yy < H:
            lo, hi = max(x0 - 1, 0), min(x0 + plan.strip + 1, W)
            ring[dy, lo - (x0 - 1):hi - (x0 - 1)] = x[b, yy, lo:hi]
    d = np.zeros((C, npix), np.float32)
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        d += wpk[tap] @ ring[dy, dx:dx + npix].T
    n = min(plan.strip, W - x0)
    v = d[:, :n].T
    if residual is not None:
        v = v + residual[b, y, x0:x0 + n]
    else:
        v = v + (0 if bias is None else bias)
        v = np.where(v < 0, 0, v)
    out[b, y, x0:x0 + n] = _bf16(v)


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


# (B, H, W, SMs, form): the banded plan at two strips, the second ragged, in
# bands of several rows with a short last one; the balanced schedule (the
# plan these shapes take) with ranges that cross from one strip, or one
# image, into the next, and a last strip of at most 64 columns (the narrow
# product)
EMU = [(1, 7, 150, 6, "banded"), (2, 7, 136, 8, "banded"), (2, 7, 136, 8, "balanced"),
       (2, 9, 300, 5, "balanced")]


def emu_plan(B, H, W, sms, form):
    """The plan of an EMU case, checked to have the structure it stands for."""
    if form == "banded":
        plan = _banded_plan(B, H, W, sms)
        assert plan.rows_per_cta > 1 and H % plan.rows_per_cta and plan.strips == 2
    else:
        plan = conv_tile_plan(B, H, W, sms=sms)
        assert plan.balanced and W - (plan.strips - 1) * STRIP <= NARROW
        assert any(len(band_of(plan, B, H, W, i)) > 1 for i in range(plan.grid))
    return plan


@pytest.mark.parametrize("B,H,W,sms,form", EMU)
def test_emulated_tile_matches_lax_chain(B, H, W, sms, form):
    """K5 on the tile's decomposition (3 layers), in both plan forms, vs the
    JAX chain ``_lax_chain`` (conv_chain.py:175), same rounding points:
    relative max error <= 2e-2 (chip_smoke.py's KERNEL_RTOL)."""
    rng = np.random.default_rng(B * 100 + W)
    plan = emu_plan(B, H, W, sms, form)
    h = rng.standard_normal((B, 64, H, W)).astype(np.float32)
    ws = (rng.standard_normal((3, 64, 64, 3, 3)) * (2 / 576) ** 0.5).astype(np.float32)
    bs = (rng.standard_normal((3, 64)) * 0.02).astype(np.float32)
    want = _lax_chain(jnp.asarray(h, jnp.bfloat16), jnp.asarray(ws), jnp.asarray(bs))
    got = _emulate_chain(h, ws, bs, plan)
    assert _rel(got, np.asarray(want.astype(jnp.float32))) <= 2e-2


@pytest.mark.parametrize("B,H,W,sms,form", EMU)
def test_emulated_tile_matches_lax_resblocks(B, H, W, sms, form):
    """K1 on the tile's decomposition (2 blocks, conv2 adding into its input
    in place), in both plan forms, vs the JAX f32 chain
    ``_lax_resblocks_f32`` (resblock_chain.py:139) on the folded layout:
    relative max error <= 2e-2."""
    rng = np.random.default_rng(B * 10 + W)
    plan = emu_plan(B, H, W, sms, form)
    h = _bf16(rng.standard_normal((B, 64, H, W)))
    w1 = (rng.standard_normal((2, 64, 64, 3, 3)) * 0.2 * (2 / 576) ** 0.5).astype(np.float32)
    w2 = (rng.standard_normal((2, 64, 64, 3, 3)) * 0.2 * (2 / 576) ** 0.5).astype(np.float32)
    got = _emulate_resblocks(h, w1, w2, plan)
    for b in range(B):
        vf = _fold(jnp.asarray(h[b:b + 1]))
        want = np.asarray(_unfold(_lax_resblocks_f32(vf, jnp.asarray(w1), jnp.asarray(w2))))
        assert _rel(got[b:b + 1], want) <= 2e-2
