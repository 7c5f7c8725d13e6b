"""Launch plans of the port's wgmma + TMA kernels (``csrc/*wgmma*.cuh``):

- :func:`conv_tile_plan`, the 64-channel 3x3 conv tile
  (``csrc/conv3x3_wgmma.cuh``) of K1 (``resblock_chain``), K5
  (``conv_chain``) and the scale-0 chains of K2/K3 and K4;
- :func:`conv128_tile_plan`, the 128-channel 3x3 conv tile
  (``csrc/conv3x3_c128_wgmma.cuh``) of K4's scale-1 chain, a thread-block
  cluster of two CTAs a band (each CTA half of the output channels);
- :func:`proj_plan`, the 2x2 projections (``csrc/proj2x2_wgmma.cuh``) of
  K2/K3 and K4.

Each kernel cuts its activation into strips of ``strip`` columns and each
strip into bands of ``rows_per_cta`` rows: one CTA (or cluster) a band, one
CTA an SM. A plan picks the band height and gives the numbers the wrapper
passes to the kernel (``args()``), which checks them against its own
constants (``check_plan``). Pure Python: the CPU tests check the plans
(every output pixel and channel covered once, shared memory within an SM,
TMA boxes within 256) without a card.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

__all__ = ["ConvTilePlan", "conv_tile_plan", "STRIP", "DEPTH", "SMEM_LIMIT", "H100_SMS",
           "Conv128TilePlan", "conv128_tile_plan", "ProjPlan", "proj_plan"]

C = 64                    # channels in and out
STRIP = 128               # output columns of a strip: the wgmma N
DEPTH = 7                 # ring slots of haloed input rows
SMEM_LIMIT = 232448       # shared memory a block may ask for on sm_90 (227 KB)
H100_SMS = 132            # SMs of an H100 SXM
_ROW = 2 * C              # bytes of one pixel's channels
_NCONS = 2                # consumer warpgroups


def _align(n: int, a: int) -> int:
    return -(-n // a) * a


class ConvTilePlan(NamedTuple):
    strip: int            # output columns of a strip
    strips: int           # strips across the width
    rows_per_cta: int     # output rows of a band (the last band of a strip may be shorter)
    bands: int            # bands down the height
    grid: int             # CTAs: B * strips * bands
    depth: int            # ring slots
    smem_bytes: int       # dynamic shared memory of a CTA
    box: tuple            # TMA box of an input ring row: (C, W, H, B) extents
    out_box: tuple        # TMA box of an output row-run (and of its residual)
    weight_box: tuple     # TMA box of one tap's weights: (ci, rows)

    def smem_parts(self) -> dict:
        """The shared-memory layout (bytes): alignment slack, weights, ring,
        the consumers' output buffers (one TMA store box each), barriers."""
        box_bytes = self.box[0] * self.box[1] * 2
        return {"align": 1024, "weights": 9 * C * C * 2,
                "ring": self.depth * _align(box_bytes, 1024),
                "out": _NCONS * self.out_box[0] * self.out_box[1] * 2, "barriers": 256}

    def args(self) -> tuple:
        """The plan as the C entry points take it (``wg::Plan``)."""
        return (self.strip, self.depth, self.smem_bytes, self.rows_per_cta, self.grid)


def _band(cols: int, H: int, slots: int) -> int:
    """The shortest band of rows that keeps ``cols`` columns of bands within
    ``slots`` (one wave), or the whole height where even one band a column
    exceeds them."""
    rows = min(H, max(1, -(-cols * H // slots)))
    while rows < H and cols * -(-H // rows) > slots:
        rows += 1
    return rows


@functools.lru_cache(maxsize=256)
def conv_tile_plan(B: int, H: int, W: int, sms: int = H100_SMS) -> ConvTilePlan:
    """The launch plan for a ``(B, H, W, 64)`` activation on a card with
    ``sms`` SMs: the shortest band that keeps the grid within one wave (at
    most ``sms`` CTAs), or whole strips where even those exceed it."""
    if min(B, H, W) < 1:
        raise ValueError(f"conv_tile_plan takes B, H, W >= 1, got {(B, H, W)}")
    strips = -(-W // STRIP)
    cols = B * strips
    rows = _band(cols, H, sms)
    bands = -(-H // rows)
    plan = ConvTilePlan(STRIP, strips, rows, bands, cols * bands, DEPTH, 0,
                        (C, STRIP + 2, 1, 1), (C, STRIP, 1, 1), (C, C))
    return plan._replace(smem_bytes=sum(plan.smem_parts().values()))


# ---------------------------------------------------------------- 128 channels

STRIP128 = 64             # output columns of a strip of the 128-channel tile: the wgmma N
DEPTH128 = 4              # its ring slots (a fifth does not fit beside the weights)
CLUSTER128 = 2            # CTAs of a cluster: each computes 64 of the 128 output channels
H100_CLUSTERS128 = 66     # clusters of the tile an H100 SXM holds at once (2 CTAs of 132 SMs);
                          # the op asks the card (cudaOccupancyMaxActiveClusters)


class Conv128TilePlan(NamedTuple):
    strip: int            # output columns of a strip
    strips: int           # strips across the width
    rows_per_cta: int     # output rows of a band (the last band of a strip may be shorter)
    bands: int            # bands down the height
    grid: int             # CTAs: CLUSTER128 * B * strips * bands, a cluster a band
    depth: int            # ring slots (each holds both 64-channel K-blocks of an input row)
    smem_bytes: int       # dynamic shared memory of a CTA
    box: tuple            # TMA box of one K-block of an input ring row: (C, W, H, B) extents
    out_box: tuple        # TMA box of a CTA's output row-run (and its residual)
    weight_box: tuple     # TMA box of one tap's weights of one K-block: (ci, rows)

    def smem_parts(self) -> dict:
        """The CTA's half of a layer's weights (9 taps x 2 K-blocks), the
        ring (two K-block boxes a slot, back to back), the consumers' output
        buffers, barriers; no alignment slack (the kernel requires a
        1024-byte-aligned base)."""
        box_bytes = self.box[0] * self.box[1] * 2
        return {"align": 0, "weights": 18 * self.weight_box[0] * self.weight_box[1] * 2,
                "ring": self.depth * 2 * box_bytes,
                "out": _NCONS * self.out_box[0] * self.out_box[1] * 2, "barriers": 256}

    def args(self) -> tuple:
        """The plan as the C entry points take it (``wg128::Plan``)."""
        return (self.strip, self.depth, self.smem_bytes, self.rows_per_cta, self.grid)


@functools.lru_cache(maxsize=256)
def conv128_tile_plan(B: int, H: int, W: int, clusters: int = H100_CLUSTERS128) -> Conv128TilePlan:
    """The launch plan for a ``(B, H, W, 128)`` activation on a card that
    holds ``clusters`` clusters of the tile at once: the shortest band that
    keeps the clusters within one wave, or whole strips where even those
    exceed it."""
    if min(B, H, W, clusters) < 1:
        raise ValueError(f"conv128_tile_plan takes B, H, W, clusters >= 1, got "
                         f"{(B, H, W, clusters)}")
    strips = -(-W // STRIP128)
    cols = B * strips
    rows = _band(cols, H, clusters)
    bands = -(-H // rows)
    plan = Conv128TilePlan(STRIP128, strips, rows, bands, CLUSTER128 * cols * bands, DEPTH128,
                           0, (C, STRIP128 + 2, 1, 1), (C, STRIP128, 1, 1), (C, C))
    return plan._replace(smem_bytes=sum(plan.smem_parts().values()))


# ---------------------------------------------------------------- projections

PROJ_STRIP = 64           # pixels of a projection's row-run: the wgmma N
PROJ_KB = 4               # K-blocks of 64 channels a chunk (weights resident: K <= 256)
PROJ_DEPTH = 4            # ring slots
PROJ_MODES = ("up", "down_add")


class ProjPlan(NamedTuple):
    mode: str             # "up" (transposed conv) or "down_add" (strided conv added in place)
    strip: int            # pixels of a row-run (input pixels for "up", output for "down_add")
    strips: int           # strips across the width
    rows_per_cta: int     # rows of a band (input rows for "up", output rows for "down_add")
    bands: int
    groups: int           # output-channel groups, one a CTA: "up" (ph, 64 channels),
                          # "down_add" 128 channels
    grid: int             # CTAs: groups * B * strips * bands (the group the fastest index)
    kb: int               # K-blocks of 64 channels (past PROJ_KB: chunks of PROJ_KB, the
                          # weights streamed with the input, a chunk a ring stage)
    depth: int            # ring slots
    smem_bytes: int
    box: tuple            # TMA box of one K-block of an input row-run
    out_box: tuple        # TMA box of an output row-run
    weight_box: tuple     # TMA box of one K-block of a warpgroup's weight slice

    def smem_parts(self) -> dict:
        """Alignment slack, the two warpgroups' weight slices (room for
        PROJ_KB K-blocks), the ring (PROJ_KB boxes a slot), two output
        buffers of 2 strip pixels x 64 channels, barriers."""
        box_bytes = self.box[0] * self.box[1] * 2
        return {"align": 1024, "weights": 2 * PROJ_KB * self.weight_box[0] * self.weight_box[1] * 2,
                "ring": self.depth * PROJ_KB * box_bytes, "out": 2 * 2 * self.strip * C * 2,
                "barriers": 256}

    def args(self) -> tuple:
        """The plan as the C entry points take it (``wgp::Plan``)."""
        return (self.strip, self.depth, self.smem_bytes, self.rows_per_cta, self.grid, self.groups)


@functools.lru_cache(maxsize=256)
def proj_plan(mode: str, B: int, Hm: int, Wm: int, K: int, Co: int,
              sms: int = H100_SMS) -> ProjPlan:
    """The launch plan of a 2x2 projection. ``"up"``: input (B, Hm, Wm, K)
    -> output (B, 2Hm, 2Wm, Co), K a multiple of 16, Co of 64.
    ``"down_add"``: input (B, 2Hm, 2Wm, K/4) -> output (B, Hm, Wm, Co) in
    place, K = 256, Co a multiple of 128. The shortest band that keeps the
    grid within one wave of ``sms`` CTAs."""
    if mode not in PROJ_MODES:
        raise ValueError(f"proj_plan mode must be one of {PROJ_MODES}, got {mode!r}")
    if min(B, Hm, Wm) < 1:
        raise ValueError(f"proj_plan takes B, Hm, Wm >= 1, got {(B, Hm, Wm)}")
    if mode == "up" and (K % 16 or K < 16 or Co % C or Co < C):
        raise ValueError(f"proj_plan 'up' takes K and Co multiples of 16 and {C}, "
                         f"got K={K}, Co={Co}")
    if mode == "down_add" and (K != 64 * PROJ_KB or Co % (2 * C) or Co < 2 * C):
        raise ValueError(f"proj_plan 'down_add' takes K = {64 * PROJ_KB} and Co a multiple of "
                         f"{2 * C}, got K={K}, Co={Co}")
    groups = 2 * (Co // C) if mode == "up" else Co // (2 * C)
    strips = -(-Wm // PROJ_STRIP)
    units = groups * B * strips
    rows = _band(units, Hm, sms)
    bands = -(-Hm // rows)
    out_w = 2 * PROJ_STRIP if mode == "up" else PROJ_STRIP
    plan = ProjPlan(mode, PROJ_STRIP, strips, rows, bands, groups, units * bands, -(-K // C),
                    PROJ_DEPTH, 0, (C, PROJ_STRIP, 1, 1), (C, out_w, 1, 1), (C, C))
    return plan._replace(smem_bytes=sum(plan.smem_parts().values()))
