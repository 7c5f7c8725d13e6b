"""Launch plan of the 64-channel wgmma conv tile (``csrc/conv3x3_wgmma.cuh``),
the tile of K1 (``resblock_chain``) and K5 (``conv_chain``).

The kernel cuts a ``(B, H, W, 64)`` activation into strips of ``STRIP``
output columns and each strip into bands of ``rows_per_cta`` rows: one CTA a
band, one CTA an SM. :func:`conv_tile_plan` picks the band height and gives
the numbers the wrapper passes to the kernel, which checks them against its
own constants (``wg::check_plan``). Pure Python: the CPU tests check the
plan (every output pixel covered once, shared memory within an SM, TMA boxes
within 256) without a card.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

__all__ = ["ConvTilePlan", "conv_tile_plan", "STRIP", "DEPTH", "SMEM_LIMIT", "H100_SMS"]

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


@functools.lru_cache(maxsize=256)
def conv_tile_plan(B: int, H: int, W: int, sms: int = H100_SMS) -> ConvTilePlan:
    """The launch plan for a ``(B, H, W, 64)`` activation on a card with
    ``sms`` SMs: the shortest band that keeps the grid within one wave (at
    most ``sms`` CTAs), or whole strips where even those exceed it."""
    if min(B, H, W) < 1:
        raise ValueError(f"conv_tile_plan takes B, H, W >= 1, got {(B, H, W)}")
    strips = -(-W // STRIP)
    cols = B * strips
    rows = min(H, max(1, -(-cols * H // sms)))
    while rows < H and cols * -(-H // rows) > sms:
        rows += 1
    bands = -(-H // rows)
    plan = ConvTilePlan(STRIP, strips, rows, bands, cols * bands, DEPTH, 0,
                        (C, STRIP + 2, 1, 1), (C, STRIP, 1, 1), (C, C))
    return plan._replace(smem_bytes=sum(plan.smem_parts().values()))
