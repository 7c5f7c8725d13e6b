"""Spatially sharded denoising on a device mesh (port of
examples/demo_denoiser_distributed.py): a 512x512 noisy image (noise 0.15)
cut into 8 bands of 64 rows, one a mesh entry, each denoised by a 5x5
median. With halo exchange (8 rows from each neighbour) the result equals
the single-device median (error below 1e-5); without it the band seams
show (error above 1e-5): the JAX demo asserts both. Micro-batching runs a
batch of 12 copies 4 at a time on each entry and matches too.

The JAX demo runs on 8 virtual CPU devices. The port's mesh here has 8
entries on the one device the demo runs on (``devices=[device] * 8``): 8
mesh entries on one card, not 8 cards; one entry would cut no band.
"""

import torch

from ..datasets import random_circles
from ..models import MedianFilter
from ..parallel import DistributedContext, distribute
from . import _util

MESH = 8  # the mesh's entries: the JAX demo's 8 virtual devices


def main(device=None, fast=False):
    dev = _util.device(device)
    ctx = DistributedContext(axis_names=("sp",), devices=[dev] * MESH)
    print(f"mesh: {ctx.axis_size()} entries on the spatial axis 'sp'")
    # a "large" image: 512 rows -> 64 rows a mesh entry
    x = torch.from_numpy(random_circles(512, seed=1))[None]
    noisy = (x + 0.15 * torch.randn(x.shape, generator=_util.generator(0))).to(dev)

    den = MedianFilter(kernel_size=5)
    dden_halo = distribute(den, ctx, tiling_strategy="overlap_tiling", overlap=8)
    dden_basic = distribute(den, ctx, tiling_strategy="basic")
    with torch.no_grad():
        ref = den(noisy, 0.15)               # the single-device result
        out_halo = dden_halo(noisy, 0.15)    # sharded, with halo exchange
        out_basic = dden_basic(noisy, 0.15)  # sharded, no halo (seams!)
        # micro-batching: a batch of 12 in chunks of 4 on each entry
        batch = noisy.repeat(12, 1, 1, 1)
        out_mb = distribute(den, ctx, overlap=8, max_batch_size=4)(batch, 0.15)
    err_halo = float((out_halo - ref).abs().max())
    err_basic = float((out_basic - ref).abs().max())
    err_mb = float((out_mb - ref).abs().max())
    print(f"halo tiling  : max deviation from the single device {err_halo:.2e}")
    print(f"basic tiling : max deviation from the single device {err_basic:.2e} "
          f"(boundary seams, as expected)")
    print(f"max_batch_size=4 on batch {tuple(batch.shape)} -> {tuple(out_mb.shape)}, "
          f"deviation {err_mb:.2e}")
    return {"mesh": ctx.axis_size(), "err_halo": err_halo, "err_basic": err_basic,
            "err_microbatch": err_mb, "microbatch_shape": list(out_mb.shape),
            "x_hat": {"halo": out_halo, "basic": out_basic, "microbatch": out_mb}}


if __name__ == "__main__":
    _util.cli(main, __doc__)
