"""Spatial tiling of a denoiser over a mesh axis (port of
deepinv_tpu/parallel/processing.py).

The image is cut into one band of rows (or columns) a device of the ``sp``
axis. Each band gets ``overlap`` halo rows from its neighbours (the JAX
package's ring exchange, ``lax.ppermute``, :110-124), goes to its mesh device
with ``.to(device, non_blocking=True)``, runs through the module there, is
trimmed of its halo and comes back to the input's device. At the image's ends
the halo is the band reflected without its edge row (``jnp.pad(mode=
"reflect")``, which the denoisers use), and where ``overlap`` equals the band's
height, which leaves one row short, the farthest halo row repeats the edge
row (:125-152). ``tiling_strategy="basic"`` and ``overlap == 0`` run the bands
alone, with no halo (:154-160).

Bands run one after another from this thread; CUDA launches are
asynchronous, so bands on different cards overlap.
"""

from __future__ import annotations

import torch
from torch import nn

from .context import DistributedContext, replica

__all__ = ["DistributedProcessing"]


def _reflect_halos(band, ov: int):
    """The top and bottom halos of an image-end band: ``ov`` rows of
    edge-excluded reflection, the rows it lacks when ``ov`` equals the band's
    height taken by the edge row, farthest from the band (processing.py:125-152)."""
    S = band.shape[-2]
    ovr = min(ov, S - 1)
    top = band[..., 1:ovr + 1, :].flip(-2)
    bot = band[..., S - ovr - 1:S - 1, :].flip(-2)
    if ovr < ov:
        top = torch.cat([band[..., :1, :].expand(*band.shape[:-2], ov - ovr, band.shape[-1]),
                         top], dim=-2)
        bot = torch.cat([bot, band[..., -1:, :].expand(*band.shape[:-2], ov - ovr,
                                                       band.shape[-1])], dim=-2)
    return top, bot


class DistributedProcessing(nn.Module):
    """A denoiser applied band by band over a mesh axis
    (deepinv_tpu/parallel/processing.py:41).

    :param module: ``(x, sigma) -> x``; an ``nn.Module`` is copied to each
        band's device at the first call that needs it there (a device that
        already holds its tensors uses it as it is).
    :param ctx: :class:`DistributedContext` with an ``sp_axis`` axis.
    :param overlap: halo rows exchanged with each neighbour (at most a band's
        height).
    :param tiling_strategy: ``"overlap_tiling"`` (halos, default) or
        ``"basic"`` (bands alone).
    :param tiling_dims: the axis cut into bands: -2 (rows, default) or -1
        (columns); 2 and 3 name them for NCHW.
    :param max_batch_size: run the batch in chunks of this size, the last
        padded with zero images (processing.py:84-99).
    :param patch_size: ignored (see :mod:`~deepinv_tpu_torch.parallel`): a
        band is ``H / axis_size`` rows.
    """

    def __init__(self, module, ctx: DistributedContext, overlap: int = 8, sp_axis: str = "sp",
                 tiling_strategy: str = "overlap_tiling", tiling_dims=None,
                 max_batch_size: int = None, patch_size: int = None):
        super().__init__()
        if tiling_strategy not in ("overlap_tiling", "basic"):
            raise ValueError("tiling_strategy must be 'overlap_tiling' or 'basic', got "
                             f"{tiling_strategy!r}")
        self.tile_axis = -2
        if tiling_dims is not None:
            td = (tiling_dims,) if isinstance(tiling_dims, int) else tuple(tiling_dims)
            if td not in ((-2,), (-1,), (2,), (3,)):
                raise ValueError("mesh tiling shards one spatial axis: tiling_dims must be -2/-1 "
                                 f"(or 2/3 for NCHW), got {tiling_dims!r}")
            self.tile_axis = -2 if td in ((-2,), (2,)) else -1
        self.module = module
        self.ctx = ctx
        self.overlap = overlap
        self.sp_axis = sp_axis
        self.tiling_strategy = tiling_strategy
        self.max_batch_size = max_batch_size
        self._replicas = {}

    def _module_on(self, device):
        key = str(device)
        if key not in self._replicas:
            self._replicas[key] = replica(self.module, device)
        return self._replicas[key]

    def _apply(self, module, x, sigma):
        """``module(x, sigma)``, the batch in chunks of ``max_batch_size``."""
        mb = self.max_batch_size
        if mb is None or x.shape[0] <= mb:
            return module(x, sigma)
        B = x.shape[0]
        pad = (-B) % mb
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        out = torch.cat([module(c, sigma) for c in torch.split(x, mb)])
        return out[:B]

    def forward(self, x, sigma=0.05):
        devs = self.ctx.axis_devices(self.sp_axis)
        n = len(devs)
        if n == 1:
            return self._apply(self._module_on(devs[0]), x, sigma)
        if self.tile_axis == -1:
            x = x.transpose(-1, -2)
        H = x.shape[-2]
        if H % n:
            lines = "columns" if self.tile_axis == -1 else "rows"
            raise ValueError(f"{H} {lines} do not split into {n} bands")
        S, ov = H // n, self.overlap
        if ov > S:
            raise ValueError(f"overlap {ov} exceeds the band height {S}")
        halo = self.tiling_strategy == "overlap_tiling" and ov > 0
        outs = []
        for i, dev in enumerate(devs):
            band = x[..., i * S:(i + 1) * S, :]
            if halo:
                top, bot = _reflect_halos(band, ov)
                if i > 0:
                    top = x[..., i * S - ov:i * S, :]
                if i < n - 1:
                    bot = x[..., (i + 1) * S:(i + 1) * S + ov, :]
                band = torch.cat([top, band, bot], dim=-2)
            out = self._apply(self._module_on(dev), band.to(dev, non_blocking=True), sigma)
            if halo:
                out = out[..., ov:-ov, :]
            outs.append(out.to(x.device, non_blocking=True))
        out = torch.cat(outs, dim=-2)
        return out.transpose(-1, -2) if self.tile_axis == -1 else out
