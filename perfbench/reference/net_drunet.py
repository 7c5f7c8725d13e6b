"""Plain float32 DRUNet (Zhang et al., "Plug-and-Play Image Restoration with
Deep Denoiser Prior", TPAMI 2021; DPIR ``models/network_unet.py`` ``UNetRes``
with ``downsample_mode="strideconv"``, ``upsample_mode="convtranspose"``).

Head 3x3 conv on the image and its noise-level map, three scales of ``nb``
ResBlocks (``x + conv(relu(conv(x)))``) each followed by a strided 2x2 conv,
``nb`` ResBlocks in the body, three 2x2 transposed convs each followed by
``nb`` ResBlocks with additive skips, and a tail 3x3 conv; no bias. The
parameters are a dict under the names ``param_specs`` gives them. Departure
from DPIR: the input is not replicate-padded to a multiple of 8, so heights
and widths must already be one.
"""

import torch
import torch.nn.functional as F

from . import weights
from .precision import f32


def _blocks(prefix, c, start, nb):
    return [(f"{prefix}.layers.{start + i}.conv{j}.weight", c) for i in range(nb) for j in (1, 2)]


def param_specs(cfg, channels):
    """``[(name, shape, std)]`` of the weights, at the init scale
    ``cfg["weights"]`` states."""
    nc, nb, w = cfg["nc"], cfg["nb"], cfg["weights"]
    res, tail = w["resblock_gain"], w["tail_gain"]
    cin = channels + 1
    specs = [("m_head.weight", (nc[0], cin, 3, 3), weights.he_std(cin * 9))]

    def blocks(prefix, c, start):
        specs.extend((n, (c, c, 3, 3), weights.he_std(c * 9, res))
                     for n, c in _blocks(prefix, c, start, nb))

    for s, name in enumerate(("m_down1", "m_down2", "m_down3")):
        blocks(name, nc[s], 0)
        specs.append((f"{name}.layers.{nb}.weight", (nc[s + 1], nc[s], 2, 2),
                      weights.he_std(nc[s] * 4)))
    blocks("m_body", nc[3], 0)
    for s, name in ((3, "m_up3"), (2, "m_up2"), (1, "m_up1")):
        # a transposed conv's weight is (in, out, kh, kw)
        specs.append((f"{name}.layers.0.weight", (nc[s], nc[s - 1], 2, 2),
                      weights.he_std(nc[s] * 4)))
        blocks(name, nc[s - 1], 1)
    specs.append(("m_tail.weight", (channels, nc[0], 3, 3), weights.he_std(nc[0] * 9, tail)))
    return specs


def forward(p, x, sigma, cfg, q=f32):
    """The denoised ``x`` (``(B, C, H, W)``, H and W multiples of 8) at noise
    level ``sigma``; ``q`` rounds each conv's input and weight, and the
    output."""
    nb = cfg["nb"]

    def conv(v, name, stride=1, pad=1):
        return F.conv2d(q(v), q(p[name]), None, stride, pad)

    def resblocks(v, prefix, start):
        for i in range(start, start + nb):
            h = F.relu(conv(v, f"{prefix}.layers.{i}.conv1.weight"))
            v = v + conv(h, f"{prefix}.layers.{i}.conv2.weight")
        return v

    def down(v, name):
        return conv(resblocks(v, name, 0), f"{name}.layers.{nb}.weight", stride=2, pad=0)

    def up(v, name):
        v = F.conv_transpose2d(q(v), q(p[f"{name}.layers.0.weight"]), None, 2)
        return resblocks(v, name, 1)

    h = torch.cat([x, torch.full_like(x[:, :1], float(sigma))], dim=1)
    x1 = conv(h, "m_head.weight")
    x2 = down(x1, "m_down1")
    x3 = down(x2, "m_down2")
    x4 = down(x3, "m_down3")
    v = resblocks(x4, "m_body", 0)
    v = up(v + x4, "m_up3")
    v = up(v + x3, "m_up2")
    v = up(v + x2, "m_up1")
    return q(conv(v + x1, "m_tail.weight"))
