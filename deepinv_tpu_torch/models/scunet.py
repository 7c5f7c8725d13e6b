"""SCUNet, the Swin-Conv UNet denoiser (port of deepinv_tpu/models/scunet.py).

Each stage mixes a residual conv branch with a (shifted-)window attention
branch behind 1x1 mixing convs (``_ConvTransBlock``). The window attention's
relative-position parameters are ``(heads, 2w - 1, 2w - 1)``, the layout of
upstream's checkpoints; the MLP's GELU is the exact erf form (scunet.py:128,
not ``layers.GELU``). The attention is ``matmul`` + bias + mask +
``softmax`` as in the JAX module; each shifted stage's mask is built once
per size and device.

The names of the module tree are the JAX module's; ``convert.scunet_names``
maps them to upstream's (``m_down1.0.trans_block.msa.embedding_layer.weight``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .base import Denoiser
from .layers import Conv2d, ConvTranspose2d, Linear
from .swinir import _LayerNorm
from .utils import pad_hw

__all__ = ["SCUNet"]


def _sw_mask(h_windows: int, w_windows: int, p: int, shift: int) -> np.ndarray:
    """The SW-MSA mask, True where masked (scunet.py:39): only the last row
    and column of windows hold wrapped pixels after the cyclic shift."""
    m = np.zeros((h_windows, w_windows, p, p, p, p), dtype=bool)
    s = p - shift
    m[-1, :, :s, :, s:, :] = True
    m[-1, :, s:, :, :s, :] = True
    m[:, -1, :, :s, :, s:] = True
    m[:, -1, :, s:, :, :s] = True
    return m.reshape(h_windows * w_windows, p * p, p * p)


class _WMSA(nn.Module):
    """Window multi-head self-attention (scunet.py:52)."""

    def __init__(self, input_dim, output_dim, head_dim, window_size, type, generator=None):
        super().__init__()
        self.input_dim = input_dim
        self.head_dim = head_dim
        self.n_heads = input_dim // head_dim
        self.window_size = window_size
        self.type = type
        self.embedding_layer = Linear(input_dim, 3 * input_dim, generator=generator)
        self.linear = Linear(input_dim, output_dim, generator=generator)
        w = window_size
        self.relative_position_params = nn.Parameter(torch.zeros(self.n_heads, 2 * w - 1,
                                                                 2 * w - 1))
        cord = np.array([[i, j] for i in range(w) for j in range(w)])
        rel = cord[:, None, :] - cord[None, :, :] + w - 1                    # (p², p², 2)
        self.register_buffer("relation", torch.from_numpy(rel.astype(np.int64)),
                             persistent=False)
        self._masks = {}

    def _mask(self, hw, ww, device):
        key = (hw, ww, device)
        if key not in self._masks:
            w = self.window_size
            self._masks[key] = torch.from_numpy(_sw_mask(hw, ww, w, w // 2)).to(device)
        return self._masks[key]

    def forward(self, x):
        w = self.window_size
        shifted = self.type != "W"
        if shifted:
            x = torch.roll(x, (-(w // 2), -(w // 2)), dims=(1, 2))
        B, H, W, C = x.shape
        hw, ww = H // w, W // w
        x = x.reshape(B, hw, w, ww, w, C).permute(0, 1, 3, 2, 4, 5).reshape(B, hw * ww, w * w, C)
        hd, nh = self.head_dim, self.n_heads
        # einops' "(threeh c)": head-major over 3h groups of head_dim
        qkv = self.embedding_layer(x).reshape(B, hw * ww, w * w, 3 * nh, hd).movedim(3, 0)
        q, k, v = qkv[:nh], qkv[nh:2 * nh], qkv[2 * nh:]
        rel = self.relation
        bias = self.relative_position_params[:, rel[..., 0], rel[..., 1]]      # (h, p², p²)
        attn = (q @ k.transpose(-1, -2)) * (hd ** -0.5) + bias[:, None, None].to(x.dtype)
        if shifted:
            attn = attn.masked_fill(self._mask(hw, ww, x.device)[None, None], float("-inf"))
        out = torch.softmax(attn, dim=-1) @ v                                 # (h, B, nW, p², hd)
        out = self.linear(out.movedim(0, -2).reshape(B, hw * ww, w * w, nh * hd))
        out = out.reshape(B, hw, ww, w, w, -1).permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, -1)
        if shifted:
            out = torch.roll(out, (w // 2, w // 2), dims=(1, 2))
        return out


class _Block(nn.Module):
    """Swin block: the LN-WMSA and LN-MLP residuals (scunet.py:112); windows
    no smaller than the stage's resolution lose their shift."""

    def __init__(self, input_dim, output_dim, head_dim, window_size, type,
                 input_resolution=None, generator=None):
        super().__init__()
        if input_resolution <= window_size:
            type = "W"
        self.ln1 = _LayerNorm(input_dim)
        self.msa = _WMSA(input_dim, input_dim, head_dim, window_size, type, generator)
        self.ln2 = _LayerNorm(input_dim)
        self.mlp_fc1 = Linear(input_dim, 4 * input_dim, generator=generator)
        self.mlp_fc2 = Linear(4 * input_dim, output_dim, generator=generator)

    def forward(self, x):
        x = x + self.msa(self.ln1(x))
        return x + self.mlp_fc2(F.gelu(self.mlp_fc1(self.ln2(x))))


class _ConvTransBlock(nn.Module):
    """Parallel conv and transformer branches behind 1x1 mixers
    (scunet.py:132)."""

    def __init__(self, conv_dim, trans_dim, head_dim, window_size, type,
                 input_resolution=None, generator=None):
        super().__init__()
        g = generator
        self.conv_dim, self.trans_dim = conv_dim, trans_dim
        if input_resolution <= window_size:
            type = "W"
        self.trans_block = _Block(trans_dim, trans_dim, head_dim, window_size, type,
                                  input_resolution, g)
        d = conv_dim + trans_dim
        self.conv1_1 = Conv2d(d, d, 1, 1, 0, bias=True, generator=g)
        self.conv1_2 = Conv2d(d, d, 1, 1, 0, bias=True, generator=g)
        self.conv_a = Conv2d(conv_dim, conv_dim, 3, 1, 1, bias=False, generator=g)
        self.conv_b = Conv2d(conv_dim, conv_dim, 3, 1, 1, bias=False, generator=g)

    def forward(self, x):
        h = self.conv1_1(x)
        conv_x, trans_x = h[:, :self.conv_dim], h[:, self.conv_dim:]
        conv_x = self.conv_b(F.relu(self.conv_a(conv_x))) + conv_x
        trans_x = self.trans_block(trans_x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        return x + self.conv1_2(torch.cat([conv_x, trans_x], dim=1))


class SCUNet(Denoiser):
    """SCUNet (scunet.py:162): a blind denoiser, ``sigma`` unused.

    :param config: ConvTransBlocks in each of the 7 stages.
    :param dim: the base width.
    :param input_resolution: the training resolution: stages no larger than
        the window lose their shifts, as upstream's.
    :param pretrained: an upstream checkpoint.
    :param generator: CPU ``torch.Generator`` of the initialization.
    :param device: the CUDA device by default.
    """

    def __init__(self, in_nc: int = 3, config=(4, 4, 4, 4, 4, 4, 4), dim: int = 64,
                 input_resolution: int = 256, head_dim: int = 32, window_size: int = 8,
                 pretrained=None, generator=None, device=None):
        device = resolve_device(device)
        super().__init__()
        g = generator
        self.config = tuple(config)
        self.dim = dim

        def blocks(n, cdim, res):
            return [_ConvTransBlock(cdim, cdim, head_dim, window_size,
                                    "W" if not i % 2 else "SW", res, g) for i in range(n)]

        r = input_resolution
        self.m_head = Conv2d(in_nc, dim, 3, 1, 1, bias=False, generator=g)
        self.m_down1 = nn.ModuleList(blocks(config[0], dim // 2, r) + [
            Conv2d(dim, 2 * dim, 2, 2, 0, bias=False, generator=g)])
        self.m_down2 = nn.ModuleList(blocks(config[1], dim, r // 2) + [
            Conv2d(2 * dim, 4 * dim, 2, 2, 0, bias=False, generator=g)])
        self.m_down3 = nn.ModuleList(blocks(config[2], 2 * dim, r // 4) + [
            Conv2d(4 * dim, 8 * dim, 2, 2, 0, bias=False, generator=g)])
        self.m_body = nn.ModuleList(blocks(config[3], 4 * dim, r // 8))
        self.m_up3 = nn.ModuleList([ConvTranspose2d(8 * dim, 4 * dim, 2, 2, 0, bias=False,
                                                    generator=g)]
                                   + blocks(config[4], 2 * dim, r // 4))
        self.m_up2 = nn.ModuleList([ConvTranspose2d(4 * dim, 2 * dim, 2, 2, 0, bias=False,
                                                    generator=g)]
                                   + blocks(config[5], dim, r // 2))
        self.m_up1 = nn.ModuleList([ConvTranspose2d(2 * dim, dim, 2, 2, 0, bias=False,
                                                    generator=g)]
                                   + blocks(config[6], dim // 2, r))
        self.m_tail = Conv2d(dim, in_nc, 3, 1, 1, bias=False, generator=g)
        if pretrained is not None:
            from .convert import load_torch_checkpoint, port_scunet

            port_scunet(self, load_torch_checkpoint(pretrained))
        self.to(device)

    @staticmethod
    def _seq(mods, x):
        for m in mods:
            x = m(x)
        return x

    def forward_scunet(self, x0):
        """The padded 7-stage forward (scunet.py:219)."""
        return self(x0)

    def forward(self, x, sigma=None, **kwargs):
        h, w = x.shape[-2:]
        x = pad_hw(x, 0, (-h) % 64, 0, (-w) % 64, "edge")   # scunet.py:226-228
        x1 = self.m_head(x)
        x2 = self._seq(self.m_down1, x1)
        x3 = self._seq(self.m_down2, x2)
        x4 = self._seq(self.m_down3, x3)
        z = self._seq(self.m_body, x4)
        z = self._seq(self.m_up3, z + x4)
        z = self._seq(self.m_up2, z + x3)
        z = self._seq(self.m_up1, z + x2)
        return self.m_tail(z + x1)[..., :h, :w]
