"""PromptIR all-in-one restoration (port of deepinv_tpu/models/promptir.py).

The JAX package's compact PromptIR: a 3-level Restormer encoder-decoder
(:mod:`.restormer`'s blocks) with a prompt-generation module at each decoder
level. Learned prompt components are mixed by a softmax over a global
descriptor, resized bilinearly to the features (``jax.image.resize``'s
weights, :func:`~.utils.resize_bilinear`) and fused by a conv.
"""

from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from .base import Denoiser
from .layers import Conv2d, Linear
from .restormer import _Down, _TransformerBlock, _Up
from .utils import resize_bilinear, test_pad

__all__ = ["PromptIR"]


class _PromptGen(nn.Module):
    """Prompt generation module (promptir.py:24)."""

    def __init__(self, dim: int, n_prompts: int = 5, prompt_dim: int = 16,
                 prompt_size: int = 8, generator=None):
        super().__init__()
        self.prompts = nn.Parameter(torch.randn(
            (n_prompts, prompt_dim, prompt_size, prompt_size), generator=generator) * 0.02)
        self.mixer = Linear(dim, n_prompts, generator=generator)
        self.fuse = Conv2d(dim + prompt_dim, dim, 3, 1, 1, bias=False, generator=generator)

    def forward(self, x):
        B, C, H, W = x.shape
        w = torch.softmax(self.mixer(x.mean(dim=(2, 3))), dim=-1)             # (B, n)
        p = torch.einsum("bn,ndhw->bdhw", w, self.prompts.to(x.dtype))
        return self.fuse(torch.cat([x, resize_bilinear(p, (H, W))], dim=1))


class PromptIR(Denoiser):
    """Compact PromptIR (promptir.py:44): a blind restorer, ``sigma`` unused.

    :param generator: CPU ``torch.Generator`` of the initialization.
    :param device: the CUDA device by default.
    """

    def __init__(self, in_channels: int = 3, dim: int = 16, num_blocks=(1, 1, 2),
                 heads=(1, 2, 4), generator=None, device=None):
        device = resolve_device(device)
        super().__init__()
        g = generator
        dims = [dim, dim * 2, dim * 4]

        def blocks(lv):
            return nn.ModuleList([_TransformerBlock(dims[lv], heads[lv], 2.0, generator=g)
                                  for _ in range(num_blocks[lv])])

        self.embed = Conv2d(in_channels, dim, 3, 1, 1, bias=False, generator=g)
        self.enc = nn.ModuleList([blocks(lv) for lv in range(3)])
        self.downs = nn.ModuleList([_Down(dims[lv], g) for lv in range(2)])
        self.ups = nn.ModuleList([_Up(dims[lv + 1], g) for lv in reversed(range(2))])
        self.prompts = nn.ModuleList([_PromptGen(dims[1], generator=g),
                                      _PromptGen(dims[0], generator=g)])
        self.reduce = nn.ModuleList([
            Conv2d(dims[1] * 2, dims[1], 1, 1, 0, bias=False, generator=g),
            Conv2d(dims[0] * 2, dims[0], 1, 1, 0, bias=False, generator=g)])
        self.dec = nn.ModuleList([blocks(1), blocks(0)])
        self.out = Conv2d(dims[0], in_channels, 3, 1, 1, bias=False, generator=g)
        self.to(device)

    def _forward(self, x):
        h, skips = self.embed(x), []
        for lv in range(2):
            for b in self.enc[lv]:
                h = b(h)
            skips.append(h)
            h = self.downs[lv](h)
        for b in self.enc[2]:
            h = b(h)
        for i in range(2):
            h = self.reduce[i](torch.cat([self.ups[i](h), skips[1 - i]], dim=1))
            h = self.prompts[i](h)
            for b in self.dec[i]:
                h = b(h)
        return x + self.out(h)

    def forward(self, x, sigma=None, **kwargs):
        if x.shape[-2] % 4 or x.shape[-1] % 4:
            return test_pad(self._forward, x, modulo=4)
        return self._forward(x)

    def forward_promptir(self, y):
        """The network without padding (promptir.py:97): sides must be
        multiples of 4."""
        if y.shape[-2] % 4 or y.shape[-1] % 4:
            raise ValueError("Image spatial dim is not divisible by 4. Spatial dim : "
                             f"({y.shape[-2]},{y.shape[-1]})")
        return self._forward(y)

    def load_pretrained(self, checkpoint_path):
        """Load a state dict saved from this module by ``torch.save``
        (promptir.py:106, which reads the JAX package's own pickled modules).
        The authors' checkpoints (``.ckpt``, ``.pth``, ``.pt``) are another
        topology and are refused, as in the JAX package.

        :raises ValueError: for ``"download"`` (no network access).
        :raises NotImplementedError: for an authors' checkpoint suffix.
        """
        if checkpoint_path == "download":
            raise ValueError("no network egress in this environment; pass a local path")
        if str(checkpoint_path).endswith((".ckpt", ".pth", ".pt")):
            raise NotImplementedError(
                "this compact PromptIR is not weight-compatible with the authors' torch "
                "checkpoint; use Restormer(pretrained=...) for a ported restoration transformer")
        sd = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
        self.load_state_dict(sd.get("model", sd) if isinstance(sd, dict) else sd)
        return self
