"""Artifact2Artifact on dynamic MRI (port of
examples/demo_artifact2artifact.py): a disc that moves over 4 frames of
32x32, measured through per-frame random k-t masks (acceleration 2, shared
by the real and imaginary channels) with noise 0.01. A time-agnostic
DnCNN(2, 2) of depth 3 (the frames folded into the batch) behind the
adjoint trains for 50 Adam steps (lr 1e-3, optax's defaults) under the
Artifact2Artifact loss: a random chunk of 2 frames in, another scored, no
ground truth. The loss falls (the JAX demo asserts it).
"""

import numpy as np
import torch

from ..datasets import random_circles
from ..loss import Artifact2ArtifactLoss
from ..models import DnCNN
from ..physics import DynamicMRI, GaussianNoise
from ..physics.generator import RandomMaskGenerator
from . import _util


def main(device=None, fast=False):
    dev = _util.device(device)
    steps = _util.scale(50, 20, fast)
    C, T, H, W = 2, 4, 32, 32
    # a dynamic object: a moving disc, the anatomy shared across frames
    frames = np.stack([np.roll(random_circles(H, seed=1), s, axis=-1) for s in range(T)], axis=1)
    x = torch.from_numpy(np.concatenate([frames, np.zeros_like(frames)], 0))[None]
    # (B=1, C=2 real/imag, T, H, W)

    # per-frame random k-t masks, shared by the real and imaginary channels,
    # so that the (C, T, H, W) mask matches the splitting generator's layout
    gen = RandomMaskGenerator((T, H, W), acceleration=2, device="cpu")
    mask = gen.step(1, generator=_util.generator(0))["mask"][0]
    mask = mask.broadcast_to((C,) + tuple(mask.shape[-3:])).contiguous()
    physics = DynamicMRI(mask=mask, img_size=(T, H, W),
                         noise_model=GaussianNoise(0.01, device="cpu"), device="cpu")
    y = physics(x, generator=_util.generator(1))
    physics, y = physics.to(dev), y.to(dev)

    # a time-agnostic denoiser backbone: the frames folded into the batch
    net = DnCNN(2, 2, depth=3, nf=8, generator=_util.generator(2), device=dev)

    def model(yy, p, **kw):
        xin = p.A_adjoint(yy)
        B, Cc, Tt, Hh, Ww = xin.shape
        flat = xin.transpose(1, 2).reshape(B * Tt, Cc, Hh, Ww)
        return net(flat, 0.05).reshape(B, Tt, Cc, Hh, Ww).transpose(1, 2)

    loss = Artifact2ArtifactLoss((C, T, H, W), split_size=2, device="cpu")
    adapted = loss.adapt_model(model)
    opt = torch.optim.Adam(net.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    splits = _util.generator(10)  # the chunks in and scored, step by step
    losses = []
    for _ in range(steps):
        l = loss(y=y, physics=physics, model=adapted, generator=splits).mean()
        opt.zero_grad(set_to_none=True)
        l.backward()
        opt.step()
        losses.append(float(l.detach()))
    print(f"A2A loss: {losses[0]:.5f} -> {losses[-1]:.5f} over {steps} steps")
    return {"losses": losses}


if __name__ == "__main__":
    _util.cli(main, __doc__)
