"""Denoising repeated low-field MRI scans (port of
examples/demo_lowfieldmri.py): one 64x64 Shepp-Logan slice scanned three
times with noise of 0.15 and a one-pixel motion between scans, so that the
plain average of the three is blurred. A DnCNN of depth 5 adapted by the
Recorrupted-to-Recorrupted loss trains on the three noisy repetitions for
250 Adam steps (lr 1e-3, optax's defaults), no ground truth seen, and then
denoises a single repetition: it beats both that repetition and the
3-repetition average.
"""

import torch

from ..datasets import shepp_logan
from ..loss import PSNR, R2RLoss
from ..models import DnCNN
from ..physics import Denoising, GaussianNoise
from . import _util


def main(device=None, fast=False, steps=None):
    dev = _util.device(device)
    steps = _util.scale(250, 100, fast) if steps is None else steps
    # one anatomical slice; 3 noisy repetitions of the same scan, with a
    # small motion between them (what makes plain averaging blurry)
    x = torch.from_numpy(shepp_logan(64))[None, None]
    sigma = 0.15
    reps = [torch.roll(x, shift, dims=-1)
            + sigma * torch.randn(x.shape, generator=_util.generator(i))
            for i, shift in enumerate((0, 1, -1))]
    y = torch.cat(reps).to(dev)                 # (3, 1, H, W) noisy repetitions
    x = x.to(dev)
    y_avg = y.mean(0, keepdim=True)              # the motion-blurred average
    psnr = PSNR()

    physics = Denoising(noise_model=GaussianNoise(sigma, device="cpu")).to(dev)
    loss = R2RLoss()
    model = loss.adapt_model(DnCNN(1, 1, depth=5, nf=16, generator=_util.generator(0),
                                   device=dev))
    opt = torch.optim.Adam(model.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    corruptions = torch.Generator(dev).manual_seed(10)
    losses = []
    for _ in range(steps):
        v = loss(y=y, physics=physics, model=model, generator=corruptions).mean()
        opt.zero_grad(set_to_none=True)
        v.backward()
        opt.step()
        losses.append(float(v.detach()))

    with torch.no_grad():  # denoise a single repetition
        xhat = model(y[:1], physics, generator=torch.Generator(dev).manual_seed(11))
    out = {"psnr_single": float(psnr(y[:1], x)[0]), "psnr_average": float(psnr(y_avg, x)[0]),
           "psnr_r2r": float(psnr(xhat, x)[0]), "losses": losses}
    print(f"single repetition      PSNR: {out['psnr_single']:6.2f} dB")
    print(f"3-repetition average   PSNR: {out['psnr_average']:6.2f} dB (motion-blurred)")
    print(f"R2R-trained denoiser   PSNR: {out['psnr_r2r']:6.2f} dB (no ground truth, single "
          f"repetition; {steps} steps)")
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)
