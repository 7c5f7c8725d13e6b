"""Batched reconstruction throughput (port of
examples/demo_batched_throughput.py): one reconstructor (16 PnP-HQS
iterations with a median prior on a 64x64 Gaussian deblurring problem) run
on a batch of 1 and a batch of 8 shifted phantoms, each timed over 3 calls
after a warm-up, to the device's finish. The physics, the solver and its
parameters do not change with the batch; per-image latency rises with it,
so interactive requests go at B=1 and bulk work batched. On a GPU the
images/s climb with the batch until the device saturates; on a CPU they
need not. The first image's reconstruction does not depend on the batch it
is in.
"""

import time

import torch

from ..datasets import shepp_logan
from ..loss.metric import PSNR
from ..models import MedianFilter
from ..ops import gaussian_blur
from ..optim import L2, PnP, optim_builder
from ..physics import BlurFFT, GaussianNoise
from . import _util


def main(device=None, fast=False, reps=3):
    dev = _util.device(device)
    H = 32 if fast else 64
    n_iter = 4 if fast else 16
    batches = (1, 4) if fast else (1, 8)
    physics = BlurFFT((1, H, H), filter=gaussian_blur(sigma=1.0),
                      noise_model=GaussianNoise(0.01, device="cpu"), device="cpu")
    model = optim_builder("HQS", data_fidelity=L2(), prior=PnP(MedianFilter()),
                          params_algo={"stepsize": 1.0, "g_param": 0.05}, max_iter=n_iter,
                          device=dev)
    base = torch.from_numpy(shepp_logan(H))[None, None]
    psnr = PSNR()
    out = {"images_per_s": {}, "ms_per_batch": {}, "psnr": {}, "first": {}}

    def finish():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # a batch is a leading axis: the same reconstructor for every size
    xs = {B: torch.cat([torch.roll(base, s, dims=-1) for s in range(B)]) for B in batches}
    ys = {B: physics(x, generator=_util.generator(1)).to(dev) for B, x in xs.items()}
    physics = physics.to(dev)
    for B in batches:
        x, y = xs[B].to(dev), ys[B]
        with torch.no_grad():
            xhat = model(y, physics)  # warm-up
            finish()
            t0 = time.perf_counter()
            for _ in range(reps):
                xhat = model(y, physics)
            finish()
            dt = (time.perf_counter() - t0) / reps
        out["images_per_s"][str(B)], out["ms_per_batch"][str(B)] = B / dt, dt * 1e3
        out["psnr"][str(B)] = float(psnr(xhat, x).mean())
        out["first"][str(B)] = xhat[:1]
        print(f"B={B:2d}: {B / dt:8.1f} images/s   ({dt * 1e3:6.1f} ms/batch, {n_iter} PnP "
              f"iters)  PSNR {out['psnr'][str(B)]:5.2f}")
    a, b = (out["first"].pop(str(B)) for B in batches)
    out.pop("first")
    out["first_image_rel_diff"] = float((a - b).norm() / a.norm())
    print(f"the first image's reconstruction at B={batches[0]} and at B={batches[1]}: relative "
          f"difference {out['first_image_rel_diff']:.1e}")
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)
