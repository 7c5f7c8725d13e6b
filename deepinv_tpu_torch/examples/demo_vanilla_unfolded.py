"""Trainable schedules and prior (port of examples/demo_vanilla_unfolded.py):
5 unrolled PnP-PGD iterations whose stepsizes, levels and lambdas are
``nn.Parameter``s of the network beside a small DnCNN's weights, trained
together for 150 Adam steps on 2x super-resolution (Gaussian blur 1.0,
noise 0.01, a fresh draw of the noise at every step) of 12 32x32 images; the
test PSNR rises.
"""

import numpy as np
import torch

from ..datasets import random_circles
from ..loss import PSNR
from ..models import DnCNN
from ..ops import gaussian_blur
from ..optim import L2, PnP
from ..physics import Downsampling, GaussianNoise
from ..unfolded import unfolded_builder
from . import _util


def main(device=None, fast=False, steps=None):
    dev = _util.device(device)
    steps = _util.scale(150, 20, fast) if steps is None else steps
    imgs = torch.from_numpy(np.stack([random_circles(32, seed=i) for i in range(16)]))
    physics = Downsampling((1, 32, 32), factor=2, filter=gaussian_blur(sigma=1.0),
                           noise_model=GaussianNoise(0.01, device="cpu"), device="cpu")
    y_test = physics(imgs[12:], generator=_util.generator(99))
    # the noise of every training step, drawn up front
    noise = _util.generator(0)
    y_train = [physics(imgs[:12], generator=noise) for _ in range(steps)]
    physics, x_train, x_test, y_test = (physics.to(dev), imgs[:12].to(dev), imgs[12:].to(dev),
                                        y_test.to(dev))
    # the schedule and the DnCNN's weights are parameters of one module
    net = unfolded_builder("PGD", data_fidelity=L2(),
                           prior=PnP(DnCNN(1, 1, depth=4, nf=8, generator=_util.generator(0),
                                           device=dev)),
                           params_algo={"stepsize": 1.0, "g_param": 0.05, "lambda": 1.0},
                           max_iter=5, device=dev)
    opt = torch.optim.Adam(net.parameters(), lr=1e-3)
    psnr = PSNR()

    def test_psnr():
        with torch.no_grad():
            return float(psnr(net(y_test, physics), x_test).mean())

    out = {"psnr_initial": test_psnr()}
    print(f"initial test PSNR: {out['psnr_initial']:.2f} dB")
    for it in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = ((net(y_train[it].to(dev), physics) - x_train) ** 2).mean()
        loss.backward()
        opt.step()
        if (it + 1) % 50 == 0:
            print(f"step {it + 1:4d}: train loss {float(loss.detach()):.5f}  "
                  f"test PSNR {test_psnr():.2f} dB")
    out["psnr_final"] = test_psnr()
    out["stepsize"] = net.params_algo["stepsize"].detach().cpu().tolist()
    print("learned stepsize schedule:", np.round(out["stepsize"], 3))
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)
