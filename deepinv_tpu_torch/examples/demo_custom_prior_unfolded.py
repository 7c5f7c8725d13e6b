"""A handcrafted prior in a trained unfolded network (port of
examples/demo_custom_prior_unfolded.py): 10 unrolled GD iterations with a
smooth TV prior defined by its cost alone, only the stepsizes and lambdas
learned, by 200 Adam steps on 12 32x32 inpainting problems (half the pixels,
noise 0.03, a fresh draw at every step); the test PSNR rises.
"""

import numpy as np
import torch

from ..datasets import random_circles
from ..loss import PSNR
from ..optim import L2
from ..optim.prior import Prior
from ..physics import GaussianNoise, Inpainting
from ..unfolded import unfolded_builder
from . import _util


class SmoothTV(Prior):
    """``g(x) = sqrt(sum |grad x|^2)``; autograd supplies the gradient."""

    def fn(self, x, *args, **kwargs):
        dx, dy = torch.diff(x, dim=-1), torch.diff(x, dim=-2)
        s = (dx ** 2).reshape(x.shape[0], -1).sum(1) + (dy ** 2).reshape(x.shape[0], -1).sum(1)
        return torch.sqrt(s + 1e-12)


def main(device=None, fast=False, steps=None):
    dev = _util.device(device)
    steps = _util.scale(200, 20, fast) if steps is None else steps
    imgs = torch.from_numpy(np.stack([random_circles(32, seed=i) for i in range(16)]))
    physics = Inpainting((1, 32, 32), mask=0.5, generator=_util.generator(0),
                         noise_model=GaussianNoise(0.03, device="cpu"), device="cpu")
    y_test = physics(imgs[12:], generator=_util.generator(9))
    noise = _util.generator(1)
    y_train = [physics(imgs[:12], generator=noise) for _ in range(steps)]
    physics, x_train, x_test, y_test = (physics.to(dev), imgs[:12].to(dev), imgs[12:].to(dev),
                                        y_test.to(dev))
    net = unfolded_builder("GD", data_fidelity=L2(), prior=SmoothTV(),
                           params_algo={"stepsize": 1.0, "lambda": 0.5, "g_param": 0.0},
                           max_iter=10, trainable_params=("stepsize", "lambda"), device=dev)
    # only the stepsizes and the lambdas are learned
    opt = torch.optim.Adam([net.param_stepsize, net.param_lambda], lr=5e-3)
    psnr = PSNR()

    def test_psnr():
        with torch.no_grad():
            return float(psnr(net(y_test, physics), x_test).mean())

    out = {"psnr_before": test_psnr()}
    print(f"before training: {out['psnr_before']:.2f} dB")
    for it in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = ((net(y_train[it].to(dev), physics) - x_train) ** 2).mean()
        loss.backward()
        opt.step()
    out["psnr_after"] = test_psnr()
    out["stepsize"] = net.params_algo["stepsize"].detach().cpu().tolist()
    out["lambda"] = net.params_algo["lambda"].detach().cpu().tolist()
    print(f"after {steps} steps: {out['psnr_after']:.2f} dB")
    print("learned stepsizes:", np.round(out["stepsize"], 3))
    print("learned lambdas  :", np.round(out["lambda"], 3))
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)
