"""A prior from its cost alone (port of examples/demo_custom_prior.py): a
Huber-TV ``Prior`` subclass defines ``fn`` and autograd gives its gradient;
400 steps of gradient descent with it, with Tikhonov and with exact TV
(whose gradient, too, is autograd's of its cost), on 64x64 inpainting (40%
of the pixels kept, noise 0.05).
"""

import torch

from ..datasets import random_circles
from ..loss import PSNR
from ..optim import L2, Tikhonov, TVPrior, optim_builder
from ..optim.prior import Prior
from ..physics import GaussianNoise, Inpainting
from . import _util


class HuberTV(Prior):
    """``g(x) = sum_i huber(|(Dx)_i|)``: quadratic below ``delta``, linear
    above. Only ``fn`` is defined; ``grad`` is autograd's."""

    def __init__(self, delta: float = 0.05):
        super().__init__()
        self.delta = delta

    def fn(self, x, *args, **kwargs):
        dx = torch.diff(x, dim=-1, append=x[..., -1:])
        dy = torch.diff(x, dim=-2, append=x[..., -1:, :])
        mag = torch.sqrt(dx ** 2 + dy ** 2 + 1e-12)
        d = self.delta
        h = torch.where(mag <= d, 0.5 * mag ** 2 / d, mag - 0.5 * d)
        return h.reshape(x.shape[0], -1).sum(1)


def main(device=None, fast=False):
    dev = _util.device(device)
    x = torch.from_numpy(random_circles(64, seed=4))[None]
    physics = Inpainting((1, 64, 64), mask=0.4, generator=_util.generator(0),
                         noise_model=GaussianNoise(0.05, device="cpu"), device="cpu")
    y = physics(x, generator=_util.generator(1))
    physics, x, y = physics.to(dev), x.to(dev), y.to(dev)
    psnr = PSNR()
    delta = 0.05
    # GD is stable for stepsize < 2 / (1 + lambda L), and Huber-TV's
    # gradient has Lipschitz constant ~ 8 / delta
    priors = [("psnr_tikhonov", "Tikhonov", Tikhonov(), 0.1, 0.9),
              ("psnr_tv", "exact TV", TVPrior(), 0.1, 0.1),
              ("psnr_huber_tv", "Huber TV (custom)", HuberTV(delta=delta), 0.1,
               1.8 / (1 + 0.1 * 8 / delta))]
    out = {"psnr_y": float(psnr(y, x)[0])}
    print(f"measurement PSNR: {out['psnr_y']:6.2f} dB")
    for key, name, prior, lam, step in priors:
        model = optim_builder("GD", data_fidelity=L2(), prior=prior,
                              params_algo={"stepsize": step, "lambda": lam, "g_param": 0.05},
                              max_iter=_util.scale(400, 100, fast), device=dev)
        with torch.no_grad():
            out[key] = float(psnr(model(y, physics), x)[0])
        print(f"{name:>18s}: {out[key]:6.2f} dB")
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)
