"""Deep-equilibrium training (port of examples/demo_deq.py): PGD with a
small DnCNN made contractive (``0.9 x + 0.1 net(x)``) run to its fixed point
(30 maps at most), trained for 30 Adam steps through the implicit backward
(20 adjoint products at most) on 8 32x32 inpainting measurements (60% of
the pixels kept, noise 0.02).
"""

import numpy as np
import torch

from ..datasets import random_circles
from ..loss.metric import PSNR
from ..models import DnCNN
from ..optim import L2, PnP
from ..physics import GaussianNoise, Inpainting
from ..unfolded import DEQ_builder
from . import _util


class ContractiveDenoiser(torch.nn.Module):
    """``0.9 x + 0.1 net(x)``: keeps the PGD map contractive, so that the
    equilibrium exists even for a random network."""

    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, x, sigma=None, **kwargs):
        return 0.9 * x + 0.1 * self.net(x, sigma)


def main(device=None, fast=False, steps=None):
    dev = _util.device(device)
    steps = _util.scale(30, 5, fast) if steps is None else steps
    physics = Inpainting((1, 32, 32), mask=0.6, generator=_util.generator(0),
                         noise_model=GaussianNoise(0.02, device="cpu"), device="cpu")
    xs = torch.from_numpy(np.stack([random_circles(32, seed=i) for i in range(8)]))
    ys = physics(xs, generator=_util.generator(1))
    physics, xs, ys = physics.to(dev), xs.to(dev), ys.to(dev)

    net = DnCNN(1, 1, depth=3, nf=8, generator=_util.generator(0), device=dev)
    model = DEQ_builder("PGD", data_fidelity=L2(), prior=PnP(ContractiveDenoiser(net)),
                        params_algo={"stepsize": 0.5, "g_param": 0.05},
                        max_iter=_util.scale(30, 8, fast),
                        max_iter_backward=_util.scale(20, 5, fast), device=dev)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    losses = []
    for i in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = ((model(ys, physics) - xs) ** 2).mean()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        if i % 10 == 0:
            print(f"step {i}: loss {losses[-1]:.5f}")
    psnr = PSNR()
    with torch.no_grad():
        out = {"losses": losses, "psnr_xhat": float(psnr(model(ys, physics), xs).mean()),
               "psnr_y": float(psnr(ys, xs).mean())}
    print(f"trained DEQ PSNR: {out['psnr_xhat']:.2f} dB (measurement {out['psnr_y']:.2f} dB)")
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)
