"""Learned primal-dual for CT (port of
examples/demo_learned_primal_dual.py): a PDNet of 5 iterations trained for
150 Adam steps on 3 shifted 32x32 Shepp-Logan phantoms seen at 24 angles,
against the FBP.
"""

import torch

from ..datasets import shepp_logan
from ..loss.metric import PSNR
from ..models import PDNet
from ..physics import Tomography
from . import _util


def main(device=None, fast=False, steps=None):
    dev = _util.device(device)
    steps = _util.scale(150, 10, fast) if steps is None else steps
    physics = Tomography(img_width=32, angles=24, normalize=True, device=dev)
    x = torch.from_numpy(shepp_logan(32))[None, None].to(dev)
    xs = torch.cat([x, torch.roll(x, 3, dims=-1), torch.roll(x, -3, dims=-2)], 0)
    ys = physics.A(xs)
    model = PDNet(num_iter=5, generator=_util.generator(0), device=dev)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    losses = []
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = ((model(ys, physics) - xs) ** 2).mean()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    psnr = PSNR()
    with torch.no_grad():
        out = {"psnr_fbp": float(psnr(physics.A_dagger(ys), xs).mean()),
               "psnr_xhat": float(psnr(model(ys, physics), xs).mean()),
               "first_loss": losses[0], "final_loss": losses[-1]}
    print(f"FBP: {out['psnr_fbp']:.2f} dB, learned PD ({steps} steps): "
          f"{out['psnr_xhat']:.2f} dB, final loss {out['final_loss']:.5f}")
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)
