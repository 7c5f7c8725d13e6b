"""One operator of each family (port of examples/demo_physics_tour.py):
Blur, BlurFFT, Downsampling, Inpainting, Demosaicing, MRI, CompressedSensing,
SinglePixelCamera and Tomography on a 32x32 image, each held to
adjointness on random vectors (relative error < 1e-3) and to its
pseudo-inverse (``||A A_dagger y - y|| / ||y|| < 0.5``).
"""

import torch

from ..datasets import random_circles
from ..ops import gaussian_blur
from ..physics import (MRI, Blur, BlurFFT, CompressedSensing, Demosaicing, Downsampling,
                       Inpainting, SinglePixelCamera, Tomography)
from . import _util


def operators(H: int, W: int, dev):
    """``(name, physics, x)`` of the tour, each physics built on ``dev``
    from the CPU draws of seed 0."""
    x = torch.from_numpy(random_circles(H, seed=1))[None].to(dev)  # (1, 1, H, W)
    x3 = x.expand(1, 3, H, W)
    col = (torch.arange(W) % 2 == 0).float() * torch.ones(H, W)
    return [
        ("Blur", Blur(filter=gaussian_blur(sigma=1.0), padding="circular", device=dev), x),
        ("BlurFFT", BlurFFT((1, H, W), filter=gaussian_blur(sigma=1.0), device=dev), x),
        ("Downsampling x2", Downsampling((1, H, W), factor=2, filter="gaussian", device=dev), x),
        ("Inpainting 70%", Inpainting((1, H, W), mask=0.7, generator=_util.generator(0),
                                      device="cpu").to(dev), x),
        ("Demosaicing", Demosaicing((3, H, W), device=dev), x3),
        ("MRI 2x", MRI(mask=col, img_size=(H, W), device="cpu").to(dev),
         torch.cat([x, torch.zeros_like(x)], 1)),
        ("CompressedSensing", CompressedSensing(m=256, img_size=(1, H, W),
                                                generator=_util.generator(0),
                                                device="cpu").to(dev), x),
        ("SinglePixelCamera", SinglePixelCamera(m=256, img_size=(1, H, W), device=dev), x),
        ("Tomography 45 views", Tomography(angles=45, img_width=H, normalize=True, device=dev), x),
    ]


def main(device=None, fast=False):
    dev = _util.device(device)
    out = {"adjointness": {}, "dagger_residual": {}}
    with torch.no_grad():
        for i, (name, p, xi) in enumerate(operators(32, 32, dev)):
            y = p.A(xi)
            g = _util.generator(100 + i)
            u = torch.randn(xi.shape, generator=g).to(dev)
            v = torch.randn(y.shape, generator=g).to(dev)
            lhs = torch.vdot(p.A(u).flatten(), v.flatten())
            rhs = torch.vdot(u.flatten(), p.A_adjoint(v).flatten())
            adj = float(abs(lhs - rhs)) / max(float(abs(lhs)), 1e-9)
            res = float((p.A(p.A_dagger(y)) - y).norm() / y.norm())
            out["adjointness"][name], out["dagger_residual"][name] = adj, res
            print(f"{name:22s} y{tuple(y.shape)}  adjointness {adj:.2e}  dagger residual {res:.3f}")
    out["max_adjointness"] = max(out["adjointness"].values())
    out["max_dagger_residual"] = max(out["dagger_residual"].values())
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)
