"""Calibrating a physics parameter (port of
examples/demo_optimize_physics_parameter.py): an 11x11 motion-blur kernel
recovered from a known 64x64 image and its blurred, noisy (0.005)
measurement by 1500 FISTA steps on the data fit, differentiated by autograd
through the physics and projected on the simplex, from a centred delta. The
kernel error falls below half its start.
"""

import torch

from ..datasets import random_circles
from ..physics import Blur, GaussianNoise
from ..physics.generator import MotionBlurGenerator
from . import _util


def projection_simplex(v):
    """Each kernel projected on the probability simplex (the sorting method)."""
    shape = v.shape
    v = v.reshape(v.shape[0], -1)
    u = torch.sort(v, dim=-1, descending=True).values
    cssv = torch.cumsum(u, dim=-1) - 1.0
    ind = torch.arange(1, v.shape[1] + 1, device=v.device, dtype=v.dtype)
    rho = (u - cssv / ind > 0).sum(dim=-1, keepdim=True)
    theta = torch.gather(cssv, -1, rho - 1) / rho
    return torch.clamp_min(v - theta, 0.0).reshape(shape)


def main(device=None, fast=False):
    dev = _util.device(device)
    psf_size = (11, 11)
    true_kernel = MotionBlurGenerator(psf_size, device="cpu").step(
        1, generator=_util.generator(0))["filter"]
    x = torch.from_numpy(random_circles(64, seed=3))[None]
    physics = Blur(filter=true_kernel, padding="circular",
                   noise_model=GaussianNoise(0.005, device="cpu"), device="cpu")
    y = physics(x, generator=_util.generator(1))
    physics, x, y, true_kernel = physics.to(dev), x.to(dev), y.to(dev), true_kernel.to(dev)
    k0 = torch.zeros((1, 1) + psf_size, device=dev)
    k0[..., psf_size[0] // 2, psf_size[1] // 2] = 1.0  # a centred delta

    def loss(kernel):
        return 0.5 * ((physics.update(filter=kernel).A(x) - y) ** 2).sum()

    # the exact Lipschitz constant of the kernel's quadratic: max |fft2(x)|^2
    step = 1.0 / float((torch.fft.fft2(x).abs() ** 2).max())
    k, z, t = k0, k0, 1.0
    history = []
    for _ in range(_util.scale(1500, 500, fast)):
        zg = z.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(loss(zg), zg)
        with torch.no_grad():
            k_new = projection_simplex(z - step * g)
            t_new = (1 + (1 + 4 * t ** 2) ** 0.5) / 2
            z = k_new + ((t - 1) / t_new) * (k_new - k)
            k, t = k_new, t_new
            history.append(loss(k))
    out = {"loss_first": float(history[0]), "loss_last": float(history[-1]),
           "kernel_error_start": float((k0 - true_kernel).norm()),
           "kernel_error": float((k - true_kernel).norm())}
    print(f"loss: {out['loss_first']:.5f} -> {out['loss_last']:.5f}")
    print(f"kernel error: {out['kernel_error_start']:.4f} -> {out['kernel_error']:.4f}")
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)
