"""Plain circular blur ``A x = h * x`` by the full complex FFT.

The PSF is an isotropic Gaussian of ``psf_sigma`` pixels on a square of side
``2 ceil(3 sigma) + 1``, summing to 1, centred at index ``(h // 2, w // 2)``;
its transfer function is the FFT of the PSF embedded in the image grid and
rolled so that its centre sits at the origin.
"""

import math

import torch


def make(spec, shape, generator, device):
    """The PSF ``(1, 1, k, k)`` (``generator`` is not needed: the PSF is fixed)."""
    s = spec["psf_sigma"]
    r = math.ceil(3 * s)
    t = torch.arange(-r, r + 1, device=device, dtype=torch.float32)
    g = torch.exp(-(t[:, None] ** 2 + t[None, :] ** 2) / (2 * s * s))
    return {"psf": (g / g.sum())[None, None]}


class Op:
    def __init__(self, tensors, shape):
        psf = tensors["psf"][0, 0]
        H, W = shape[-2:]
        h, w = psf.shape
        f = torch.zeros((H, W), dtype=torch.float32, device=psf.device)
        f[:h, :w] = psf
        f = torch.roll(f, shifts=(-(h // 2), -(w // 2)), dims=(0, 1))
        self.M = torch.fft.fft2(f)

    def A(self, x):
        return torch.fft.ifft2(torch.fft.fft2(x) * self.M).real

    def A_adjoint(self, y):
        return torch.fft.ifft2(torch.fft.fft2(y) * self.M.conj()).real

    def grad(self, x, y):
        return self.A_adjoint(self.A(x) - y)

    def prox_l2(self, z, y, gamma):
        """``argmin_x gamma/2 ||A x - y||^2 + 1/2 ||x - z||^2``."""
        num = self.M.conj() * torch.fft.fft2(y) + torch.fft.fft2(z) / gamma
        return torch.fft.ifft2(num / (self.M.abs() ** 2 + 1.0 / gamma)).real

    def measure(self, x, noise):
        return self.A(x) + noise
