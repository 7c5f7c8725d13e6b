"""Plain single-coil Cartesian MRI ``y = M F x``.

Images are ``(B, 2, H, W)``: real and imaginary parts. ``F`` is the centred
orthonormal 2D FFT (``fftshift . fft2 . ifftshift``), ``M`` a mask of
k-space columns as fastMRI's ``RandomMaskFunc`` draws it: the
``round(W * center_fraction)`` central columns, and as many others drawn
without replacement as bring the total to ``round(W / acceleration)``.
Noise lands on the sampled entries only.
"""

import torch


def make(spec, shape, generator, device):
    """The mask ``(1, 1, H, W)`` of 0 and 1."""
    H, W = shape[-2:]
    low = round(W * spec["center_fraction"])
    total = round(W / spec["acceleration"])
    start = (W - low + 1) // 2
    cols = torch.zeros(W, device=device)
    cols[start:start + low] = 1.0
    outside = torch.nonzero(cols == 0).flatten()
    pick = torch.randperm(outside.numel(), generator=generator, device=device)[:total - low]
    cols[outside[pick]] = 1.0
    return {"mask": cols.expand(H, W).clone()[None, None]}


def _c(x):
    return torch.complex(x[:, 0], x[:, 1])


def _r(z):
    return torch.stack([z.real, z.imag], dim=1)


def fft(x):
    z = torch.fft.ifftshift(_c(x), dim=(-2, -1))
    return _r(torch.fft.fftshift(torch.fft.fft2(z, norm="ortho"), dim=(-2, -1)))


def ifft(y):
    z = torch.fft.ifftshift(_c(y), dim=(-2, -1))
    return _r(torch.fft.fftshift(torch.fft.ifft2(z, norm="ortho"), dim=(-2, -1)))


class Op:
    def __init__(self, tensors, shape):
        self.mask = tensors["mask"]

    def A(self, x):
        return self.mask * fft(x)

    def A_adjoint(self, y):
        return ifft(self.mask * y)

    def grad(self, x, y):
        return self.A_adjoint(self.A(x) - y)

    def prox_l2(self, z, y, gamma):
        """``argmin_x gamma/2 ||A x - y||^2 + 1/2 ||x - z||^2``: per k-space
        entry, as ``F`` is unitary."""
        k = (gamma * self.mask * y + fft(z)) / (gamma * self.mask + 1.0)
        return ifft(k)

    def measure(self, x, noise):
        return self.mask * (fft(x) + noise)
