"""Noise-level and downsampling generators (port of
deepinv_tpu/physics/generator/noise.py)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...ops.conv import bicubic_filter, bilinear_filter, gaussian_blur
from .base import PhysicsGenerator

__all__ = ["SigmaGenerator", "GainGenerator", "DownsamplingGenerator"]


class SigmaGenerator(PhysicsGenerator):
    """``sigma ~ U(sigma_min, sigma_max)`` per sample (noise.py:14)."""

    def __init__(self, sigma_min: float = 0.01, sigma_max: float = 0.5, seed: int = 0,
                 device=None):
        super().__init__(seed=seed, device=device)
        self.sigma_min = sigma_min
        self.sigma_max = sigma_max

    def sample(self, batch_size, draws, **kwargs):
        u = draws.uniform((batch_size,))
        return {"sigma": self.sigma_min + u * (self.sigma_max - self.sigma_min)}


class GainGenerator(PhysicsGenerator):
    """``gain ~ U(gain_min, gain_max)`` per sample (noise.py:29)."""

    def __init__(self, gain_min: float = 0.1, gain_max: float = 0.4, seed: int = 0,
                 device=None):
        super().__init__(seed=seed, device=device)
        self.gain_min = gain_min
        self.gain_max = gain_max

    def sample(self, batch_size, draws, **kwargs):
        u = draws.uniform((batch_size,))
        return {"gain": self.gain_min + u * (self.gain_max - self.gain_min)}


class DownsamplingGenerator(PhysicsGenerator):
    """Random ``(filter, factor)`` of :class:`~deepinv_tpu_torch.physics.Downsampling`
    (noise.py:44): each sample draws a filter among ``filters`` (padded or
    cropped to ``psf_size`` so that they stack); with several factors and a
    batch, one factor is drawn for the whole batch so that the measurements
    share a shape.

    :param filters: names among ``"gaussian"``, ``"bilinear"``, ``"bicubic"``.
    :param factors: candidate integer factors.
    :param psf_size: the ``(h, w)`` every filter is brought to.
    """

    def __init__(self, filters=("gaussian", "bilinear", "bicubic"), factors=(2, 4),
                 psf_size=None, seed: int = 0, device=None):
        super().__init__(seed=seed, device=device)
        self.filters = [filters] if isinstance(filters, str) else list(filters)
        self.factors = [factors] if isinstance(factors, int) else list(factors)
        self.psf_size = tuple(psf_size) if psf_size is not None else None

    def get_kernel(self, filter_str: str = None, factor=None):
        """The filter of a name and factor (noise.py:77)."""
        return self.str2filter(filter_str, factor)

    def str2filter(self, filter_name: str, factor: int):
        """The filter of a name at ``factor``, brought to ``psf_size``
        (noise.py:82): padded, or cropped where it is larger."""
        if filter_name == "gaussian":
            filt = gaussian_blur(sigma=(factor, factor))
        elif filter_name == "bilinear":
            filt = bilinear_filter(factor)
        elif filter_name == "bicubic":
            filt = bicubic_filter(factor)
        else:
            raise ValueError(f"unknown filter {filter_name!r}")
        if self.psf_size is not None:
            dh, dw = self.psf_size[0] - filt.shape[-2], self.psf_size[1] - filt.shape[-1]
            # F.pad crops on negative pads, as torch.nn.functional.pad does
            filt = F.pad(filt, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
        return filt

    def sample(self, batch_size, draws, **kwargs):
        n = len(self.factors)
        if batch_size > 1 and n > 1:
            f_idx = [int(draws.randint(0, n))] * batch_size
        else:
            f_idx = [int(i) for i in draws.randint(0, n, (batch_size,))]
        factors = [self.factors[i] for i in f_idx]
        filt_idx = draws.randint(0, len(self.filters), (batch_size,))
        kernels = [self.str2filter(self.filters[int(i)], f) for i, f in zip(filt_idx, factors)]
        if not all(k.shape == kernels[0].shape for k in kernels):
            raise ValueError("Generated filters have different shapes in batch. Set the "
                             "psf_size argument so all filters share one shape, or limit "
                             "filters/factors to one type per batch.")
        return {"filter": torch.cat(kernels, 0).to(self.device),
                "factor": torch.tensor(factors, device=self.device)}
