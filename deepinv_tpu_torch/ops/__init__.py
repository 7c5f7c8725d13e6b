"""Operators of the port (deepinv_tpu/ops/)."""

from .conv import filter_fft_2d, gaussian_blur
from .kernels.resblock_chain import resblock_chain

__all__ = ["filter_fft_2d", "gaussian_blur", "resblock_chain"]
