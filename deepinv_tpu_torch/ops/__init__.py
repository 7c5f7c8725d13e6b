"""Operators of the port (deepinv_tpu/ops/)."""

from .conv import (bicubic_filter, bilinear_filter, conv2d, conv2d_fft, conv3d, conv3d_fft,
                   conv_transpose2d, conv_transpose2d_fft, conv_transpose3d,
                   conv_transpose3d_fft, filter_fft_2d, gaussian_blur, kaiser_window,
                   sinc_filter)
from .fourier import dct1d, dct2, dst1, fftc, idct1d, idct2, ifftc
from .imresize import imresize_matlab
from .kernels.conv_chain import conv_chain
from .kernels.resblock_chain import resblock_chain
from .kernels.tv import chambolle_prox
from .misc import ThinPlateSpline, histogram, histogramdd, random_choice
from .nufft import nufft2, nufft2_adjoint, nufft2_normal, nufft2_toeplitz_spec
from .product_convolution import multiplier, product_convolution2d, product_convolution2d_adjoint
from .radon import fanbeam, iradon, radon, radon_output_size, ramp_filter
from .radon_fourier import iradon_fourier, radon_fourier
from .radon_slice import (iradon_slice, radon_slice, radon_slice_adjoint, radon_slice_normal,
                          radon_slice_normal_spec)
from .wavelets import WAVELET_FILTERS, WaveletTransform
from .xray import fdk_weights, geometry_static, ray_integrals, xray_geometry, xray_transform

__all__ = ["conv2d", "conv_transpose2d", "conv3d", "conv_transpose3d", "conv2d_fft",
           "conv_transpose2d_fft", "conv3d_fft", "conv_transpose3d_fft", "filter_fft_2d",
           "gaussian_blur", "bilinear_filter", "bicubic_filter", "kaiser_window", "sinc_filter",
           "dct1d", "idct1d", "dct2", "idct2", "dst1", "fftc", "ifftc", "imresize_matlab",
           "conv_chain", "resblock_chain", "chambolle_prox", "histogram", "histogramdd",
           "ThinPlateSpline", "random_choice", "nufft2", "nufft2_adjoint", "nufft2_normal",
           "nufft2_toeplitz_spec", "multiplier", "product_convolution2d",
           "product_convolution2d_adjoint", "radon", "iradon", "fanbeam",
           "radon_output_size", "ramp_filter", "radon_fourier", "iradon_fourier", "radon_slice",
           "radon_slice_adjoint", "iradon_slice", "radon_slice_normal",
           "radon_slice_normal_spec", "WaveletTransform", "WAVELET_FILTERS", "xray_transform",
           "xray_geometry", "geometry_static", "ray_integrals", "fdk_weights"]
