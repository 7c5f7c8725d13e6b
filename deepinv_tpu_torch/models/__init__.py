"""Models of the port (deepinv_tpu/models/)."""

from .adm import ADMUNet
from .artifactremoval import ArtifactRemoval
from .base import Denoiser, Reconstructor, handle_sigma
from .bm3d import BM3D
from .classic import (AnscombeDenoiser, BilateralFilter, MedianFilter, TGVDenoiser, TVDenoiser,
                      TVL1Denoiser, WaveletDenoiser, WaveletDictDenoiser,
                      generalized_anscombe_transform, inverse_generalized_anscombe_transform)
from .cnns import DScCP, AutoEncoder, FFDNet, SRResNet
from .convert import load_jax_params, load_torch_checkpoint
from .deal import DEAL
from .dip import ConvDecoder, DeepImagePrior
from .diffunet import DiffUNet, EDMPrecond, GroupNorm
from .dncnn import DnCNN
from .drunet import DRUNet, ResBlock
from .gan import (CSGMGenerator, DCGANDiscriminator, DCGANGenerator, ESRGANDiscriminator,
                  PatchGANDiscriminator)
from .kernel_network import KernelIdentificationNetwork
from .layers import (GELU, AvgPool2d, BatchNorm2d, Conv2d, Conv3d, ConvTranspose2d,
                     ConvTranspose3d, Identity, LeakyReLU, Linear, MaxPool2d, MaxPool3d,
                     PixelShuffle, ReLU, Sequential, UpsampleNearest, conv_nd, conv_transpose_nd,
                     fix_dim)
from .ncsnpp import NCSNpp
from .poisson2sparse import ConvLista, Poisson2Sparse
from .misc_models import Client, EPLLDenoiser, MinusOneOneDenoiserWrapper, ScoreModelWrapper
from .precision import AutocastDenoiser, autocast
from .promptir import PromptIR
from .ram import RAM
from .restormer import Restormer
from .scunet import SCUNet
from .swinir import SwinIR
from .unet import UNet
from .unrolled import PDNet, MoDL, PanNet, PDNet_DualBlock, PDNet_PrimalBlock, VarNet, VarNetBlock
from .utils import test_onesplit, test_pad
from .utils3d import initialize_3d_from_2d
from .vgg import VGG16Features
from .wrappers_models import (ICNN, MMSE, ComplexDenoiser, ComplexDenoiserWrapper,
                              DiffusersDenoiserWrapper, EquivariantDenoiser,
                              EquivariantReconstructor, GSDRUNet, GSPnP,
                              PatchCovarianceNoiseEstimator, TimeAgnosticNet, TimeAveragingNet,
                              WaveletNoiseEstimator, to_complex_denoiser)

__all__ = ["ArtifactRemoval", "Denoiser", "Reconstructor", "handle_sigma", "load_jax_params",
           "load_torch_checkpoint", "DnCNN", "DRUNet", "ResBlock", "AutocastDenoiser", "autocast",
           "test_pad", "test_onesplit", "TVDenoiser", "TVL1Denoiser", "TGVDenoiser",
           "WaveletDenoiser", "WaveletDictDenoiser", "MedianFilter", "BilateralFilter",
           "AnscombeDenoiser", "generalized_anscombe_transform",
           "inverse_generalized_anscombe_transform", "ICNN",
           "Conv2d", "Conv3d", "ConvTranspose2d", "ConvTranspose3d", "Linear", "Sequential", "ReLU",
           "LeakyReLU", "GELU", "Identity", "AvgPool2d", "MaxPool2d", "MaxPool3d",
           "UpsampleNearest", "PixelShuffle", "BatchNorm2d", "conv_nd", "conv_transpose_nd",
           "fix_dim", "initialize_3d_from_2d", "UNet", "FFDNet", "SRResNet", "AutoEncoder",
           "DScCP", "GSDRUNet", "EquivariantDenoiser", "TimeAgnosticNet", "TimeAveragingNet",
           "ComplexDenoiser", "to_complex_denoiser", "MMSE", "WaveletNoiseEstimator",
           "PatchCovarianceNoiseEstimator", "GSPnP", "EquivariantReconstructor",
           "DiffusersDenoiserWrapper", "ComplexDenoiserWrapper", "MoDL", "VarNet", "VarNetBlock",
           "PDNet", "PDNet_PrimalBlock", "PDNet_DualBlock", "PanNet", "MinusOneOneDenoiserWrapper",
           "ScoreModelWrapper", "EPLLDenoiser", "Client", "DiffUNet", "EDMPrecond", "GroupNorm",
           "ADMUNet", "NCSNpp", "Restormer", "PromptIR", "SwinIR", "SCUNet", "RAM",
           "PatchGANDiscriminator", "ESRGANDiscriminator", "DCGANGenerator", "DCGANDiscriminator",
           "CSGMGenerator", "DeepImagePrior", "ConvDecoder", "BM3D", "ConvLista", "Poisson2Sparse",
           "DEAL", "KernelIdentificationNetwork", "VGG16Features"]
