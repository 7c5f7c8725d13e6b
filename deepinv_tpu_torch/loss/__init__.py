"""Losses and metrics of the port (deepinv_tpu/loss/)."""

from .adversarial import (DiscriminatorLoss, DiscriminatorMetric, GeneratorLoss,
                          SupAdversarialDiscriminatorLoss, SupAdversarialGeneratorLoss,
                          UAIRGeneratorLoss, UnsupAdversarialDiscriminatorLoss,
                          UnsupAdversarialGeneratorLoss)
from .base import Loss
from .losses import EILoss, MCLoss, SupLoss, SureGaussianLoss
from .metric import (ERGAS, L1L2, MAE, MSE, NMSE, PSNR, QNR, SNR, SSIM, LpNorm, Metric,
                     SpectralAngleMapper, cal_mae, cal_mse, cal_psnr, signal_noise_ratio)
from .perceptual import (GMSD, LPIPS, NIQE, BlurStrength, CosineSimilarity, HaarPSI,
                         RecoveryCoefficient, SharpnessIndex)

__all__ = ["Loss", "SupLoss", "MCLoss", "EILoss", "SureGaussianLoss", "Metric", "MSE", "NMSE",
           "MAE", "PSNR", "SNR", "SSIM", "LpNorm", "L1L2", "QNR", "SpectralAngleMapper", "ERGAS",
           "cal_psnr", "cal_mse", "cal_mae", "signal_noise_ratio", "HaarPSI", "GMSD",
           "CosineSimilarity", "RecoveryCoefficient", "BlurStrength", "SharpnessIndex", "NIQE",
           "LPIPS", "DiscriminatorMetric", "GeneratorLoss", "DiscriminatorLoss",
           "SupAdversarialGeneratorLoss", "SupAdversarialDiscriminatorLoss",
           "UnsupAdversarialGeneratorLoss", "UnsupAdversarialDiscriminatorLoss",
           "UAIRGeneratorLoss"]
