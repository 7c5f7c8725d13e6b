"""Losses and metrics of the port (deepinv_tpu/loss/)."""

from .base import Loss
from .losses import EILoss, MCLoss, SupLoss, SureGaussianLoss
from .metric import MSE, PSNR, Metric, cal_psnr

__all__ = ["Loss", "SupLoss", "MCLoss", "EILoss", "SureGaussianLoss", "Metric", "MSE", "PSNR",
           "cal_psnr"]
