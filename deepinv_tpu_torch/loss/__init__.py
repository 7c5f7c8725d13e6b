"""Losses and metrics of the port (deepinv_tpu/loss/): every name the JAX
package's ``deepinv_tpu.loss`` exports."""

from .adversarial import (DiscriminatorLoss, DiscriminatorMetric, GeneratorLoss,
                          SupAdversarialDiscriminatorLoss, SupAdversarialGeneratorLoss,
                          UAIRGeneratorLoss, UnsupAdversarialDiscriminatorLoss,
                          UnsupAdversarialGeneratorLoss)
from .augmentation import (AugmentConsistencyLoss, EquivariantSplittingLoss,
                           ReducedResolutionLoss)
from .base import Loss, StackedPhysicsLoss
from .losses import (EILoss, FNEJacobianSpectralNorm, JacobianSpectralNorm, MCLoss, MOEILoss,
                     MOILoss, R2RLoss, R2RModel, ScoreLoss, ScoreModel, SupLoss,
                     SureGaussianLoss, SurePGLoss, SurePoissonLoss, TVLoss)
from .measplit import Neighbor2Neighbor, SplittingLoss, SplittingModel
from .metric import (ERGAS, L1L2, MAE, MSE, NMSE, PSNR, QNR, SNR, SSIM, LpNorm, Metric,
                     SpectralAngleMapper, cal_mae, cal_mse, cal_psnr, signal_noise_ratio)
from .mri import (Artifact2ArtifactLoss, ENSURELoss, Phase2PhaseLoss, RobustSplittingLoss,
                  WeightedSplittingLoss)
from .perceptual import (GMSD, LPIPS, NIQE, BlurStrength, CosineSimilarity, HaarPSI,
                         RecoveryCoefficient, SharpnessIndex)
from .scheduler import (BaseLossScheduler, InterleavedEpochLossScheduler,
                        InterleavedLossScheduler, RandomLossScheduler, StepLossScheduler)
from .sure import exact_div, hutch_div, mc_div

__all__ = ["Loss", "StackedPhysicsLoss", "Metric", "QNR", "MSE", "NMSE", "MAE", "PSNR", "SNR",
           "SSIM", "LpNorm", "L1L2", "SpectralAngleMapper", "ERGAS", "cal_psnr", "cal_mse",
           "cal_mae", "signal_noise_ratio", "SupLoss", "MCLoss", "EILoss", "MOILoss",
           "MOEILoss", "SureGaussianLoss", "SurePoissonLoss", "SurePGLoss", "R2RLoss",
           "R2RModel", "ScoreLoss", "ScoreModel", "TVLoss", "JacobianSpectralNorm",
           "FNEJacobianSpectralNorm", "SplittingLoss", "SplittingModel", "Neighbor2Neighbor",
           "exact_div", "hutch_div", "mc_div", "BaseLossScheduler", "RandomLossScheduler",
           "InterleavedLossScheduler", "StepLossScheduler", "InterleavedEpochLossScheduler",
           "DiscriminatorMetric", "GeneratorLoss", "DiscriminatorLoss",
           "SupAdversarialGeneratorLoss", "SupAdversarialDiscriminatorLoss",
           "UnsupAdversarialGeneratorLoss", "UnsupAdversarialDiscriminatorLoss",
           "UAIRGeneratorLoss", "WeightedSplittingLoss", "RobustSplittingLoss",
           "Phase2PhaseLoss", "Artifact2ArtifactLoss", "ENSURELoss", "HaarPSI", "GMSD",
           "CosineSimilarity", "RecoveryCoefficient", "BlurStrength", "SharpnessIndex", "NIQE",
           "LPIPS", "AugmentConsistencyLoss", "EquivariantSplittingLoss",
           "ReducedResolutionLoss"]
