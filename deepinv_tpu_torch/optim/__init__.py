"""Optimization of the port (deepinv_tpu/optim/): every name the JAX
package's ``deepinv_tpu.optim`` exports."""

from .bregman import Bregman, Bregman_ICNN, BregmanL2, BurgEntropy, NegEntropy
from .data_fidelity import (L1, L2, AmplitudeLoss, DataFidelity, IndicatorL2, ItohFidelity,
                            LogPoissonLikelihood, PoissonLikelihood, StackedPhysicsDataFidelity,
                            ZeroFidelity)
from .distance import (AmplitudeLossDistance, Distance, IndicatorL2Distance, L1Distance,
                       L2Distance, LogPoissonLikelihoodDistance, PoissonLikelihoodDistance,
                       ZeroDistance)
from .dpir import DPIR, get_DPIR_params
from .epll import EPLL, GaussianMixtureModel, patch_extractor
from .fixed_point import FixedPoint
from .iterators import (ADMMIteration, CPIteration, DRSIteration, FISTAIteration, GDIteration,
                        HQSIteration, MDIteration, MLEMIteration, OptimIterator, PGDIteration,
                        PMDIteration, SIRTIteration, SMIteration, objective_function)
from .linear import bicgstab, conjugate_gradient, least_squares, lsqr, minres
from .optimizers import (ADMM, CP, DRS, FISTA, GD, HQS, MD, MLEM, PDCP, PGD, PMD, SIRT, BaseOptim,
                         create_iterator, optim_builder)
from .patch_prior import PatchNR, PatchPrior
from .potential import Potential
from .prior import (RED, L1Prior, L12Prior, PnP, Prior, ScorePrior, Tikhonov, TVL1Prior, TVPrior,
                    WaveletPrior, Zero)
from .utils import (AndersonAccelerationConfig, BacktrackingConfig, DEQConfig, check_conv,
                    gradient_descent)

ZeroPrior = Zero  # the JAX package's alias (optim/__init__.py:84)

__all__ = ["Potential", "Distance", "L2Distance", "IndicatorL2Distance",
           "PoissonLikelihoodDistance", "L1Distance", "AmplitudeLossDistance",
           "LogPoissonLikelihoodDistance", "ZeroDistance", "DataFidelity",
           "StackedPhysicsDataFidelity", "L2", "IndicatorL2", "PoissonLikelihood", "L1",
           "AmplitudeLoss", "LogPoissonLikelihood", "ZeroFidelity", "ItohFidelity", "Prior",
           "Zero", "ZeroPrior", "PnP", "RED", "ScorePrior", "Tikhonov", "L1Prior", "L12Prior",
           "TVPrior", "TVL1Prior", "WaveletPrior", "Bregman", "BregmanL2", "BurgEntropy",
           "NegEntropy", "Bregman_ICNN", "OptimIterator", "GDIteration", "PGDIteration",
           "FISTAIteration", "HQSIteration", "ADMMIteration", "DRSIteration", "CPIteration",
           "MDIteration", "PMDIteration", "SMIteration", "SIRTIteration", "MLEMIteration",
           "objective_function", "FixedPoint", "BaseOptim", "optim_builder", "create_iterator",
           "ADMM", "DRS", "GD", "HQS", "PGD", "FISTA", "MD", "CP", "MLEM", "SIRT", "PMD", "PDCP",
           "DPIR", "get_DPIR_params", "EPLL", "GaussianMixtureModel", "patch_extractor",
           "PatchPrior", "PatchNR", "gradient_descent", "check_conv", "AndersonAccelerationConfig",
           "BacktrackingConfig", "DEQConfig", "conjugate_gradient", "bicgstab", "minres", "lsqr",
           "least_squares"]
