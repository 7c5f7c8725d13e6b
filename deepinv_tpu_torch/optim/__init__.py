"""Optimization of the port (deepinv_tpu/optim/)."""

from .data_fidelity import L2, DataFidelity, StackedPhysicsDataFidelity
from .fixed_point import FixedPoint
from .iterators import (ADMMIteration, CPIteration, DRSIteration, FISTAIteration, GDIteration,
                        HQSIteration, OptimIterator, PGDIteration, objective_function)
from .linear import bicgstab, conjugate_gradient, least_squares, lsqr, minres
from .optimizers import (ADMM, CP, DRS, FISTA, GD, HQS, PDCP, PGD, BaseOptim, create_iterator,
                         optim_builder)
from .potential import Potential
from .prior import PnP, Prior, ScorePrior, Tikhonov, TVPrior, Zero
from .utils import (AndersonAccelerationConfig, BacktrackingConfig, check_conv,
                    gradient_descent)

__all__ = ["Potential", "DataFidelity", "StackedPhysicsDataFidelity", "L2", "Prior", "Zero",
           "PnP", "ScorePrior", "Tikhonov", "TVPrior", "OptimIterator", "GDIteration",
           "HQSIteration", "PGDIteration", "FISTAIteration", "ADMMIteration", "DRSIteration",
           "CPIteration", "objective_function", "FixedPoint", "BaseOptim", "create_iterator",
           "optim_builder", "PGD", "FISTA", "ADMM", "DRS", "CP", "GD", "HQS", "PDCP",
           "conjugate_gradient", "bicgstab", "minres", "lsqr", "least_squares",
           "gradient_descent", "check_conv", "AndersonAccelerationConfig", "BacktrackingConfig"]
