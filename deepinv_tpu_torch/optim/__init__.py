"""Optimization of the port (deepinv_tpu/optim/)."""

from .data_fidelity import L2, DataFidelity
from .fixed_point import FixedPoint
from .iterators import (ADMMIteration, CPIteration, DRSIteration, FISTAIteration, GDIteration,
                        HQSIteration, OptimIterator, PGDIteration)
from .optimizers import (ADMM, CP, DRS, FISTA, GD, HQS, PDCP, PGD, BaseOptim, create_iterator,
                         optim_builder)
from .potential import Potential
from .prior import PnP, Prior, ScorePrior, TVPrior, Zero

__all__ = ["Potential", "DataFidelity", "L2", "Prior", "Zero", "PnP", "ScorePrior", "TVPrior",
           "OptimIterator", "GDIteration", "HQSIteration", "PGDIteration", "FISTAIteration",
           "ADMMIteration", "DRSIteration", "CPIteration", "FixedPoint", "BaseOptim",
           "create_iterator", "optim_builder", "PGD", "FISTA", "ADMM", "DRS", "CP", "GD", "HQS",
           "PDCP"]
