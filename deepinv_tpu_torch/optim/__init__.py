"""Optimization of the port (deepinv_tpu/optim/)."""

from .data_fidelity import L2, DataFidelity
from .fixed_point import FixedPoint
from .iterators import HQSIteration, OptimIterator
from .optimizers import BaseOptim, create_iterator, optim_builder
from .potential import Potential
from .prior import PnP, Prior, Zero

__all__ = ["Potential", "DataFidelity", "L2", "Prior", "Zero", "PnP", "OptimIterator",
           "HQSIteration", "FixedPoint", "BaseOptim", "create_iterator", "optim_builder"]
