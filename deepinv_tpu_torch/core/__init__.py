"""Core containers and linear algebra of the port (deepinv_tpu/core/)."""

from .linalg import (CHECK_EVERY, LoopStats, device_while, loop_stats, power_method, tree_add,
                     tree_axpy, tree_conj, tree_map, tree_norm, tree_real_vdot, tree_scale,
                     tree_sub, tree_vdot, tree_where, tree_zeros_like)
from .tensorlist import TensorList

__all__ = ["TensorList", "tree_map", "tree_add", "tree_sub", "tree_scale", "tree_axpy",
           "tree_vdot", "tree_real_vdot", "tree_norm", "tree_zeros_like", "tree_conj",
           "tree_where", "power_method", "device_while", "LoopStats", "loop_stats",
           "CHECK_EVERY"]
