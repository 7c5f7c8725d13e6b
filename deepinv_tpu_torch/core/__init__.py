"""Core containers and linear algebra of the port (deepinv_tpu/core/)."""

from .linalg import (CHECK_EVERY, LoopStats, device_while, exact_f32, linear_transpose,
                     loop_stats, power_method, tree_add, tree_axpy, tree_conj, tree_map,
                     tree_norm, tree_real_vdot, tree_scale, tree_sub, tree_vdot, tree_where,
                     tree_zeros_like)
from .tensorlist import TensorList, ones_like, rand_like, randn_like, zeros_like

__all__ = ["TensorList", "zeros_like", "ones_like", "randn_like", "rand_like", "tree_map",
           "tree_add", "tree_sub", "tree_scale", "tree_axpy", "tree_vdot", "tree_real_vdot",
           "tree_norm", "tree_zeros_like", "tree_conj", "tree_where", "power_method",
           "linear_transpose", "exact_f32", "device_while", "LoopStats", "loop_stats",
           "CHECK_EVERY"]
