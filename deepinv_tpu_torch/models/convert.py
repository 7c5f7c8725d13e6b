"""Weights from the JAX package (new in the port; the JAX package's
models/convert.py ports upstream torch checkpoints the other way).

The port's modules use the JAX modules' attribute names, so a JAX leaf at
tree path ``m_down1.layers.0.conv1.weight`` is the port's state-dict entry of
the same name. Flattening a JAX module into that ``{path: numpy array}``
dictionary needs JAX and is left to the caller.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

__all__ = ["load_jax_params"]


def load_jax_params(module: nn.Module, arrays: dict) -> nn.Module:
    """Copy ``arrays`` (``{dotted path: np.ndarray}``) into ``module``'s
    parameters and buffers, in place, keeping each tensor's dtype and device.

    :raises KeyError: if a key of the module is missing from ``arrays`` or
        ``arrays`` has a key the module does not.
    :raises ValueError: if a shape differs.
    :return: ``module``.
    """
    state = module.state_dict(keep_vars=True)
    missing = sorted(set(state) - set(arrays))
    extra = sorted(set(arrays) - set(state))
    if missing or extra:
        raise KeyError(f"load_jax_params: missing {missing[:8]}, unexpected {extra[:8]} "
                       f"({len(missing)} missing, {len(extra)} unexpected)")
    for k, t in state.items():
        a = np.asarray(arrays[k])
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"load_jax_params: {k} has shape {tuple(a.shape)}, "
                             f"the module expects {tuple(t.shape)}")
    with torch.no_grad():
        for k, t in state.items():
            t.copy_(torch.from_numpy(np.array(arrays[k], dtype=np.float32)))
    return module
