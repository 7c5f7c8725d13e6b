"""Where the port's entry points put their tensors (new in the port).

Physics, models and reconstructors take ``device=None`` and then run on the
CUDA device, as the JAX package runs on its accelerator by default. Without a
CUDA device they raise: the CPU is used only when the caller asks for it.
Weights and operator tables are still built on the CPU (from the caller's
``torch.Generator``) and then moved, so a seed gives the same numbers on
either device.
"""

from __future__ import annotations

import itertools

import torch

__all__ = ["resolve_device", "module_device"]


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA device.

    :raises RuntimeError: if ``device`` is None and CUDA is not available.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError('deepinv_tpu_torch runs on the CUDA device by default and none is '
                           'available: pass device="cpu" to run on the CPU')
    return torch.device("cuda")


def module_device(*modules) -> torch.device:
    """The device of the first parameter or buffer of ``modules`` (each an
    ``nn.Module`` or anything else, which is skipped), else
    :func:`resolve_device` of None."""
    for m in modules:
        if isinstance(m, torch.nn.Module):
            t = next(itertools.chain(m.parameters(), m.buffers()), None)
            if t is not None:
                return t.device
    return resolve_device(None)
