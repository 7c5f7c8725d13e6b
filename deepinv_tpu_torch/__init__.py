"""deepinv_tpu_torch: the PyTorch/CUDA port of deepinv_tpu, for imaging inverse
problems on an NVIDIA GPU.

The same four abstractions as the JAX package: ``physics(x)`` (forward
operators with ``A``, ``A_adjoint``, ``A_dagger`` and ``prox_l2``),
``denoiser(x, sigma)``, ``model(y, physics)`` and
``loss(x_net=..., x=..., y=..., physics=..., model=...)``, as ``nn.Module``s.
The subpackages carry every public name of their JAX counterparts: ``ops``,
``physics``, ``models``, ``optim`` and ``unfolded``, ``sampling``, ``loss``,
``transform``, ``training``, ``datasets``, ``utils``, ``parallel``,
``native`` and ``serve``. Of ``deepinv_tpu.core``, ``Module`` and the pytree
helpers stay out: ``nn.Module``, ``torch.Generator``
(:mod:`deepinv_tpu_torch.core.rng`) and :mod:`deepinv_tpu_torch.core.linalg`
take their roles.

The main paths run on hand-written sm_90a CUDA kernels
(``deepinv_tpu_torch/csrc``): DRUNet's resblock chains and up tail under
PnP-HQS, DPIR and the samplers; DnCNN's conv chain under PnP-PGD on MRI and
CT, its training forward with the stash and the stash backward under the
Trainer; the Chambolle TV prox under TV reconstruction. On CPU tensors each
kernel op runs its plain PyTorch version.

The JAX package is the reference the port is held to (tests/test_torch_*.py);
this package imports torch and never jax. Its entry points run on the CUDA
device unless the caller passes ``device="cpu"``
(:mod:`deepinv_tpu_torch.device`).
"""

import torch as _torch

# the subpackages that physics imports (through optim and models) come first,
# so that the datasets' MRI classes find physics.mri whole
from . import loss, models, ops, optim, physics  # noqa: I001
from . import datasets, sampling, training, transform, utils
from .core import TensorList

#: the default computation dtype (the JAX package's ``deepinv_tpu.dtype``)
dtype = _torch.float32

_LAZY_NAMES = ("Trainer", "train", "test", "metric", "models", "loss", "sampling", "transform",
               "datasets", "training", "unfolded", "parallel", "utils", "native")


def __getattr__(name):
    """``Trainer``, ``train``, ``test``, ``metric`` (the module
    ``loss.metric``) and the subpackages not imported with the package
    (``unfolded``, ``parallel``, ``native``), at first use
    (deepinv_tpu/__init__.py:50-80)."""
    if name in ("Trainer", "train", "test"):
        return getattr(training, name)
    if name == "metric":
        from .loss import metric

        return metric
    if name in _LAZY_NAMES:
        import importlib

        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_LAZY_NAMES))


__all__ = ["datasets", "loss", "models", "ops", "optim", "physics", "sampling", "training",
           "transform", "utils", "serve", "TensorList", "dtype", "Trainer", "train", "test",
           "metric", "unfolded", "parallel", "native"]

__version__ = "0.1.0"
from . import serve  # noqa: E402
