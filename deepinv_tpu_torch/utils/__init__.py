"""Utilities of the port (deepinv_tpu/utils/).

The names the JAX package takes from other subpackages (``load_image``, the
phantom datasets, ``MRIMixin``, ``patch_extractor``) resolve at first use, so
that those subpackages may import ``deepinv_tpu_torch.utils`` modules
(utils/__init__.py:27-50). Helpers that need the network refuse, as the JAX
package's do. Importing the package needs none of matplotlib, h5py, PIL or
pydicom: the readers and the plots import them where a file is read or a
figure made.
"""

from ..core.tensorlist import TensorList
from .decorators import (deprecate_attribute, deprecated_alias, deprecated_argument,
                         deprecated_class, deprecated_func, deprecated_func_replaced_by)
from .functional import (complex_abs, devices_equal, dirac, dirac_comb, dirac_comb_like,
                         dirac_like, get_device, get_timestamp, normalize_signal, ones_like,
                         rand_like, randn_like, resize_pad_square_tensor, zeros_like)
from .io import (DownloadError, get_cache_home, get_data_home, load_dicom, load_example,
                 load_ismrmd, load_mat, load_nifti, load_np, load_raster, load_tiff, load_url)
from .logger import AverageMeter, CSVLogger, ProgressMeter
from .mixins import (TiledMixin2d, TimeMixin, image_to_patches, patches_to_image, patchify,
                     tiled_apply)
from .plotting import (plot, plot_curves, plot_inset, plot_ortho3D, plot_parameters,
                       plot_videos, prepare_images, preprocess_img, rescale_img, save_videos,
                       scatter_plot)
from .profiling import compiled_cost, timeit, trace

__all__ = ["AverageMeter", "ProgressMeter", "CSVLogger", "TimeMixin", "TiledMixin2d",
           "tiled_apply", "image_to_patches", "patches_to_image", "patchify", "trace",
           "compiled_cost", "timeit", "deprecated_alias", "deprecated_argument",
           "deprecated_func", "deprecated_class", "deprecated_func_replaced_by",
           "deprecate_attribute", "complex_abs", "dirac", "dirac_like", "dirac_comb",
           "dirac_comb_like", "ones_like", "zeros_like", "rand_like", "randn_like",
           "get_timestamp", "get_device", "devices_equal", "normalize_signal",
           "resize_pad_square_tensor", "DownloadError", "load_np", "load_mat", "load_tiff",
           "load_url", "load_example", "load_dicom", "load_nifti", "load_ismrmd", "load_raster",
           "get_cache_home", "get_data_home", "plot", "plot_curves", "plot_parameters",
           "plot_inset", "scatter_plot", "rescale_img", "preprocess_img", "prepare_images",
           "plot_videos", "save_videos", "plot_ortho3D", "TensorList", "SheppLoganDataset",
           "RandomPhantomDataset",
           "MRIMixin", "patch_extractor", "load_image", "download_example", "load_url_image",
           "load_np_url", "load_torch_url", "load_dataset", "load_degradation", "get_image_url",
           "get_degradation_url", "get_freer_gpu", "load_torch", "enable_tex", "disable_tex",
           "torch2cpu", "make_grid", "plot_napari", "get_GSPnP_params"]

_LAZY = {
    "SheppLoganDataset": ("..datasets.phantoms", "SheppLoganDataset"),
    "RandomPhantomDataset": ("..datasets.phantoms", "RandomPhantomDataset"),
    "MRIMixin": ("..physics.mri", "MRIMixin"),
    "patch_extractor": ("..optim.epll", "patch_extractor"),
    "load_image": ("..datasets.folder", "load_image"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(mod, __name__), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_LAZY))


def _no_network(name):
    raise RuntimeError(f"{name} needs network access, which the port does not use; place the "
                       "files locally and load them from their paths")


def download_example(name, **kwargs):
    """Refused (utils/__init__.py:60): no downloads."""
    _no_network("download_example")


def load_url_image(url, **kwargs):
    _no_network("load_url_image")


def load_np_url(url, **kwargs):
    _no_network("load_np_url")


def load_torch_url(url, **kwargs):
    _no_network("load_torch_url")


def load_dataset(name, **kwargs):
    _no_network("load_dataset")


def load_degradation(name, **kwargs):
    _no_network("load_degradation")


def get_image_url(name: str) -> str:
    """The URL of a named example image on the reference's hub (a string;
    utils/__init__.py:85)."""
    return f"https://huggingface.co/datasets/deepinv/images/resolve/main/{name}?download=true"


def get_degradation_url(name: str) -> str:
    return (f"https://huggingface.co/datasets/deepinv/degradations/resolve/main/{name}"
            "?download=true")


def get_freer_gpu():
    """The CUDA device with the most free memory (utils/__init__.py:95);
    raises without one."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("get_freer_gpu needs a CUDA device")
    free = [torch.cuda.mem_get_info(i)[0] for i in range(torch.cuda.device_count())]
    return torch.device("cuda", max(range(len(free)), key=free.__getitem__))


def load_torch(path, weights_only: bool = True, **kwargs):
    """A ``torch.save`` file loaded onto the CPU (utils/__init__.py:102);
    ``weights_only`` unpickles tensors and containers only."""
    import torch

    return torch.load(path, map_location="cpu", weights_only=weights_only, **kwargs)


def enable_tex():
    """Matplotlib's TeX rendering on (utils/__init__.py:118)."""
    import matplotlib

    matplotlib.rcParams.update({"text.usetex": True})


def disable_tex():
    import matplotlib

    matplotlib.rcParams.update({"text.usetex": False})


def torch2cpu(x):
    """A tensor (or array-like) as a numpy array on the host."""
    import numpy as np

    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def make_grid(imgs, nrow: int = 8, padding: int = 2):
    """A batch ``(B, C, H, W)`` tiled into one ``(C, H', W')`` grid of
    ``nrow`` images a row (utils/__init__.py:142), as numpy."""
    import numpy as np

    a = torch2cpu(imgs)
    B, C, H, W = a.shape
    rows = -(-B // nrow)
    out = np.zeros((C, rows * (H + padding) + padding, nrow * (W + padding) + padding), a.dtype)
    for i in range(B):
        r, c = divmod(i, nrow)
        y0, x0 = padding + r * (H + padding), padding + c * (W + padding)
        out[:, y0:y0 + H, x0:x0 + W] = a[i]
    return out


def plot_napari(*args, **kwargs):
    raise ImportError("plot_napari requires napari, which the port does not use")


def get_GSPnP_params(problem: str, noise_level_img: float):
    """``(lamb, sigma_denoiser, stepsize, max_iter)`` of the GSPnP experiments
    (utils/__init__.py:166)."""
    if problem == "deblur":
        lamb, max_iter = 0.1, 500
    elif problem == "super-resolution":
        lamb, max_iter = 0.065, 500
    elif problem == "inpaint":
        lamb, max_iter = 0.1, 100
    else:
        raise ValueError(f"unknown problem {problem!r}")
    return lamb, 1.8 * noise_level_img, 1.0, max_iter
