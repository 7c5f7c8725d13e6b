"""Datasets and the loader (port of deepinv_tpu/datasets/base.py).

A dataset is anything with ``__len__`` and ``__getitem__`` returning arrays
(numpy or torch) or tuples of them. :class:`DataLoader` batches in the JAX
package's order: ``RandomState(seed + epoch)`` shuffles and ``drop_last``, so
that both packages see the same batches. Batches are numpy where the items
are numpy and torch where they are torch tensors (kept on their device); the
trainer moves them to the model's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.tensorlist import TensorList
from ..utils.mixins import TiledMixin2d

__all__ = ["ImageDataset", "ArrayDataset", "TensorDataset", "DataLoader", "PatchDataset",
           "RandomPatchSampler", "random_split", "check_dataset"]


class ImageDataset:
    """Base class of imaging datasets (base.py:16). ``__getitem__`` returns
    ``x``, ``(x, y)``, ``(x, params)`` or ``(x, y, params)``."""

    def check_dataset(self) -> None:
        check_dataset(self)

    def __len__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise NotImplementedError


def _leaf(v) -> bool:
    return (isinstance(v, (np.ndarray, torch.Tensor)) or hasattr(v, "shape")
            or (np.isscalar(v) and not isinstance(v, str)))


def check_dataset(dataset) -> None:
    """Raise unless ``dataset[0]`` has one of the supported formats
    (base.py:33)."""
    item = dataset[0]
    params = lambda d: isinstance(d, dict) and all(
        isinstance(k, str) and _leaf(v) for k, v in d.items())
    if _leaf(item):
        return
    if isinstance(item, (tuple, list)):
        if len(item) == 2 and _leaf(item[0]) and (_leaf(item[1]) or params(item[1])):
            return
        if len(item) == 3 and _leaf(item[0]) and _leaf(item[1]) and params(item[2]):
            return
        raise RuntimeError("dataset must return x, (x, y), (x, params) or (x, y, params); "
                           f"got tuple of length {len(item)}")
    raise RuntimeError(f"dataset returned unsupported type {type(item)}")


def _as_array(a):
    return a if isinstance(a, torch.Tensor) else np.asarray(a)


class ArrayDataset(ImageDataset):
    """In-memory dataset over one or more aligned arrays (base.py:59): numpy
    arrays, or torch tensors (on any device)."""

    def __init__(self, *arrays):
        self.arrays = [_as_array(a) for a in arrays]
        n = len(self.arrays[0])
        if any(len(a) != n for a in self.arrays):
            raise ValueError("the arrays of an ArrayDataset must have the same length")

    def __len__(self):
        return len(self.arrays[0])

    def __getitem__(self, i):
        items = tuple(a[i] for a in self.arrays)
        return items if len(items) > 1 else items[0]


class TensorDataset(ImageDataset):
    """Dataset over keyword arrays ``x``, ``y``, ``params`` (base.py:87); a
    missing ``x`` yields NaN placeholders."""

    def __init__(self, *, x=None, y=None, params=None):
        if x is None and y is None:
            raise ValueError("at least one of x or y must be given")
        self._x = None if x is None else _as_array(x)
        self._y = None if y is None else _as_array(y)
        self._params = params
        if self._x is not None and self._y is not None and len(self._x) != len(self._y):
            raise ValueError(f"x and y must have the same leading dim, got {len(self._x)} vs "
                             f"{len(self._y)}")

    @property
    def x(self):
        return self._x

    @property
    def y(self):
        return self._y

    @property
    def params(self):
        return self._params

    def __len__(self):
        return len(self.x) if self.x is not None else len(self.y)

    def __getitem__(self, i):
        out = [self.x[i] if self.x is not None else np.float32(np.nan)]
        if self.y is not None:
            out.append(self.y[i])
        if self.params is not None:
            out.append({k: _as_array(v)[i] for k, v in self.params.items()})
        return tuple(out) if len(out) > 1 else out[0]


class RandomPatchSampler(ImageDataset):
    """One random patch a volume each time an item is read (base.py:129): a
    directory of ``.npy`` nD volumes (or any ``loader``), channel-first
    patches, patch axes of size 1 squeezed (slices). The coordinates come
    from numpy's ``default_rng(seed)`` in the JAX package's order, so both
    give the same patches.

    :param x_dir: directory of ground truths, or None.
    :param y_dir: directory of measurements, or None (either or both; with
        both, the files the two share, each cut at the same place).
    :param patch_size: an int or one size a spatial axis.
    :param ch_axis: None (a channel axis is added), 0 (channel-first) or -1
        (channel-last, moved first).
    :param seed: the seed of the coordinates' generator.
    """

    def __init__(self, x_dir=None, y_dir=None, patch_size=32, file_format: str = ".npy",
                 ch_axis=None, loader=None, seed=0):
        import os

        if x_dir is None and y_dir is None:
            raise ValueError("provide x_dir and/or y_dir")
        self.loader = loader if loader is not None else np.load
        self.ch_axis = ch_axis
        self.patch_size = patch_size
        self.rng = np.random.default_rng(seed)

        def listdir(d):
            return sorted(f for f in os.listdir(d) if f.endswith(file_format))

        if x_dir is not None and y_dir is not None:
            common = sorted(set(listdir(x_dir)) & set(listdir(y_dir)))
            self.files = [(os.path.join(x_dir, f), os.path.join(y_dir, f)) for f in common]
        elif x_dir is not None:
            self.files = [(os.path.join(x_dir, f), None) for f in listdir(x_dir)]
        else:
            self.files = [(None, os.path.join(y_dir, f)) for f in listdir(y_dir)]
        if not self.files:
            raise FileNotFoundError("no volumes found")

    def _to_chw(self, a):
        a = np.asarray(a, np.float32)
        if self.ch_axis is None:
            return a[None]
        if self.ch_axis == -1:
            return np.moveaxis(a, -1, 0)
        return a

    def __len__(self):
        return len(self.files)

    def load(self, f, start_coords, patch_size=None):
        """The patch of file ``f`` starting at ``start_coords`` (base.py:178);
        a None size keeps the whole axis."""
        ps = self.patch_size if patch_size is None else patch_size
        vol = self._to_chw(self.loader(f))
        if isinstance(ps, int):
            ps = (ps,) * (vol.ndim - 1)
        sl = (slice(None),) + tuple(slice(o, o + p) if p is not None else slice(None)
                                    for o, p in zip(start_coords, ps))
        return vol[sl]

    def __getitem__(self, i):
        xf, yf = self.files[i]
        vol = self._to_chw(self.loader(xf if xf is not None else yf))
        sp = vol.shape[1:]
        ps = self.patch_size
        if isinstance(ps, int):
            ps = (ps,) * len(sp)
        ps = tuple(min(p, s) for p, s in zip(ps, sp))
        start = tuple(self.rng.integers(0, s - p + 1) for p, s in zip(ps, sp))
        sl = (slice(None),) + tuple(slice(o, o + p) for o, p in zip(start, ps))
        flat = tuple(ax + 1 for ax, p in enumerate(ps) if p == 1)

        def cut(v):
            return np.squeeze(v[sl], axis=flat) if flat else v[sl]

        patch = cut(vol)
        if xf is not None and yf is not None:
            return patch, cut(self._to_chw(self.loader(yf)))
        return patch


class PatchDataset(TiledMixin2d, ImageDataset):
    """Patches on a regular grid of a stack of images (base.py:220), with the
    patch geometry of :class:`~deepinv_tpu_torch.utils.TiledMixin2d`
    (``image_to_patches``, ``patches_to_image``, ``get_num_patches``, ...).

    :param imgs: ``(N, C, H, W)`` numpy array or tensor.
    :param patch_size: patch side (or ``(ph, pw)``).
    :param stride: grid step (or ``(sh, sw)``).
    :param transforms: callable applied to each patch.
    """

    def __init__(self, imgs, patch_size: int = 8, stride: int = 4, transforms=None):
        super().__init__(patch_size=patch_size, stride=stride)
        self.imgs = _as_array(imgs)
        self.transforms = transforms
        N, C, H, W = self.imgs.shape
        ph, pw = self.patch_size
        sh, sw = self.stride
        self.per_row = (H - ph) // sh + 1
        self.per_col = (W - pw) // sw + 1
        self.per_img = self.per_row * self.per_col

    def __len__(self):
        return len(self.imgs) * self.per_img

    def __getitem__(self, idx):
        n, r = divmod(idx, self.per_img)
        i, j = divmod(r, self.per_col)
        ph, pw = self.patch_size
        sh, sw = self.stride
        patch = self.imgs[n, :, i * sh:i * sh + ph, j * sw:j * sw + pw]
        return self.transforms(patch) if self.transforms is not None else patch


def random_split(dataset, lengths, seed: int = 0):
    """Random non-overlapping subsets of the given lengths (base.py:255), the
    permutation of ``RandomState(seed)`` as in the JAX package."""
    idx = np.random.RandomState(seed).permutation(len(dataset))
    out, o = [], 0
    for n in lengths:
        out.append(_Subset(dataset, idx[o:o + n]))
        o += n
    return out


class _Subset:
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = np.asarray(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[int(self.indices[i])]


def _collate(items):
    """Stack per-sample items into a batch, recursing through tuples, lists
    and dicts; TensorLists stack part by part (base.py:278)."""
    first = items[0]
    if isinstance(first, (tuple, list)):
        return tuple(_collate([it[k] for it in items]) for k in range(len(first)))
    if isinstance(first, dict):
        return {k: _collate([it[k] for it in items]) for k in first}
    if isinstance(first, torch.Tensor):
        return torch.stack(items)
    if isinstance(first, TensorList):
        return TensorList([torch.stack([it.x[k] for it in items]) for k in range(len(first.x))])
    return np.stack(items)


class DataLoader:
    """Batching iterator over a dataset (base.py:302).

    :param shuffle: shuffle each epoch with ``RandomState(seed + epoch)``.
    :param drop_last: drop the trailing incomplete batch (default True).
    """

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False, seed: int = 0,
                 drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self):
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + self._epoch).shuffle(idx)
        self._epoch += 1
        stop = n - (n % self.batch_size) if self.drop_last else n
        for o in range(0, stop, self.batch_size):
            yield _collate([self.dataset[int(i)] for i in idx[o:o + self.batch_size]])
