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

__all__ = ["ImageDataset", "ArrayDataset", "TensorDataset", "DataLoader", "check_dataset"]


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


def _collate(items):
    """Stack per-sample items into a batch, recursing through tuples, lists
    and dicts (base.py:278)."""
    first = items[0]
    if isinstance(first, (tuple, list)):
        return tuple(_collate([it[k] for it in items]) for k in range(len(first)))
    if isinstance(first, dict):
        return {k: _collate([it[k] for it in items]) for k in first}
    if isinstance(first, torch.Tensor):
        return torch.stack(items)
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
