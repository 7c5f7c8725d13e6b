"""Measurements generated offline to HDF5, and their loader (port of
deepinv_tpu/datasets/datagenerator.py).

The file layout is the JAX package's and the reference's: one file an
operator, ``dinv_dataset{i}.h5``, with ``x_{split}``, ``y_{split}`` and one
flat ``{param}_{split}`` member a physics-generator parameter (:85-95), so a
file written by either package loads in the other. ``h5py`` is imported
where a file is written or opened, so importing the datasets needs neither it
nor PIL.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..core.tensorlist import TensorList
from ..device import module_device
from .base import ImageDataset

__all__ = ["generate_dataset", "HDF5Dataset"]


def generate_dataset(train_dataset, physics, save_dir: str, test_dataset=None,
                     physics_generator=None, batch_size: int = 4,
                     dataset_filename: str = "dinv_dataset", train_datapoints: Optional[int] = None,
                     test_datapoints: Optional[int] = None, generator=None,
                     verbose: bool = False):
    """Write ``(x, y[, params])`` pairs to HDF5 (datagenerator.py:27).

    :param physics: one physics or a list; with several, the train points go
        to the operators round robin (point ``j`` to operator ``j % k``) and
        every operator measures the whole test set.
    :param physics_generator: draws each batch's operator parameters first,
        stored as ``{param}_{split}``.
    :param generator: the ``torch.Generator`` of every draw, on the
        measurements' device (seeded 0 there if None); a batch's parameters
        are drawn before its noise. The measurements are made on the
        physics' device (that of its first tensor, else the CUDA device).
    :returns: the path (one operator) or the list of paths.
    """
    import h5py

    physics_list = list(physics) if isinstance(physics, (list, tuple)) else [physics]
    dev = module_device(*physics_list)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    os.makedirs(save_dir, exist_ok=True)
    paths = []
    for i, p in enumerate(physics_list):
        path = os.path.join(save_dir, f"{dataset_filename}{i}.h5")
        with h5py.File(path, "w") as f:
            for split, dataset, limit in (("train", train_dataset, train_datapoints),
                                          ("test", test_dataset, test_datapoints)):
                if dataset is None:
                    continue
                n = len(dataset) if limit is None else min(limit, len(dataset))
                indices = ([j for j in range(n) if j % len(physics_list) == i]
                           if split == "train" and len(physics_list) > 1 else list(range(n)))
                xs, ys, ps = [], [], []
                for o in range(0, len(indices), batch_size):
                    items = [dataset[j] for j in indices[o:o + batch_size]]
                    xb = np.stack([np.asarray(it[0] if isinstance(it, tuple) else it)
                                   for it in items])
                    phys, params = p, {}
                    if physics_generator is not None:
                        params = physics_generator.step(len(items), generator=generator)
                        phys = p.update(**params)
                    with torch.no_grad():
                        yb = phys(torch.as_tensor(xb, device=dev), generator=generator)
                    xs.append(xb)
                    ys.append(yb.cpu().numpy())
                    ps.append({k: torch.as_tensor(v).cpu().numpy() for k, v in params.items()})
                    if verbose:
                        print(f"{path} {split}: {o + len(items)}/{len(indices)}")
                if not xs:
                    continue
                f.create_dataset(f"x_{split}", data=np.concatenate(xs))
                f.create_dataset(f"y_{split}", data=np.concatenate(ys))
                for k in ps[0]:
                    f.create_dataset(f"{k}_{split}", data=np.concatenate([d[k] for d in ps]))
        paths.append(path)
    return paths[0] if len(paths) == 1 else paths


class HDF5Dataset(ImageDataset):
    """A split of an HDF5 file in the reference's convention
    (datagenerator.py:104): items ``(x, y)`` or ``(x, y, params)`` as numpy
    arrays (``y`` a :class:`TensorList` of tensors for a stacked file).

    Each ``{name}_{split}`` member of the split is a ground truth (``x``), a
    measurement (``y``), one part of a stacked measurement (``y{i}``, with
    the file's ``stacked`` attribute) or, under any other prefix, a physics
    parameter; the older ``params_{split}`` group is read too.

    :param path: the file.
    :param train: the ``train`` or ``test`` split when ``split`` is None.
    :param split: any split name; it takes precedence over ``train``.
    :param transform: callable applied to the ground truth only.
    :param load_physics_generator_params: return each item's parameters.
    :param dtype: cast of real arrays; ``complex_dtype`` of complex ones.
    """

    @property
    def unsupervised(self) -> bool:
        """True when the split stores no ground truth (datagenerator.py:133;
        deprecated there too)."""
        import warnings

        warnings.warn("The attribute 'unsupervised' is deprecated and will be removed in future "
                      "versions. Please check the dataset entries directly instead.",
                      DeprecationWarning)
        if self.x is None:
            return True
        return bool(np.isnan(np.asarray(self.x[0])).all())

    def __init__(self, path: str, train: bool = None, split: str = None, transform=None,
                 load_physics_generator_params: bool = False, dtype=np.float32,
                 complex_dtype=np.complex64):
        import re
        import warnings

        import h5py

        self.path = path
        if split is not None:
            if train is not None:
                warnings.warn("The parameters 'split' and 'train' are both provided. 'split' "
                              "takes precedence and 'train' is ignored.", UserWarning)
            self.split = split
        else:
            self.split = "train" if (train is None or train) else "test"
        self.transform = transform
        self.dtype, self.complex_dtype = dtype, complex_dtype
        self._f = f = h5py.File(path, "r")
        stacked = int(f.attrs.get("stacked", 0))
        suffix = f"_{self.split}"
        self.x = None
        self.y = [None] * stacked if stacked else None
        params, sizes = {}, {}
        for name, member in f.items():
            if not name.endswith(suffix):
                continue
            prefix = name[:-len(suffix)]
            if prefix == "x":
                self.x = member
                sizes["x"] = len(member)
            elif prefix == "y" and not stacked:
                self.y = member
                sizes["y"] = len(member)
            elif stacked and re.fullmatch(r"y(0|[1-9]\d*)", prefix):
                if int(prefix[1:]) < stacked:
                    self.y[int(prefix[1:])] = member
                    sizes[prefix] = len(member)
                else:
                    warnings.warn(f"member {name!r} has stacking index outside [0, {stacked}) — "
                                  "probably an error; ignored", UserWarning)
            elif prefix == "params" and isinstance(member, h5py.Group):
                for k in member:
                    params[k] = member[k]
                    sizes[f"params.{k}"] = len(member[k])
            else:
                params[prefix] = member
                sizes[f"params.{prefix}"] = len(member)
        if self.y is None or (stacked and None in self.y):
            raise ValueError(f"split {self.split!r} of {path} has no (complete) measurements")
        if not load_physics_generator_params:
            sizes = {k: v for k, v in sizes.items() if not k.startswith("params.")}
        if len(set(sizes.values())) > 1:
            warnings.warn(f"fields of split {self.split!r} have different sizes ({sizes}); "
                          "using the minimum", UserWarning)
        self.params = params if load_physics_generator_params else None
        self._len = min(sizes.values())

    def _cast(self, a):
        a = np.asarray(a)
        return a.astype(self.complex_dtype if np.iscomplexobj(a) else self.dtype)

    def __len__(self):
        return self._len

    def __getitem__(self, i):
        if self.x is not None:
            x = self._cast(self.x[i])
            if self.transform is not None:
                x = self.transform(x)
        else:
            x = np.asarray(np.nan, dtype=self.dtype)
        if isinstance(self.y, list):
            y = TensorList([torch.from_numpy(self._cast(yk[i])) for yk in self.y])
        else:
            y = self._cast(self.y[i])
        if self.params is not None:
            return x, y, {k: self._cast(v[i]) for k, v in self.params.items()}
        return x, y

    def close(self):
        self._f.close()
