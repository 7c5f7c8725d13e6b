"""The HDF5 dataset file convention, end to end (port of
examples/demo_hdf5_convention.py): ``generate_dataset`` writes named
splits with the physics parameters as flat members (x, y and sigma per
split, sigmas drawn by a ``SigmaGenerator``), and ``HDF5Dataset`` reads
them back with the parameters, batched by the ``DataLoader``; a file
written by hand with free-form split names and a measurement-only split
(its ground truth a NaN placeholder); stacked measurements of two
operators, read as a ``TensorList``; and a transform that applies to the
ground truth only. The images are 64x64 Shepp-Logan phantoms (32x32 in the
fast mode, as the JAX demo's). h5py is imported when the demo runs.
"""

import os
import tempfile

import numpy as np
import torch

from ..datasets import DataLoader, HDF5Dataset, TensorDataset, generate_dataset, shepp_logan
from ..physics import Denoising, GaussianNoise, Inpainting
from ..physics.generator import SigmaGenerator
from . import _util


def main(device=None, fast=False):
    dev = _util.device(device)
    import h5py

    H = 32 if fast else 64
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        # 1. generate_dataset writes the convention
        xs = torch.stack([torch.from_numpy(shepp_logan(H)) for _ in range(6)])[:, None]
        physics = Denoising(noise_model=GaussianNoise(0.1, device="cpu"))
        path = generate_dataset(TensorDataset(x=xs[:4]), physics, tmp,
                                test_dataset=TensorDataset(x=xs[4:]),
                                physics_generator=SigmaGenerator(device="cpu"), batch_size=2,
                                generator=_util.generator(0))
        with h5py.File(path, "r") as f:
            out["members"] = sorted(f.keys())  # x, y and sigma of each split, flat
        print("members:", out["members"])
        ds = HDF5Dataset(path, split="train", load_physics_generator_params=True)
        x, y, params = ds[0]
        out["train_item"] = {"x": list(x.shape), "y": list(y.shape), "params": list(params)}
        print(f"train item: x{tuple(x.shape)} y{tuple(y.shape)} params={list(params)}")
        # the parameters ride the DataLoader as a dict of stacked arrays
        xb, yb, pb = next(iter(DataLoader(ds, batch_size=2)))
        xb, pb = torch.as_tensor(xb).to(dev), {k: torch.as_tensor(v).to(dev)
                                               for k, v in pb.items()}
        out["batch"] = {"x": list(xb.shape), "sigma": list(pb["sigma"].shape)}
        print(f"batch: x{tuple(xb.shape)} sigma{tuple(pb['sigma'].shape)} on {xb.device}")

        # 2. free-form split names and a measurement-only split
        p2 = os.path.join(tmp, "byhand.h5")
        mask = (np.random.default_rng(0).random((1, H, H)) < 0.6).astype(np.float32)
        inp = Inpainting((1, H, H), mask=torch.from_numpy(mask), device="cpu")
        with h5py.File(p2, "w") as f:
            f["x_val"] = xs[:2].numpy()
            f["y_val"] = inp.A(xs[:2]).numpy()
            f["mask_val"] = np.stack([mask, mask])       # read back as a parameter
            f["y_deploy"] = inp.A(xs[2:4]).numpy()       # no ground truth
        val = HDF5Dataset(p2, split="val", load_physics_generator_params=True)
        xv, yv, pv = val[0]
        out["val"] = {"x": list(np.asarray(xv).shape), "params": list(pv)}
        print(f"val: x{np.asarray(xv).shape} params={list(pv)}")
        xd, yd = HDF5Dataset(p2, split="deploy")[0]
        out["deploy_x_nan"] = bool(np.isnan(np.asarray(xd)).all())
        out["deploy_y"] = list(yd.shape)
        print(f"deploy: the ground truth is a NaN placeholder -> {out['deploy_x_nan']}; "
              f"y{tuple(yd.shape)}")

        # 3. stacked multi-operator measurements -> TensorList
        p3 = os.path.join(tmp, "stacked.h5")
        with h5py.File(p3, "w") as f:
            f.attrs["stacked"] = 2
            f["x_train"] = xs[:3].numpy()
            f["y0_train"] = inp.A(xs[:3]).numpy()      # operator 0
            f["y1_train"] = xs[:3].numpy() + 0.05      # operator 1
        x3, y3 = HDF5Dataset(p3, split="train")[0]
        out["stacked_parts"] = [list(p.shape) for p in y3.x]
        print(f"stacked: y is a TensorList of {len(y3.x)} parts, shapes "
              f"{[tuple(p.shape) for p in y3.x]}")

        # 4. the dtype, and a transform of the ground truth only
        ds32 = HDF5Dataset(path, split="train", dtype=np.float32,
                           transform=lambda v: v[..., : H // 2, : H // 2])
        xt, yt = ds32[0]
        out["transform"] = {"x": list(xt.shape), "y": list(yt.shape)}
        print(f"the transform applies to x only: x{tuple(xt.shape)} vs y{tuple(yt.shape)}")
    out["H"] = H
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)
