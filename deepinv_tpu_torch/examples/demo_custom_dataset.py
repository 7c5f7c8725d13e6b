"""Creating a measurement dataset offline and training on it (port of
examples/demo_custom_dataset.py).

``generate_dataset`` measures every image of a base dataset once and writes
the ``(x, y)`` pairs to HDF5 (h5py); ``HDF5Dataset`` serves them to the
``Trainer`` without simulating the physics again. A small DnCNN learns to
deblur 32x32 images of random circles in 5 epochs.
"""

import tempfile

import numpy as np
import torch

from ..datasets import ArrayDataset, DataLoader, HDF5Dataset, generate_dataset, random_circles
from ..loss import PSNR, SupLoss
from ..models import ArtifactRemoval, DnCNN
from ..ops import gaussian_blur
from ..physics import BlurFFT, GaussianNoise
from ..training import Trainer
from . import _util


def main(device=None, fast=False, epochs=None):
    dev = _util.device(device)
    epochs = _util.scale(5, 1, fast) if epochs is None else epochs
    # your own images: any indexable dataset of (C, H, W) arrays
    imgs = np.stack([random_circles(32, seed=i) for i in range(40)])
    base_train, base_test = ArrayDataset(imgs[:32]), ArrayDataset(imgs[32:])
    physics = BlurFFT((1, 32, 32), filter=gaussian_blur(sigma=1.0),
                      noise_model=GaussianNoise(0.03, device="cpu"), device="cpu")

    with tempfile.TemporaryDirectory() as save_dir:
        # offline measurement generation -> HDF5
        path = generate_dataset(base_train, physics, save_dir, test_dataset=base_test,
                                batch_size=8, generator=_util.generator(0))
        train_ds, test_ds = HDF5Dataset(path, train=True), HDF5Dataset(path, train=False)
        x0, y0 = train_ds[0]
        print(f"HDF5 dataset at {path}: {len(train_ds)} train / {len(test_ds)} test pairs, "
              f"x {tuple(x0.shape)}, y {tuple(y0.shape)}")

        # supervised training on the stored pairs
        physics = physics.to(dev)
        model = ArtifactRemoval(DnCNN(1, 1, depth=5, nf=16, device=dev,
                                      generator=_util.generator(0)), mode="adjoint")
        trainer = Trainer(model, physics,
                          optimizer=torch.optim.Adam(model.parameters(), lr=1e-3),
                          train_dataloader=DataLoader(train_ds, batch_size=8, shuffle=True),
                          eval_dataloader=DataLoader(test_ds, batch_size=8),
                          online_measurements=False, losses=SupLoss(), metrics=PSNR(),
                          epochs=epochs, verbose=False)
        trainer.train()
        results = trainer.test(DataLoader(test_ds, batch_size=8))
    out = {"n_train": len(train_ds), "n_test": len(test_ds),
           "psnr_test": float(results["PSNR"]), "loss_history": list(trainer.loss_history)}
    print({k: round(float(v), 2) for k, v in results.items()})
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)
