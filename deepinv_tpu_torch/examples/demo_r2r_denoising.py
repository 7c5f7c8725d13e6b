"""Recorrupted-to-Recorrupted denoising (port of
examples/demo_r2r_denoising.py): a DnCNN of depth 5 fed the noisy image
directly, trained by the ``Trainer`` for 5 epochs on 32 32x32 images with
Gaussian noise of 0.1 drawn online, without clean images: the
``R2RLoss`` re-corrupts each measurement into a pair of independent noisy
copies. Each epoch's loss and train PSNR are returned; the loss falls and
the PSNR rises.
"""

import numpy as np

from ..datasets import ArrayDataset, DataLoader, random_circles
from ..loss import PSNR, R2RLoss
from ..models import ArtifactRemoval, DnCNN
from ..physics import Denoising, GaussianNoise
from ..training import Trainer
from . import _util


def main(device=None, fast=False, epochs=None):
    dev = _util.device(device)
    epochs = _util.scale(5, 2, fast) if epochs is None else epochs
    sigma = 0.1
    data = np.stack([random_circles(32, seed=i) for i in range(32)])
    physics = Denoising(noise_model=GaussianNoise(sigma, device="cpu")).to(dev)
    # 'direct' feeds y straight into the backbone: a trainable denoiser
    model = ArtifactRemoval(DnCNN(1, 1, depth=5, nf=16, generator=_util.generator(0),
                                  device=dev), mode="direct", sigma=sigma)
    trainer = Trainer(model, physics,
                      train_dataloader=DataLoader(ArrayDataset(data), batch_size=8, shuffle=True),
                      online_measurements=True, losses=R2RLoss(sigma=sigma), metrics=PSNR(),
                      epochs=epochs, verbose=False)
    return _util.train_history(trainer, "R2R")


if __name__ == "__main__":
    _util.cli(main, __doc__)
