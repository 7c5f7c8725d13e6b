"""Equivariant splitting (port of examples/demo_equivariant_splitting.py):
a DnCNN of depth 5 behind the adjoint, made equivariant to the rotations by
multiples of 90 degrees (a Monte-Carlo average over the group), trained by
the ``Trainer`` for 8 epochs on 32 32x32 images measured online through a
60% inpainting mask with noise 0.02, under the equivariant splitting loss
(split ratio 0.8), and tested on 8 more. No ground truth is seen in
training. Each epoch's loss and train PSNR are returned, and the test PSNR,
which is finite.
"""

import numpy as np

from ..datasets import ArrayDataset, DataLoader, random_circles
from ..loss import PSNR, EquivariantSplittingLoss
from ..models import ArtifactRemoval, DnCNN, EquivariantReconstructor
from ..physics import GaussianNoise, Inpainting
from ..training import Trainer
from ..transform import Rotate
from . import _util


def main(device=None, fast=False, epochs=None):
    dev = _util.device(device)
    epochs = _util.scale(8, 3, fast) if epochs is None else epochs
    data = np.stack([random_circles(32, seed=i) for i in range(40)])
    train_loader = DataLoader(ArrayDataset(data[:32]), batch_size=8, shuffle=True)
    eval_loader = DataLoader(ArrayDataset(data[32:]), batch_size=8)
    physics = Inpainting((1, 32, 32), mask=0.6, generator=_util.generator(0),
                         noise_model=GaussianNoise(0.02, device="cpu"), device="cpu").to(dev)
    # the Monte-Carlo average over the rotation group makes the
    # reconstructor commute with each rotation
    base = ArtifactRemoval(DnCNN(1, 1, depth=5, nf=16, generator=_util.generator(0),
                                 device=dev), mode="adjoint")
    model = EquivariantReconstructor(base, transform=Rotate(multiples=90.0))
    loss = EquivariantSplittingLoss(transform=Rotate(multiples=90.0), split_ratio=0.8)
    trainer = Trainer(model, physics, train_dataloader=train_loader,
                      eval_dataloader=eval_loader, online_measurements=True, losses=loss,
                      metrics=PSNR(), epochs=epochs, verbose=False)
    out = _util.train_history(trainer, "equivariant splitting")
    results = trainer.test(eval_loader)
    print("self-supervised (no ground truth seen):",
          {k: round(float(v), 2) for k, v in results.items()})
    out["psnr_test"] = float(results["PSNR"])
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)
