"""Self-supervised equivariant imaging on inpainting (port of
examples/demo_selfsup_ei.py): a DnCNN of depth 5 behind the adjoint, trained
by the ``Trainer`` for 10 epochs on 32 32x32 images measured online through
a 50% inpainting mask with noise 0.02, from the measurements alone, under
the measurement-consistency and equivariant-imaging (shifts) losses. Each
epoch's loss and train PSNR are returned; the loss falls and the PSNR
rises.
"""

import numpy as np

from ..datasets import ArrayDataset, DataLoader, random_circles
from ..loss import EILoss, MCLoss, PSNR
from ..models import ArtifactRemoval, DnCNN
from ..physics import GaussianNoise, Inpainting
from ..training import Trainer
from ..transform import Shift
from . import _util


def main(device=None, fast=False, epochs=None):
    dev = _util.device(device)
    epochs = _util.scale(10, 3, fast) if epochs is None else epochs
    data = np.stack([random_circles(32, seed=i) for i in range(32)])
    physics = Inpainting((1, 32, 32), mask=0.5, generator=_util.generator(0),
                         noise_model=GaussianNoise(0.02, device="cpu"), device="cpu").to(dev)
    model = ArtifactRemoval(DnCNN(1, 1, depth=5, nf=16, generator=_util.generator(0),
                                  device=dev), mode="adjoint")
    trainer = Trainer(model, physics,
                      train_dataloader=DataLoader(ArrayDataset(data), batch_size=8, shuffle=True),
                      online_measurements=True, losses=[MCLoss(), EILoss(Shift(shift_max=0.5))],
                      metrics=PSNR(), epochs=epochs, verbose=False)
    return _util.train_history(trainer, "EI")


if __name__ == "__main__":
    _util.cli(main, __doc__)
