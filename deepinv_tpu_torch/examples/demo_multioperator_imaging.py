"""Multi-operator imaging (port of examples/demo_multioperator_imaging.py):
three inpainting operators of 50% with different random masks (noise 0.02),
each with its own loader of the same 32 32x32 images; the ``Trainer`` takes
one batch of each loader a step, measured by its own operator, and trains a
DnCNN of depth 5 behind the adjoint for 4 epochs under the
measurement-consistency loss and the MOI loss, which re-measures the
reconstruction through an operator drawn from the three. Each epoch's loss
and train PSNR are returned, and the trainer's count of operators and
loaders (3).
"""

import numpy as np

from ..datasets import ArrayDataset, DataLoader, random_circles
from ..loss import PSNR, MCLoss, MOILoss
from ..models import ArtifactRemoval, DnCNN
from ..physics import GaussianNoise, Inpainting
from ..training import Trainer
from . import _util


def main(device=None, fast=False, epochs=None):
    dev = _util.device(device)
    epochs = _util.scale(4, 3, fast) if epochs is None else epochs
    data = np.stack([random_circles(32, seed=i) for i in range(32)])
    # several inpainting operators with different random masks
    physics_list = [Inpainting((1, 32, 32), mask=0.5, generator=_util.generator(i),
                               noise_model=GaussianNoise(0.02, device="cpu"),
                               device="cpu").to(dev) for i in range(3)]
    model = ArtifactRemoval(DnCNN(1, 1, depth=5, nf=16, generator=_util.generator(0),
                                  device=dev), mode="adjoint")
    trainer = Trainer(model, physics_list,
                      train_dataloader=[DataLoader(ArrayDataset(data), batch_size=8, shuffle=True)
                                        for _ in physics_list],
                      online_measurements=True, losses=[MCLoss(), MOILoss(physics_list)],
                      metrics=PSNR(), epochs=epochs, verbose=False)
    out = _util.train_history(trainer, "MOI")
    out["operators"] = trainer.G
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)
