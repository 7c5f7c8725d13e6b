"""Self-supervised measurement splitting (port of
examples/demo_splitting_loss.py): the ``Trainer`` trains a DnCNN of depth 5
behind the adjoint for 5 epochs on 32 32x32 images measured online through
a 70% inpainting mask with noise 0.02, from the measurements alone. The
``SplittingLoss`` (split ratio 0.8) adapts the model: in training it sees
one part of the measurement and is scored on the rest, and in evaluation it
averages 4 random splits. Each epoch's loss and train PSNR are returned,
and the test PSNR over the 32 images, which is finite.
"""

import numpy as np

from ..datasets import ArrayDataset, DataLoader, random_circles
from ..loss import PSNR, SplittingLoss
from ..models import ArtifactRemoval, DnCNN
from ..physics import GaussianNoise, Inpainting
from ..training import Trainer
from . import _util


def main(device=None, fast=False, epochs=None):
    dev = _util.device(device)
    epochs = _util.scale(5, 3, fast) if epochs is None else epochs
    data = np.stack([random_circles(32, seed=i) for i in range(32)])
    physics = Inpainting((1, 32, 32), mask=0.7, generator=_util.generator(0),
                         noise_model=GaussianNoise(0.02, device="cpu"), device="cpu").to(dev)
    loss = SplittingLoss(split_ratio=0.8, eval_n_samples=4)
    model = ArtifactRemoval(DnCNN(1, 1, depth=5, nf=16, generator=_util.generator(0),
                                  device=dev), mode="adjoint")
    trainer = Trainer(model, physics,
                      train_dataloader=DataLoader(ArrayDataset(data), batch_size=8, shuffle=True),
                      online_measurements=True, losses=loss,  # the Trainer adapts the model
                      metrics=PSNR(), epochs=epochs, verbose=False)
    out = _util.train_history(trainer, "splitting")
    # in evaluation the adapted model averages eval_n_samples random splits
    metrics = trainer.test([DataLoader(ArrayDataset(data), batch_size=8)])
    print({k: round(float(v), 2) for k, v in metrics.items()})
    out["psnr_test"], out["psnr_test_std"] = float(metrics["PSNR"]), float(metrics["PSNR_std"])
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)
