"""Equivariant imaging with projective transforms (port of
examples/demo_ei_projective.py): a small DnCNN behind the adjoint trained by
the ``Trainer`` for 3 epochs on 24 32x32 images measured online through a
50% inpainting mask with noise 0.02, under the measurement-consistency and
EI losses, with the shift, the Euclidean and the pan-tilt-rotate groups in
turn; each run's eval PSNR, and its training loss, which falls.
"""

import numpy as np

from ..datasets import ArrayDataset, DataLoader, random_circles
from ..loss import EILoss, MCLoss, PSNR
from ..models import ArtifactRemoval, DnCNN
from ..physics import GaussianNoise, Inpainting
from ..training import Trainer
from ..transform import Euclidean, PanTiltRotate, Shift
from . import _util


def main(device=None, fast=False, epochs=None):
    dev = _util.device(device)
    epochs = _util.scale(3, 2, fast) if epochs is None else epochs
    data = np.stack([random_circles(32, seed=i) for i in range(_util.scale(24, 16, fast))])
    physics = Inpainting((1, 32, 32), mask=0.5, generator=_util.generator(0),
                         noise_model=GaussianNoise(0.02, device="cpu"), device="cpu").to(dev)
    out = {"psnr": {}, "loss_history": {}}
    for i, (name, t) in enumerate([("Shift", Shift(shift_max=0.4)),
                                   ("Euclidean", Euclidean(theta_z_max=10.0, shift_max=0.1)),
                                   ("PanTiltRotate", PanTiltRotate(theta_max=3.0,
                                                                   theta_z_max=10.0))]):
        model = ArtifactRemoval(DnCNN(1, 1, depth=4, nf=8, generator=_util.generator(10 + i),
                                      device=dev), mode="adjoint")
        trainer = Trainer(model, physics,
                          train_dataloader=DataLoader(ArrayDataset(data), batch_size=8,
                                                      shuffle=True),
                          online_measurements=True, losses=[MCLoss(), EILoss(t)],
                          metrics=PSNR(), epochs=epochs, verbose=False)
        trainer.train()
        m = trainer.test([DataLoader(ArrayDataset(data), batch_size=8)])
        out["psnr"][name], out["loss_history"][name] = float(m["PSNR"]), list(trainer.loss_history)
        print(f"EI with {name}: eval PSNR {out['psnr'][name]:.2f} dB, loss "
              f"{trainer.loss_history[0]:.5f} -> {trainer.loss_history[-1]:.5f}")
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)
