"""Adversarial training of a denoiser (port of
examples/demo_adversarial_training.py): the ``AdversarialTrainer`` trains a
DnCNN of depth 4 against a DCGAN discriminator (16 features) for 4 epochs
on 16 64x64 images with Gaussian noise of 0.1 drawn online, under the
supervised loss plus the adversarial generator loss (weight 0.01), one
generator and one discriminator update a batch of 4. The generator's loss
history has one finite entry an epoch and falls; the discriminator's loss
and the train PSNR of each epoch are returned too.
"""

import numpy as np

from ..datasets import ArrayDataset, DataLoader, random_circles
from ..loss import PSNR, SupAdversarialGeneratorLoss, SupLoss
from ..models import DCGANDiscriminator, DnCNN
from ..physics import Denoising, GaussianNoise
from ..training import AdversarialTrainer
from . import _util


def main(device=None, fast=False, epochs=None, size=64):
    dev = _util.device(device)
    epochs = _util.scale(4, 2, fast) if epochs is None else epochs
    data = np.stack([random_circles(size, seed=i) for i in range(16)])
    trainer = AdversarialTrainer(
        DnCNN(1, 1, depth=4, nf=16, generator=_util.generator(0), device=dev),
        Denoising(noise_model=GaussianNoise(0.1, device="cpu")).to(dev),
        D=DCGANDiscriminator(ndf=16, nc=1, generator=_util.generator(1), device=dev),
        losses=[SupLoss(), SupAdversarialGeneratorLoss(weight_adv=0.01)],
        train_dataloader=DataLoader(ArrayDataset(data), batch_size=4, shuffle=True),
        online_measurements=True, epochs=epochs, metrics=PSNR(), verbose=False)
    logs = _util.train_logged(trainer)
    out = {"epochs": epochs, "loss_history": list(trainer.loss_history),
           "loss_d_history": [l["loss_D"] for l in logs],
           "psnr_history": [l["PSNR"] for l in logs]}
    print("loss history:", [round(l, 4) for l in out["loss_history"]])
    print(f"loss_D {out['loss_d_history'][0]:.3f} -> {out['loss_d_history'][-1]:.3f}, train "
          f"PSNR {out['psnr_history'][0]:.2f} -> {out['psnr_history'][-1]:.2f} dB")
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)
