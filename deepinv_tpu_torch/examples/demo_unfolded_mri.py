"""MoDL on accelerated MRI (port of examples/demo_unfolded_mri.py): an
unrolled network of 3 iterations trained by the ``Trainer`` for 5 epochs on
16 shifted 64x64 Shepp-Logan phantoms (the 2-channel complex convention),
measured online through a random 4x Cartesian mask with noise 0.01; the
training loss falls and the PSNR rises.
"""

import numpy as np
import torch

from ..datasets import ArrayDataset, DataLoader, shepp_logan
from ..loss import PSNR
from ..models import MoDL
from ..physics import MRI, GaussianNoise
from ..physics.generator import RandomMaskGenerator
from ..training import Trainer
from . import _util


def main(device=None, fast=False, size=None, epochs=None):
    dev = _util.device(device)
    size = (32 if fast else 64) if size is None else size
    epochs = _util.scale(5, 1, fast) if epochs is None else epochs
    # a toy magnitude dataset in the 2-channel complex convention
    imgs = np.stack([np.roll(shepp_logan(size), (i, -i), (0, 1)) for i in range(16)])
    data = np.stack([imgs, np.zeros_like(imgs)], axis=1).astype(np.float32)
    mask = RandomMaskGenerator((size, size), acceleration=4, device="cpu").step(
        1, generator=_util.generator(0))["mask"][0]
    physics = MRI(mask=mask, img_size=(size, size), noise_model=GaussianNoise(0.01, device=dev),
                  device=dev)
    model = MoDL(num_iter=3, generator=_util.generator(0), device=dev)
    x = torch.from_numpy(data).to(dev)
    y = physics(x, generator=torch.Generator(dev).manual_seed(2))
    psnr = PSNR()
    with torch.no_grad():
        before = float(psnr(model(y, physics), x).mean())
    trainer = Trainer(model, physics,
                      train_dataloader=DataLoader(ArrayDataset(data), batch_size=4, shuffle=True),
                      online_measurements=True, epochs=epochs, metrics=PSNR(), verbose=False)
    trainer.train()
    with torch.no_grad():
        after = float(psnr(model(y, physics), x).mean())
    out = {"loss_history": list(trainer.loss_history), "psnr_before": before,
           "psnr_after": after}
    print(f"loss {out['loss_history'][0]:.5f} -> {out['loss_history'][-1]:.5f}, "
          f"PSNR {before:.2f} -> {after:.2f} dB")
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)
