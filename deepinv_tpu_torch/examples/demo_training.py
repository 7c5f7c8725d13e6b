"""Supervised training with evaluation and checkpoints (port of
examples/demo_training.py): a DnCNN of depth 5 behind the adjoint, trained
by the ``Trainer`` for 6 epochs on 40 32x32 images measured online through
a 60% inpainting mask with noise 0.05, tested on 8 more, checkpointed every
2 epochs; a fresh trainer that loads the last checkpoint reproduces the
test PSNR within 1e-3.
"""

import os
import tempfile

import numpy as np

from ..datasets import ArrayDataset, DataLoader, random_circles
from ..loss import PSNR, SupLoss
from ..models import ArtifactRemoval, DnCNN
from ..physics import GaussianNoise, Inpainting
from ..training import Trainer
from . import _util


def main(device=None, fast=False, epochs=None):
    dev = _util.device(device)
    epochs = _util.scale(6, 2, fast) if epochs is None else epochs
    data = np.stack([random_circles(32, seed=i) for i in range(48)])
    train_loader = DataLoader(ArrayDataset(data[:40]), batch_size=8, shuffle=True)
    eval_loader = DataLoader(ArrayDataset(data[40:]), batch_size=8)
    physics = Inpainting((1, 32, 32), mask=0.6, generator=_util.generator(0),
                         noise_model=GaussianNoise(0.05, device="cpu"), device="cpu").to(dev)

    def model(seed):
        return ArtifactRemoval(DnCNN(1, 1, depth=5, nf=16, generator=_util.generator(seed),
                                     device=dev), mode="adjoint")

    with tempfile.TemporaryDirectory() as ckpt_dir:
        trainer = Trainer(model(1), physics, train_dataloader=train_loader,
                          eval_dataloader=eval_loader, online_measurements=True,
                          losses=SupLoss(), metrics=PSNR(), epochs=epochs, save_path=ckpt_dir,
                          ckpt_interval=2, verbose=False)
        trainer.train()
        results = trainer.test(eval_loader)
        print({k: round(float(v), 2) for k, v in results.items()})
        # the checkpoint round trip: a fresh trainer resumes the weights
        ckpts = sorted(f for f in os.listdir(ckpt_dir) if "ckp" in f)
        print(f"checkpoints written: {ckpts}")
        trainer2 = Trainer(model(2), physics, train_dataloader=train_loader, losses=SupLoss(),
                           metrics=PSNR(), epochs=epochs, online_measurements=True,
                           verbose=False)
        trainer2.load_model(os.path.join(ckpt_dir, ckpts[-1]))
        r2 = trainer2.test(eval_loader)
    out = {"psnr": float(results["PSNR"]), "psnr_resumed": float(r2["PSNR"]),
           "checkpoints": ckpts, "loss_history": list(trainer.loss_history)}
    print(f"the resumed trainer's test PSNR {out['psnr_resumed']:.4f} against "
          f"{out['psnr']:.4f}")
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)
