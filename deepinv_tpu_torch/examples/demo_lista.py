"""Learned ISTA (port of examples/demo_lista.py): 8 unfolded PGD iterations
with the l1 prior, their stepsizes and thresholds trained by 50 Adam steps
to recover 16 sparse 8x8 signals from 40 Gaussian measurements; the loss
falls.
"""

import numpy as np
import torch

from ..optim import L1Prior, L2
from ..physics import CompressedSensing
from ..unfolded import unfolded_builder
from . import _util


def main(device=None, fast=False, steps=None):
    dev = _util.device(device)
    steps = _util.scale(50, 8, fast) if steps is None else steps
    physics = CompressedSensing(m=40, img_size=(1, 8, 8), generator=_util.generator(0),
                                device=dev)
    # sparse signals
    rng = np.random.default_rng(0)
    xs = (rng.random((16, 1, 8, 8)) < 0.1).astype(np.float32)
    xs = torch.from_numpy(xs * rng.random((16, 1, 8, 8)).astype(np.float32)).to(dev)
    ys = physics.A(xs)
    model = unfolded_builder("PGD", data_fidelity=L2(), prior=L1Prior(),
                             params_algo={"stepsize": 0.5, "g_param": 0.01}, max_iter=8,
                             trainable_params=["stepsize", "g_param"], device=dev)
    opt = torch.optim.Adam(model.parameters(), lr=5e-3)
    losses = []
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = ((model(ys, physics) - xs) ** 2).mean()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    print(f"LISTA training: loss {losses[0]:.5f} -> {losses[-1]:.5f}")
    return {"losses": losses}


if __name__ == "__main__":
    _util.cli(main, __doc__)
