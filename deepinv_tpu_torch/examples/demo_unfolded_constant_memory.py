"""Constant-memory unfolding (port of
examples/demo_unfolded_constant_memory.py): the gradient of 24 unfolded PnP
iterations with a small DnCNN, with and without recomputing each iteration
in the backward (``remat``, ``torch.utils.checkpoint``); the gradients agree
(the same bits on the CPU; within f32 rounding on the card, where cuDNN
sums in its own order) and, on the card, the peak memory falls.
"""

import torch

from ..datasets import random_circles
from ..models import DnCNN
from ..optim import L2, PnP
from ..physics import GaussianNoise, Inpainting
from ..unfolded import unfolded_builder
from . import _util


def main(device=None, fast=False):
    dev = _util.device(device)
    physics = Inpainting((1, 32, 32), mask=0.6, generator=_util.generator(0),
                         noise_model=GaussianNoise(0.02, device="cpu"), device="cpu")
    x = torch.from_numpy(random_circles(32, seed=0))[None]
    y = physics(x, generator=_util.generator(1))
    physics, x, y = physics.to(dev), x.to(dev), y.to(dev)
    grads, peak = {}, {}
    for remat in (False, True):
        net = DnCNN(1, 1, depth=3, nf=8, generator=_util.generator(0), device=dev)
        model = unfolded_builder("PGD", data_fidelity=L2(), prior=PnP(net),
                                 params_algo={"stepsize": 1.0, "g_param": 0.05},
                                 max_iter=_util.scale(24, 8, fast), remat=remat, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
        loss = ((model(y, physics) - x) ** 2).mean()
        params = list(model.parameters())
        # the schedule's unused entries (lambda, beta, ...) get a zero gradient
        grads[remat] = [torch.zeros_like(p) if g is None else g for p, g in zip(
            params, torch.autograd.grad(loss, params, allow_unused=True))]
        if dev.type == "cuda":
            peak[remat] = torch.cuda.max_memory_allocated(dev) - base
            print(f"remat={remat}: peak memory of the gradient {peak[remat]} bytes")
    err = max(float((a - b).abs().max()) for a, b in zip(grads[False], grads[True]))
    # the random network makes the 24 iterations grow (gradients ~1e5): the
    # difference relative to the largest gradient is what rounding leaves
    rel = err / max(float(b.abs().max()) for b in grads[False])
    print(f"max grad difference remat vs plain: {err:.2e} ({rel:.2e} of the largest)")
    return {"max_grad_difference": err, "max_grad_rel_difference": rel,
            "peak_bytes": {str(k): v for k, v in peak.items()}}


if __name__ == "__main__":
    _util.cli(main, __doc__)
