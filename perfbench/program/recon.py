"""A PnP reconstruction as a user writes it: ``optim_builder(solver, L2(),
PnP(denoiser), params_algo, max_iter)`` called as ``model(y, physics)``
under ``torch.no_grad()``."""

import torch


def build(solver, denoiser, traffic, device):
    from deepinv_tpu_torch.optim import L2, PnP, optim_builder

    return optim_builder(solver, L2(), PnP(denoiser), params_algo=dict(traffic["params_algo"]),
                         max_iter=traffic["max_iter"], device=device)


def call(model, y, physics):
    with torch.no_grad():
        return model(y, physics)
