"""What the demos share: the fast mode's sizes, the device, and the
command line (``--device``, ``--fast``), the port's counterpart of
``examples/_util.py``.

A demo draws its data and its measurement's noise on the CPU from seeded
``torch.Generator``s and moves them to the device, so a seed gives the same
inputs on the card and on the CPU.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..device import resolve_device


def scale(n: int, fast_n: int = None, fast: bool = False) -> int:
    """``n``, or in the fast mode ``fast_n`` (default ``n // 4``, at least 1)."""
    if not fast:
        return n
    return max(1, fast_n if fast_n is not None else n // 4)


def device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None is the CUDA device.

    :raises RuntimeError: naming ``--device cpu`` where None is given and
        there is no CUDA device; a demo does not fall back to the CPU.
    """
    if device is None and not torch.cuda.is_available():
        raise RuntimeError("the demos run on the CUDA device and none is available: run with "
                           "--device cpu, or call main(device='cpu')")
    return resolve_device(device)


def generator(seed: int) -> torch.Generator:
    """A CPU generator seeded with ``seed``: the draws a demo makes where the
    JAX demo takes ``jax.random.key(seed)`` (or a module's default key 0)."""
    return torch.Generator().manual_seed(seed)


def train_logged(trainer) -> list:
    """``trainer.train()``, returning each epoch's train logs: its running
    ``TotalLoss`` and metrics after its last batch, the numbers of the line
    that the trainer's ``verbose`` prints at the epoch's end."""
    logs, step = [], trainer.step

    def logged(epoch, *args, **kwargs):
        out = step(epoch, *args, **kwargs)
        if kwargs.get("last_batch") and kwargs.get("train", True):
            logs.append({k: float(v) for k, v in out.items()})
        return out

    trainer.step = logged
    try:
        trainer.train()
    finally:
        del trainer.step
    return logs


def train_history(trainer, label: str) -> dict:
    """:func:`train_logged`, as ``loss_history`` (each epoch's mean
    ``TotalLoss``, the trainer's own ``loss_history``) and ``psnr_history``
    (each epoch's mean train PSNR), printed first to last under ``label``."""
    logs = train_logged(trainer)
    out = {"loss_history": [float(l) for l in trainer.loss_history],
           "psnr_history": [l["PSNR"] for l in logs]}
    print(f"{label}: TotalLoss {out['loss_history'][0]:.5f} -> {out['loss_history'][-1]:.5f}, "
          f"train PSNR {out['psnr_history'][0]:.2f} -> {out['psnr_history'][-1]:.2f} dB over "
          f"{len(logs)} epochs")
    return out


def cli(main, doc: str = None) -> dict:
    """Run ``main`` with the command line's ``--device`` and ``--fast``,
    print its numbers as one JSON line (less the reconstructions some demos
    return under ``x_hat``) and return them all."""
    ap = argparse.ArgumentParser(description=doc)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--fast", action="store_true", help="the reduced sizes of the tests")
    args = ap.parse_args()
    out = main(device=args.device, fast=args.fast)
    print(json.dumps({k: v for k, v in out.items() if k != "x_hat"}))
    return out
