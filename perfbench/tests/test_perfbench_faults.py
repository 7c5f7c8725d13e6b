"""A whole run with the harness's look for a card skipped, at a size a test
run holds, on the CPU (the port's kernels run their plain versions there):
sound, it comes out correct; with the timed path broken underneath in each
way a recon can break (an iteration that returns its state unchanged, half
of the batch left out, an answer altered where it is produced),
``correct`` comes out false under the cell's own limits."""

import time

import pytest
import torch

from perfbench import harness

SMALL = {
    "drunet.hqs-deblur-256-b16": {"image": {"channels": 3, "height": 32, "width": 32,
                                           "f0": 0.02}, "batch": 2, "pool": 2},
    "dncnn.pgd-mri-320-b16": {"image": {"channels": 2, "height": 40, "width": 40, "f0": 0.02},
                             "batch": 2, "pool": 2},
}
SEED = 2 ** 31 + 77


def run(cell, seconds=0.3):
    return harness.run_cell(cell, SEED, seconds, False, "cpu", time.perf_counter(),
                            overrides=SMALL[cell])


@pytest.mark.parametrize("cell", list(SMALL))
def test_a_sound_run_is_correct(cell):
    res = run(cell)
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"


def _state_unchanged_recon(monkeypatch):
    from deepinv_tpu_torch.optim import iterators

    for cls in (iterators.HQSIteration, iterators.PGDIteration):
        monkeypatch.setattr(cls, "forward", lambda self, X, *a, **k: X)


def _wrap_recon(monkeypatch, alter):
    from deepinv_tpu_torch.optim.optimizers import BaseOptim

    orig = BaseOptim.forward
    monkeypatch.setattr(BaseOptim, "forward", lambda self, y, physics, **k: alter(
        self, orig, y, physics))


def _half_batch_recon(monkeypatch):
    def alter(self, orig, y, physics):
        half = orig(self, y[:y.shape[0] // 2], physics)
        return torch.cat([half, torch.zeros_like(half)])

    _wrap_recon(monkeypatch, alter)


def _answer_altered_recon(monkeypatch):
    def alter(self, orig, y, physics):
        x = orig(self, y, physics).clone()
        x[0] = x[0].flip(-1)
        return x

    _wrap_recon(monkeypatch, alter)


@pytest.mark.parametrize("cell", list(SMALL))
@pytest.mark.parametrize("fault", [_state_unchanged_recon, _half_batch_recon,
                                   _answer_altered_recon], ids=lambda f: f.__name__[1:])
def test_a_broken_recon_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    assert run(cell)["correct"] is False
