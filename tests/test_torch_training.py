"""The port's Trainer against the JAX package's, and the training path of a
bf16 DnCNN (autocast's gradient, the stash kernel's configuration).

In f32 both trainers see the same weights (``load_jax_params``), the same
offline batches and Adam's same update (optax's ``adam`` and
``torch.optim.Adam``: eps outside the square root, bias correction), so their
loss histories and final weights agree to the order of the f32 sums. In bf16
the port's two train-step configurations (``fused_chains``) are held to each
other, and autocast's gradient to ``jax.grad`` through the JAX autocast.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import deepinv_tpu_torch.ops.kernels.conv_chain as cc
from deepinv_tpu.datasets import ArrayDataset as JaxArrayDataset
from deepinv_tpu.datasets import DataLoader as JaxDataLoader
from deepinv_tpu.models import ArtifactRemoval as JaxArtifactRemoval
from deepinv_tpu.models import DnCNN as JaxDnCNN
from deepinv_tpu.models import autocast as jax_autocast
from deepinv_tpu.physics import Denoising as JaxDenoising
from deepinv_tpu.training import Trainer as JaxTrainer
from deepinv_tpu.training import test as jax_test
from deepinv_tpu_torch.datasets import ArrayDataset, DataLoader
from deepinv_tpu_torch.models import ArtifactRemoval, DnCNN, autocast, load_jax_params
from deepinv_tpu_torch.physics import Denoising, GaussianNoise
from deepinv_tpu_torch.training import Trainer
from deepinv_tpu_torch.training import test as port_test
from test_torch_dncnn import _pair
from test_torch_drunet import jax_params


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _data(n, seed, size=16):
    rng = np.random.default_rng(seed)
    x = rng.random((n, 1, size, size)).astype(np.float32)
    return x, (x + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)


def _trainers(case, depth=4, epochs=2, **kw):
    """The JAX and the port's trainer on the same weights and batches.

    Adam divides each gradient element by its running magnitude, so an
    element whose gradient is within f32 rounding (~2e-7 here) of zero takes
    a step of +-lr whose sign is rounding noise; the random DnCNN has such
    elements once two loaders' gradients are summed or the gradient is
    clipped. Those cases run Adam with eps = 1e-3, under which an update is
    linear in gradients below 1e-3, so that the comparison holds the
    trainer's arithmetic and not the sign of rounding noise; the plain case
    runs optax's and PyTorch's default eps (1e-8). Even so a few elements,
    whose gradients cross a kink of the random net's ReLUs, move by up to
    ~2e-4 of their tensor's max, so the weights are held by the relative L2
    error of each tensor (observed <= 4e-5)."""
    ref, port = _pair(depth=depth, seed=7)
    sets = [_data(8, 1)] + ([_data(8, 2)] if case.startswith("multi") else [])
    loaders = lambda DS, DL: [DL(DS(x, y), batch_size=4) for x, y in sets]
    opts = dict(epochs=epochs, verbose=False, **kw)
    if case == "grad_clip":
        opts.update(grad_clip=0.05, check_grad=True)
    if case.startswith("multi"):
        opts.update(optimizer_step_multi_dataset=case == "multi_step")
    eps = 1e-8 if case == "plain" else 1e-3
    x_ev, y_ev = _data(4, 3)
    jt = JaxTrainer(JaxArtifactRemoval(ref), JaxDenoising(),
                    optimizer=optax.adam(1e-3, eps=eps),
                    train_dataloader=loaders(JaxArrayDataset, JaxDataLoader),
                    eval_dataloader=JaxDataLoader(JaxArrayDataset(x_ev, y_ev), batch_size=4),
                    **opts)
    model = ArtifactRemoval(port)
    pt = Trainer(model, Denoising(), optimizer=torch.optim.Adam(model.parameters(), lr=1e-3,
                                                                eps=eps, foreach=False),
                 train_dataloader=loaders(ArrayDataset, DataLoader),
                 eval_dataloader=DataLoader(ArrayDataset(x_ev, y_ev), batch_size=4), **opts)
    return jt, pt


@pytest.mark.parametrize("case", ["plain", "grad_clip", "multi_step", "multi_each"])
def test_trainer_matches_jax_f32(case):
    """``ArtifactRemoval(DnCNN(1, 1, depth=4))`` in f32, offline ``(x, y)``
    pairs, batch 4, 2 epochs, Adam(1e-3): the loss history (relative max
    error) and the final weights (relative L2 error of each tensor) within
    1e-4, the eval PSNR within 1e-3 dB. ``grad_clip``
    clips at 0.05 (every step clips) and records the pre-clip norms, held at
    1e-4; two loaders take one optimizer step over their summed loss
    (``multi_step``) or one each (``multi_each``), in the reference's
    per-step order."""
    jt, pt = _trainers(case)
    jt.train()
    pt.train()
    assert len(pt.loss_history) == 2
    assert _rel(pt.loss_history, jt.loss_history) <= 1e-4
    want = jax_params(jt.model.backbone_net)
    for k, v in pt.model.backbone_net.state_dict().items():
        assert np.linalg.norm(v.numpy() - want[k]) <= 1e-4 * np.linalg.norm(want[k]), k
    assert np.allclose(pt.eval_metrics_history["PSNR"], jt.eval_metrics_history["PSNR"],
                       atol=1e-3, rtol=0)
    if case == "grad_clip":
        assert len(pt.check_grad_val.vals) == 2
        assert _rel(pt.check_grad_val.vals, jt.check_grad_val.vals) <= 1e-4


def test_evaluation_early_stop_and_test_match_jax():
    """Evaluation each epoch with the no-learning baseline, best-model
    tracking and early stopping after one evaluation without improvement
    (lr 0.1 makes the eval PSNR fall), and the standalone ``test``: the same
    histories (within 1e-3 dB), the same stopping epoch and best metric."""
    jt, pt = _trainers("plain", epochs=5, early_stop=1, compare_no_learning=True)
    for t, opt in ((jt, optax.adam(0.1)), (pt, torch.optim.Adam(pt.model.parameters(), lr=0.1))):
        if t is jt:
            t.optimizer, t.opt_state = opt, opt.init(t.model)
        else:
            t.optimizer = opt
    jt.train()
    pt.train()
    assert pt.epochs_run == jt.epochs_run == 4
    assert set(pt.eval_metrics_history) == set(jt.eval_metrics_history)
    for k, v in jt.eval_metrics_history.items():
        assert np.allclose(pt.eval_metrics_history[k], v, atol=1e-3, rtol=0), k
    assert abs(pt.best_metric - jt.best_metric) <= 1e-3
    assert pt.best_model is not pt.model
    x, y = _data(4, 6)
    want = jax_test(jt.model, JaxDataLoader(JaxArrayDataset(x, y), batch_size=2), JaxDenoising(),
                    compare_no_learning=True)
    got = port_test(pt.model, DataLoader(ArrayDataset(x, y), batch_size=2), Denoising(),
               compare_no_learning=True)
    assert set(got) == set(want)
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-3, k


def test_checkpoint_round_trip(tmp_path):
    """``save_model``/``load_model``: a run stopped after epoch 0 and resumed
    from its checkpoint ends where the uninterrupted run ends."""
    _, whole = _trainers("plain", epochs=2)
    whole.train()
    _, first = _trainers("plain", epochs=1, save_path=str(tmp_path))
    first.train()
    _, resumed = _trainers("plain", epochs=2)
    resumed.load_model(str(tmp_path / "ckp_0.pkl"))
    assert resumed.epoch_start == 1 and resumed.loss_history == first.loss_history
    resumed.train()
    assert np.allclose(resumed.loss_history, whole.loss_history, rtol=1e-6, atol=0)
    for (k, a), b in zip(resumed.model.state_dict().items(), whole.model.state_dict().values()):
        assert torch.allclose(a, b, rtol=1e-6, atol=1e-8), k


def _bf16_trainer(fused_chains):
    net = DnCNN(1, 1, depth=6, generator=torch.Generator().manual_seed(3), device="cpu")
    model = ArtifactRemoval(autocast(net))
    x = np.tile(_data(4, 5)[0], (3, 1, 1, 1))
    return Trainer(model, Denoising(GaussianNoise(0.1, device="cpu")),
                   optimizer=torch.optim.Adam(model.parameters(), lr=1e-4),
                   train_dataloader=DataLoader(ArrayDataset(x), batch_size=4), epochs=1,
                   online_measurements=True, verbose=False, fused_chains=fused_chains)


def test_bf16_fused_chains_match_the_reference_configuration(monkeypatch):
    """bf16 DnCNN training with ``fused_chains=True`` (the hidden chain on the
    stash op and its backward; plain versions on the CPU) against the default
    configuration (the layers under autograd), from the same weights on the
    same batches and noise: each step's loss within 2e-2 relative, and the
    loss falls over the three steps in both."""
    calls = []
    stash = cc.conv_chain_stash
    monkeypatch.setattr(cc, "conv_chain_stash", lambda *a: calls.append(1) or stash(*a))
    losses = {}
    for fused in (False, True):
        t = _bf16_trainer(fused)
        t.train()
        losses[fused] = np.array(t.logs_total_loss_train.vals)
        assert len(calls) == (3 if fused else 0)
        assert losses[fused][-1] < losses[fused][0]
    assert np.all(np.abs(losses[True] - losses[False]) <= 2e-2 * np.abs(losses[False]))


def test_autocast_gradient_reaches_the_f32_parameters():
    """The repair of ``autocast``: the gradient of a loss through
    ``autocast(DnCNN)`` reaches the DnCNN's own float32 parameters (which the
    wrapper exposes) through the bf16 cast, and matches ``jax.grad`` through
    the JAX ``autocast(m)`` within 3e-2: the relative max error of the whole
    parameter gradient (observed 2.5e-2). Each tensor's bf16 gradient lies
    2-5% (relative L2) from the f32 gradient in both packages, which round at
    other points (the JAX CPU layers round the conv before the bias and reduce
    the bias gradient in bf16), so a single small tensor, such as the scalar
    bias of ``out_conv``, can differ by that much on its own."""
    ref, port = _pair(depth=5, seed=4)
    rng = np.random.default_rng(9)
    x = rng.random((2, 1, 16, 16)).astype(np.float32)
    t = rng.random((2, 1, 16, 16)).astype(np.float32)

    def jloss(m):
        return jnp.mean((jax_autocast(m)(jnp.asarray(x), 0.1).astype(jnp.float32) - t) ** 2)

    want = jax_params(jax.grad(jloss)(ref))
    den = autocast(port)
    assert {id(p) for p in den.parameters()} == {id(p) for p in port.parameters()}
    ((den(torch.from_numpy(x), 0.1) - torch.from_numpy(t)) ** 2).mean().backward()
    got = []
    for name, p in port.named_parameters():
        assert p.dtype == torch.float32 and p.grad is not None and p.grad.dtype == torch.float32
        got.append((p.grad.numpy().ravel(), want[name].ravel()))
    assert _rel(np.concatenate([g for g, _ in got]), np.concatenate([w for _, w in got])) <= 3e-2


def test_autocast_inference_uses_a_cast_per_weight_version():
    """Without autograd the wrapper runs on cached bf16 casts, made once per
    weight version: repeated calls reuse them, an optimizer step renews them,
    and the output is that of the module with its weights in bf16."""
    port = DnCNN(1, 1, depth=4, generator=torch.Generator().manual_seed(1), device="cpu")
    den = autocast(port)
    x = torch.rand((1, 1, 16, 16), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        first = den(x, 0.1)
        cache = den._cast_cache
        assert torch.equal(den(x, 0.1), first) and den._cast_cache is cache
        bf16 = DnCNN(1, 1, depth=4, device="cpu").to(torch.bfloat16)
        bf16.load_state_dict(port.state_dict())
        assert torch.equal(bf16(x.to(torch.bfloat16), 0.1).float(), first)
        port.out_conv.bias.add_(0.5)
        second = den(x, 0.1)
    assert den._cast_cache is not cache and not torch.equal(second, first)
    assert port.out_conv.bias.dtype == torch.float32


def test_training_modules_import_no_jax():
    """The port stands alone: importing the whole package, each module of
    this slice, and ``chip_smoke``'s phases loads no JAX module and nothing
    of the JAX package."""
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import deepinv_tpu_torch, deepinv_tpu_torch.training.trainer\n"
        "import deepinv_tpu_torch.loss.losses, deepinv_tpu_torch.loss.metric\n"
        "import deepinv_tpu_torch.datasets.base, deepinv_tpu_torch.transform.geometric\n"
        "import deepinv_tpu_torch.utils.logger, deepinv_tpu_torch.physics.inpainting\n"
        "import deepinv_tpu_torch.models.artifactremoval, deepinv_tpu_torch.models.precision\n"
        "import chip_smoke\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in ('jax', 'jaxlib', 'deepinv_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=str(Path(__file__).parents[1]))
    assert proc.returncode == 0, proc.stdout + proc.stderr
