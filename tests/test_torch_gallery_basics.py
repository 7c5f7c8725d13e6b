"""The gallery's basics on the port (``deepinv_tpu_torch/examples``), run
in-process on the CPU at their fast sizes, each held to the claim its JAX
demo prints; and what every demo of the gallery shares: it runs on the CUDA
device unless asked, raising without one, its command line, and no import
of JAX.

The JAX demos draw by keys and return nothing, so the numbers are not held
to JAX's bit for bit: each module under a demo is held to JAX by its own
parity test, and the reconstructions of the demos that run the TV prox (the
Chambolle kernel on the card) are held to the JAX package's on the demo's own
inputs, the port's draws from its seeds. The JAX demos printed, on the CPU, what each claim restates
(in dB): quickstart 13.83 -> 22.24; basics TV-PGD 18.00 and PnP-HQS 17.22
against the measurement's 14.81; heavy-ball 25.71 over PGD's 25.33 over
22.47.
"""

import ast
import importlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import test_torch_drunet  # noqa: F401  (each xdist worker takes its share of the cores)
from deepinv_tpu_torch.examples import GALLERY

ROOT = Path(__file__).parents[1]


def demo(name):
    return importlib.import_module(f"deepinv_tpu_torch.examples.demo_{name}")


def test_the_gallery_is_there_and_cites_its_jax_demos():
    """The 83 demos of the gallery's categories on the port (``CATEGORIES``:
    basics, physics, plug-and-play, optimization, unfolded, sampling,
    self-supervised, adversarial, blind, transforms, metrics, models, remote
    sensing, performance, distributed, datasets) exist, each beside the JAX
    demo it ports, which its docstring names; and they are every demo of
    ``examples/``, the port's counterpart of
    ``tests/test_examples.py::test_gallery_is_complete``."""
    for name in GALLERY:
        assert (ROOT / "examples" / f"demo_{name}.py").exists()
        assert f"examples/demo_{name}.py" in " ".join(demo(name).__doc__.split())
    jax_demos = {p.stem[len("demo_"):] for p in (ROOT / "examples").glob("demo_*.py")}
    assert len(GALLERY) == len(set(GALLERY)) == len(jax_demos) == 83
    assert set(GALLERY) == jax_demos


def test_the_gallery_imports_no_jax():
    """No file of ``deepinv_tpu_torch/examples`` imports jax or anything of
    the JAX package, at its top or inside a function."""
    bad = []
    files = sorted((ROOT / "deepinv_tpu_torch" / "examples").glob("*.py"))
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            bad += [f"{f.name}:{node.lineno} {m}" for m in mods
                    if m.split(".")[0] in ("jax", "jaxlib", "deepinv_tpu")]
    assert len(files) == len(GALLERY) + 2 and not bad, bad


@pytest.mark.parametrize("name", GALLERY)
def test_a_demo_without_a_device_raises_without_cuda(name, monkeypatch):
    """Without CUDA and without ``device="cpu"`` a demo raises, naming
    ``--device cpu``; it does not carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        demo(name).main()


def test_the_command_line_runs_a_demo(monkeypatch, capsys):
    """``python -m deepinv_tpu_torch.examples.demo_quickstart --device cpu
    --fast`` prints the returned numbers as the last line, JSON."""
    m = demo("quickstart")
    monkeypatch.setattr(sys, "argv", ["demo_quickstart", "--device", "cpu", "--fast"])
    out = m._util.cli(m.main, m.__doc__)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out


def test_quickstart():
    """PnP-PGD beats the measurement (the JAX demo asserts it)."""
    out = demo("quickstart").main(device="cpu", fast=True)
    assert out["psnr_xhat"] > out["psnr_y"] + 5


def test_basics():
    """TV-PGD and PnP-HQS beat the measurement; the inpainting
    pseudo-inverse is the zero-filled measurement, of the same PSNR."""
    out = demo("basics").main(device="cpu", fast=True)
    assert out["psnr_tv"] > out["psnr_y"] + 2 and out["psnr_pnp"] > out["psnr_y"] + 2
    assert out["psnr_dagger"] == pytest.approx(out["psnr_y"], abs=1e-3)
    assert 0 < out["ssim_y"] < 1


def test_custom_physics():
    """The adjoint that ``LinearPhysics`` derives from ``img_shape`` passes
    the dot-product test within 1e-4 (as the JAX demo asserts), and
    ``A A_dagger A = A`` within 1e-3."""
    out = demo("custom_physics").main(device="cpu", fast=True)
    assert out["adjointness_error"] < 1e-4 and out["dagger_residual"] < 1e-3


def test_custom_optim():
    """The custom heavy-ball iterator runs in the engine and beats PnP-PGD,
    which beats the measurement."""
    out = demo("custom_optim").main(device="cpu", fast=True)
    assert out["psnr_heavy_ball"] > out["psnr_pgd"] > out["psnr_y"] + 1


@pytest.mark.skipif(importlib.util.find_spec("h5py") is None, reason="needs h5py")
def test_custom_dataset():
    """32 and 8 pairs go through HDF5 and back, and the offline training
    loss falls over 2 epochs."""
    out = demo("custom_dataset").main(device="cpu", fast=True, epochs=2)
    assert (out["n_train"], out["n_test"]) == (32, 8)
    assert out["loss_history"][-1] < out["loss_history"][0]
    assert out["psnr_test"] > 15


def _rel(got, want):
    g, w = np.asarray(got.detach().cpu(), np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def test_basics_reconstructions_match_jax():
    """demo_basics's two TV reconstructions at its fast size (TV-PGD for 20
    iterations, PnP-HQS with ``TVDenoiser(50)`` for 10), each within 1e-5
    (relative L2) of the JAX package's, which takes the demo's own mask and
    measurement (the port's draws from the demo's seeds) and the calls of
    examples/demo_basics.py."""
    import jax
    import jax.numpy as jnp
    from deepinv_tpu.models import TVDenoiser as JTV
    from deepinv_tpu.optim import L2 as JL2
    from deepinv_tpu.optim import PnP as JPnP
    from deepinv_tpu.optim import TVPrior as JTVPrior
    from deepinv_tpu.optim import optim_builder as jbuild
    from deepinv_tpu.physics import Inpainting as JInpainting
    from deepinv_tpu_torch.datasets import shepp_logan
    from deepinv_tpu_torch.loss.metric import PSNR
    from deepinv_tpu_torch.physics import GaussianNoise, Inpainting

    m = demo("basics")
    out = m.main(device="cpu", fast=True)
    x = torch.from_numpy(shepp_logan(64))[None, None]
    tp = Inpainting((1, 64, 64), mask=0.5, generator=m._util.generator(0),
                    noise_model=GaussianNoise(0.05, device="cpu"), device="cpu")
    y = tp(x, generator=m._util.generator(1))
    assert float(PSNR()(y, x)[0]) == out["psnr_y"]
    jp = JInpainting(img_size=(1, 64, 64), mask=jnp.asarray(tp.mask.numpy()))
    yj = jnp.asarray(y.numpy())
    run = jax.jit(lambda model, yv, p: model(yv, p))
    tv = jbuild("PGD", data_fidelity=JL2(), prior=JTVPrior(),
                params_algo={"stepsize": 1.0, "lambda": 0.02}, max_iter=20)
    pnp = jbuild("HQS", data_fidelity=JL2(), prior=JPnP(JTV(50)),
                 params_algo={"stepsize": 1.0, "g_param": 0.03}, max_iter=10)
    assert _rel(out["x_hat"]["tv"], run(tv, yj, jp)) <= 1e-5
    assert _rel(out["x_hat"]["pnp"], run(pnp, yj, jp)) <= 1e-5
