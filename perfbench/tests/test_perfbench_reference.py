"""The plain reference against the port's plain path on the CPU, in
float32, at a tiny size: the same weights and inputs give the same answers.
(A test, not the harness: the harness never runs the two side by side.)"""

import json

import pytest
import torch

from perfbench import harness
from perfbench.reference import (images, net_dncnn, net_drunet, phys_blur_fft, phys_mri,
                                 solver_hqs, solver_pgd, weights)

DRUNET = json.loads((harness.HERE / "configs/drunet.json").read_text())
DNCNN = json.loads((harness.HERE / "configs/dncnn.json").read_text())
CPU = "cpu"


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


def rel(a, b):
    return float((a - b).norm() / b.norm())


def port_drunet(state, channels):
    from deepinv_tpu_torch.models import DRUNet

    net = DRUNet(channels, channels, nc=DRUNET["nc"], nb=DRUNET["nb"], device=CPU)
    net.load_state_dict(state)
    return net


def port_dncnn(state, channels, depth=20):
    from deepinv_tpu_torch.models import DnCNN

    net = DnCNN(channels, channels, depth=depth, nf=DNCNN["nf"], device=CPU)
    net.load_state_dict(state)
    return net


def test_smooth_fields_are_seeded_and_in_range():
    a = images.smooth_fields(2, 3, 32, 48, gen(1), CPU)
    assert a.shape == (2, 3, 32, 48) and float(a.min()) == 0.0 and float(a.max()) == 1.0
    assert torch.equal(a, images.smooth_fields(2, 3, 32, 48, gen(1), CPU))
    assert not torch.equal(a, images.smooth_fields(2, 3, 32, 48, gen(2), CPU))


def test_drunet_reference_is_the_port_drunet():
    w = weights.draw(net_drunet.param_specs(DRUNET, 3), gen(), CPU)
    x = images.smooth_fields(2, 3, 32, 32, gen(1), CPU)
    with torch.no_grad():
        want = port_drunet(w, 3)(x, 0.05)
        got = net_drunet.forward(w, x, 0.05, DRUNET)
    assert rel(got, want) < 1e-5


def test_dncnn_reference_is_the_port_dncnn():
    w = weights.draw(net_dncnn.param_specs(DNCNN, 2), gen(), CPU)
    x = images.smooth_fields(2, 2, 24, 40, gen(1), CPU)
    with torch.no_grad():
        want = port_dncnn(w, 2)(x)
        got = net_dncnn.forward(w, x, 0.05, DNCNN)
    assert rel(got - x, want - x) < 1e-5


def test_blur_reference_is_the_port_blurfft():
    from deepinv_tpu_torch.physics import BlurFFT

    t = phys_blur_fft.make({"psf_sigma": 1.5}, (3, 32, 40), None, CPU)
    op = phys_blur_fft.Op(t, (3, 32, 40))
    port = BlurFFT((3, 32, 40), filter=t["psf"], device=CPU)
    x, z = (images.smooth_fields(2, 3, 32, 40, gen(s), CPU) for s in (1, 2))
    y = op.A(x)
    assert rel(y, port.A(x)) < 1e-5
    assert rel(op.A_adjoint(y), port.A_adjoint(y)) < 1e-5
    assert rel(op.prox_l2(z, y, 2.0), port.prox_l2(z, y, 2.0)) < 1e-5
    assert float(t["psf"].sum()) == pytest.approx(1.0) and t["psf"].shape[-1] == 11


def test_mri_reference_is_the_port_mri():
    from deepinv_tpu_torch.physics import MRI

    spec = {"acceleration": 4, "center_fraction": 0.08}
    t = phys_mri.make(spec, (2, 32, 40), gen(3), CPU)
    cols = t["mask"][0, 0, 0]
    assert int(cols.sum()) == round(40 / 4) and bool(cols[19:22].all())
    op = phys_mri.Op(t, (2, 32, 40))
    port = MRI(mask=t["mask"][0, 0], img_size=(32, 40), device=CPU)
    x = images.smooth_fields(2, 2, 32, 40, gen(1), CPU)
    y = op.A(x)
    assert rel(y, port.A(x)) < 1e-5
    assert rel(op.A_adjoint(y), port.A_adjoint(y)) < 1e-5
    assert rel(op.prox_l2(x, y, 2.0), port.prox_l2(x, y, 2.0)) < 1e-5


@pytest.mark.parametrize("solver", ["HQS", "PGD"])
def test_solvers_are_the_port_solvers(solver):
    from deepinv_tpu_torch.optim import L2, PnP, optim_builder

    w = weights.draw(net_dncnn.param_specs({**DNCNN, "depth": 5}, 2), gen(), CPU)
    t = phys_mri.make({"acceleration": 4, "center_fraction": 0.08}, (2, 32, 32), gen(3), CPU)
    op = phys_mri.Op(t, (2, 32, 32))
    y = op.measure(images.smooth_fields(2, 2, 32, 32, gen(1), CPU), 0.0)
    from deepinv_tpu_torch.physics import MRI

    params = {"stepsize": 1.0, "g_param": 0.05}
    model = optim_builder(solver, L2(), PnP(port_dncnn(w, 2, depth=5)), params_algo=params,
                          max_iter=4, device=CPU)
    ref = {"HQS": solver_hqs, "PGD": solver_pgd}[solver]
    with torch.no_grad():
        want = model(y, MRI(mask=t["mask"][0, 0], img_size=(32, 32), device=CPU))
        got = ref.run(y, op, lambda v, s: net_dncnn.forward(w, v, s, {**DNCNN, "depth": 5}),
                      params, 4)
    assert rel(got, want) < 1e-5
