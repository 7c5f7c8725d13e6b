"""The port's metrics, losses, meters, data, physics and transform against
the JAX package's, on the CPU in f32.

Random draws cannot agree across the two frameworks, so the stochastic
losses are fed the JAX package's own draws: ``Rotate``'s angles, the
measurement noise (through a noise model that adds a given realization) and
SURE's probe.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepinv_tpu.datasets import ArrayDataset as JaxArrayDataset
from deepinv_tpu.datasets import DataLoader as JaxDataLoader
from deepinv_tpu.loss import MSE as JaxMSE
from deepinv_tpu.loss import PSNR as JaxPSNR
from deepinv_tpu.loss import EILoss as JaxEILoss
from deepinv_tpu.loss import MCLoss as JaxMCLoss
from deepinv_tpu.loss import SupLoss as JaxSupLoss
from deepinv_tpu.loss import SureGaussianLoss as JaxSureGaussianLoss
from deepinv_tpu.loss.metric import cal_psnr as jax_cal_psnr
from deepinv_tpu.models import ArtifactRemoval as JaxArtifactRemoval
from deepinv_tpu.physics import Denoising as JaxDenoising
from deepinv_tpu.physics import GaussianNoise as JaxGaussianNoise
from deepinv_tpu.physics import Inpainting as JaxInpainting
from deepinv_tpu.transform import Rotate as JaxRotate
from deepinv_tpu.utils.logger import AverageMeter as JaxAverageMeter
from deepinv_tpu_torch.datasets import (ArrayDataset, DataLoader, ImageDataset, TensorDataset,
                                        check_dataset)
from deepinv_tpu_torch.loss import MSE, PSNR, EILoss, MCLoss, SupLoss, SureGaussianLoss, cal_psnr
from deepinv_tpu_torch.models import ArtifactRemoval
from deepinv_tpu_torch.physics import Denoising, GaussianNoise, Inpainting
from deepinv_tpu_torch.physics.noise import NoiseModel
from deepinv_tpu_torch.transform import Rotate
from deepinv_tpu_torch.utils import AverageMeter
from test_torch_dncnn import _pair
from test_torch_drunet import jax_params


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _pair_arrays(shape=(3, 2, 12, 10), seed=0):
    rng = np.random.default_rng(seed)
    return rng.random(shape).astype(np.float32), rng.random(shape).astype(np.float32)


METRICS = {
    "mse": (lambda M: M.MSE(), {}),
    "psnr": (lambda M: M.PSNR(), {}),
    "psnr_max_none": (lambda M: M.PSNR(max_pixel=None), {}),
    "complex_abs": (lambda M: M.MSE(complex_abs=True), {}),
    "l2": (lambda M: M.MSE(norm_inputs="l2"), {}),
    "min_max": (lambda M: M.PSNR(norm_inputs="min_max"), {}),
    "clip": (lambda M: M.MSE(norm_inputs="clip"), {"scale": 1.5}),
    "standardize": (lambda M: M.MSE(norm_inputs="standardize"), {}),
    "crop": (lambda M: M.MSE(center_crop=6), {}),
    "crop_border": (lambda M: M.PSNR(center_crop=-2), {}),
    "crop_tuple": (lambda M: M.MSE(center_crop=(4, 6)), {}),
    "mean": (lambda M: M.PSNR(reduction="mean"), {}),
    "sum": (lambda M: M.MSE(reduction="sum"), {}),
    "callable": (lambda M: M.MSE(reduction=lambda v: v[:2]), {}),
    "train_loss": (lambda M: M.PSNR(train_loss=True), {}),
}


class _JaxM:
    MSE, PSNR = JaxMSE, JaxPSNR


class _PortM:
    MSE, PSNR = MSE, PSNR


@pytest.mark.parametrize("case", sorted(METRICS))
def test_metric_options_match_jax(case):
    """``Metric.__call__``'s options (metric.py:146-176): complex magnitude,
    normalization, center crop, reduction and ``train_loss``, on MSE and
    PSNR: relative max error <= 1e-6."""
    make, kw = METRICS[case]
    a, b = _pair_arrays(seed=len(case))
    a = a * kw.get("scale", 1.0)
    want = np.asarray(make(_JaxM)(jnp.asarray(a), jnp.asarray(b)))
    got = make(_PortM)(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-6


def test_center_crop_and_cal_psnr():
    a, b = _pair_arrays(seed=1)
    assert abs(float(cal_psnr(torch.from_numpy(a), torch.from_numpy(b)))
               - float(jax_cal_psnr(jnp.asarray(a), jnp.asarray(b)))) <= 1e-5
    with pytest.raises(ValueError):
        MSE(center_crop=(4, -2))
    with pytest.raises(ValueError):
        MSE(center_crop=20)(torch.from_numpy(a), torch.from_numpy(b))


def _mask(shape=(1, 12, 10), seed=4):
    return (np.random.default_rng(seed).random(shape) < 0.6).astype(np.float32)


def test_supervised_and_measurement_consistency_losses():
    """``SupLoss`` and ``MCLoss`` through ``Inpainting`` with a given mask:
    relative max error <= 1e-6."""
    a, b = _pair_arrays((3, 1, 12, 10), seed=2)
    m = _mask()
    jp, pp = JaxInpainting((1, 12, 10), mask=jnp.asarray(m)), Inpainting((1, 12, 10), mask=m,
                                                                        device="cpu")
    assert _rel(SupLoss()(x_net=torch.from_numpy(a), x=torch.from_numpy(b)).numpy(),
                JaxSupLoss()(x_net=jnp.asarray(a), x=jnp.asarray(b))) <= 1e-6
    assert _rel(MCLoss()(x_net=torch.from_numpy(a), y=torch.from_numpy(b), physics=pp).numpy(),
                JaxMCLoss()(x_net=jnp.asarray(a), y=jnp.asarray(b), physics=jp)) <= 1e-6


def test_denoising_and_inpainting_match_jax():
    """``Denoising`` and ``Inpainting`` (given mask): A, A^T, the
    pseudo-inverse and the closed-form prox within 1e-6; the noise leaves the
    masked pixels at exactly zero (inpainting.py:51)."""
    x, z = _pair_arrays((2, 1, 12, 10), seed=3)
    m = _mask()
    pairs = [(JaxDenoising(), Denoising()),
             (JaxInpainting((1, 12, 10), mask=jnp.asarray(m)),
              Inpainting((1, 12, 10), mask=m, device="cpu"))]
    for jp, pp in pairs:
        xt, zt, xj, zj = torch.from_numpy(x), torch.from_numpy(z), jnp.asarray(x), jnp.asarray(z)
        for got, want in [(pp.A(xt), jp.A(xj)), (pp.A_adjoint(xt), jp.A_adjoint(xj)),
                          (pp.A_dagger(xt), jp.A_dagger(xj)),
                          (pp.prox_l2(zt, xt, 0.7), jp.prox_l2(zj, xj, 0.7))]:
            assert _rel(got.numpy(), want) <= 1e-6
    noisy = Inpainting((1, 12, 10), mask=m, noise_model=GaussianNoise(0.1, device="cpu"),
                       device="cpu")(torch.from_numpy(x), generator=torch.Generator().manual_seed(0))
    assert bool((noisy[:, :, m[0] == 0] == 0).all()) and bool((noisy[:, :, m[0] == 1] != 0).all())
    drawn = Inpainting((1, 12, 10), mask=0.7, generator=torch.Generator().manual_seed(1),
                       device="cpu").mask
    assert drawn.shape == (1, 1, 12, 10) and 0.4 < float(drawn.mean()) < 0.95


@pytest.mark.parametrize("thetas", [(0.0, 90.0, 180.0, 270.0), (-90.0, 450.0, 90.0, 0.0)])
def test_rotate_matches_jax(thetas):
    """``Rotate``'s exact rot90 subgroup at given angles vs the JAX
    transform, and its inverse: exact. Other angles warp bilinearly
    (``Rotate(multiples=30)``), within 1e-5 of JAX's."""
    x = np.random.default_rng(5).random((4, 2, 8, 8)).astype(np.float32)
    theta = np.asarray(thetas, np.float32)
    want = np.asarray(JaxRotate().transform(jnp.asarray(x), theta=jnp.asarray(theta)))
    t = Rotate()
    got = t.transform(torch.from_numpy(x), theta=torch.from_numpy(theta))
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(t.inverse(got, theta=torch.from_numpy(theta)), torch.from_numpy(x))
    drawn = Rotate(n_trans=2).get_params(torch.from_numpy(x), torch.Generator().manual_seed(0))
    assert drawn["theta"].shape == (8,) and set(drawn["theta"].tolist()) <= {0, 90, 180, 270}
    any_angle = np.asarray([30.0, -60.0, 150.0, 330.0], np.float32)
    want = np.asarray(JaxRotate(multiples=30).transform(jnp.asarray(x),
                                                        theta=jnp.asarray(any_angle)))
    got = Rotate(multiples=30).transform(torch.from_numpy(x), theta=torch.from_numpy(any_angle))
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


class _GivenNoise(NoiseModel):
    """Adds ``sigma * eps`` for a given ``eps``: the JAX draw, fed in."""

    def __init__(self, sigma, eps):
        super().__init__()
        self.sigma, self.eps = sigma, torch.from_numpy(np.asarray(eps))

    def sample(self, y, generator):
        return y + self.sigma * self.eps


def _ssl_setup(seed=0, B=2, size=16):
    """A small f32 DnCNN reconstructor on inpainting in both packages, with
    the JAX draws of EI (angles, noise) and SURE (probe)."""
    ref, port = _pair(depth=4, nf=16, seed=seed)
    rng = np.random.default_rng(seed)
    m = _mask((1, size, size), seed=seed + 1)
    x = rng.random((B, 1, size, size)).astype(np.float32)
    y = (x * m + 0.1 * rng.standard_normal(x.shape) * m).astype(np.float32)
    jphys = JaxInpainting((1, size, size), mask=jnp.asarray(m), noise_model=JaxGaussianNoise(0.1))
    k_sure, k_ei = jax.random.key(11), jax.random.key(12)
    theta = np.asarray(JaxRotate().get_params(jnp.asarray(x), k_ei)["theta"])
    eps = np.asarray(jax.random.normal(jax.random.fold_in(k_ei, 1), x.shape, jnp.float32))
    probe = np.asarray(jax.random.normal(k_sure, y.shape, jnp.float32))
    pphys = Inpainting((1, size, size), mask=m, noise_model=_GivenNoise(0.1, eps), device="cpu")
    return ref, port, jphys, pphys, y, (k_sure, k_ei), (theta, probe)


def _jax_ssl(m, jphys, y, keys, parts=("sure", "ei")):
    model = lambda v, p: JaxArtifactRemoval(m)(v, p)
    yj = jnp.asarray(y)
    out = {"sure": jnp.mean(JaxSureGaussianLoss(0.1)(y=yj, physics=jphys, model=model,
                                                    key=keys[0]))}
    out["ei"] = jnp.mean(JaxEILoss(JaxRotate())(x_net=model(yj, jphys), physics=jphys,
                                               model=model, key=keys[1]))
    return sum(out[k] for k in parts), out


def _port_ssl(net, pphys, y, draws):
    model = ArtifactRemoval(net)
    yt = torch.from_numpy(y)
    sure = SureGaussianLoss(0.1)(y=yt, physics=pphys, model=model,
                                 probe=torch.from_numpy(draws[1])).mean()
    ei = EILoss(Rotate())(x_net=model(yt, pphys), physics=pphys, model=model,
                          params={"theta": torch.from_numpy(draws[0])}).mean()
    return sure + ei, {"sure": sure, "ei": ei}


def test_ei_and_sure_match_jax_with_the_jax_draws():
    """``EILoss(Rotate())`` and ``SureGaussianLoss(0.1)`` (its divergence a
    forward-mode JVP, as ``jax.jvp`` there) through ``ArtifactRemoval`` of a
    small f32 DnCNN on inpainting, fed the JAX draws: relative error <= 1e-5."""
    ref, port, jphys, pphys, y, keys, draws = _ssl_setup()
    _, want = _jax_ssl(ref, jphys, y, keys)
    with torch.no_grad():
        _, got = _port_ssl(port, pphys, y, draws)
    for k in ("sure", "ei"):
        assert abs(float(got[k]) - float(want[k])) <= 1e-5 * abs(float(want[k])), k


def test_sure_plus_ei_gradient_matches_jax_grad():
    """The gradient of SURE + EI with respect to the DnCNN's parameters (the
    SURE divergence differentiated again by backward) vs ``jax.grad``, f32,
    fed the JAX draws: relative max error <= 1e-4 per tensor."""
    ref, port, jphys, pphys, y, keys, draws = _ssl_setup(seed=3)
    want = jax_params(jax.grad(lambda m: _jax_ssl(m, jphys, y, keys)[0])(ref))
    _port_ssl(port, pphys, y, draws)[0].backward()
    for name, p in port.named_parameters():
        assert _rel(p.grad.numpy(), want[name]) <= 1e-4, name


def test_average_meter_matches_jax():
    ups = [(0.5, 1), (np.array([1.0, 2.0, 4.0]), 2), (3.0, 4), (np.float32(-1.0), 1)]
    a, b = AverageMeter("x"), JaxAverageMeter("x")
    for v, n in ups:
        a.update(v, n=n)
        b.update(v, n=n)
    assert (a.vals, a.count, a.val) == (b.vals, b.count, b.val)
    assert abs(a.avg - b.avg) <= 1e-12 and abs(a.std - b.std) <= 1e-12


@pytest.mark.parametrize("drop_last", [True, False])
def test_dataloader_order_matches_jax(drop_last):
    """``DataLoader`` batches with ``shuffle`` over three epochs, the JAX
    package's ``RandomState(seed + epoch)`` order: identical batches."""
    xs, ys = np.arange(10.0)[:, None], -np.arange(10.0)[:, None]
    port = DataLoader(ArrayDataset(xs, ys), batch_size=3, shuffle=True, seed=3,
                      drop_last=drop_last)
    ref = JaxDataLoader(JaxArrayDataset(xs, ys), batch_size=3, shuffle=True, seed=3,
                        drop_last=drop_last)
    assert len(port) == len(ref) == (3 if drop_last else 4)
    for _ in range(3):
        for (px, py), (rx, ry) in zip(port, ref, strict=True):
            assert np.array_equal(px, rx) and np.array_equal(py, ry)
    tensors = DataLoader(ArrayDataset(torch.arange(6.0)), batch_size=4, drop_last=False)
    assert [b.tolist() for b in tensors] == [[0.0, 1.0, 2.0, 3.0], [4.0, 5.0]]


class _Items(ImageDataset):
    def __init__(self, item):
        self.item = item

    def __len__(self):
        return 1

    def __getitem__(self, i):
        return self.item


@pytest.mark.parametrize("item", [(np.zeros(2),) * 4, "x", (np.zeros(2), "y"),
                                  (np.zeros(2), np.zeros(2), np.zeros(2))])
def test_check_dataset_refuses_bad_items(item):
    with pytest.raises(RuntimeError):
        check_dataset(_Items(item))


def test_check_dataset_and_tensor_dataset_accept_the_formats():
    x = np.zeros((3, 1, 4, 4), np.float32)
    for item in (x[0], (x[0], x[0]), (x[0], {"sigma": np.float32(0.1)}),
                 (x[0], x[0], {"sigma": np.float32(0.1)}), torch.zeros(2)):
        check_dataset(_Items(item))
    ds = TensorDataset(y=x, params={"sigma": np.arange(3.0)})
    xi, yi, pi = ds[1]
    assert np.isnan(xi) and yi.shape == (1, 4, 4) and pi == {"sigma": 1.0}
    with pytest.raises(ValueError):
        TensorDataset(x=x, y=x[:2])
