"""The port's metrics (``loss/metric.py``, ``loss/perceptual.py``) and VGG16
(``models/vgg.py``) against the JAX package's, on the CPU, in f32, at
2x3x32² unless a metric needs more (MS-SSIM 176²; NIQE 64² with 8-pixel
patches, so that each image gives more patches than NIQE's 36 features).

Bound: 1e-5 relative (max abs error over the reference's max abs) for every
metric, with two exceptions, each with its reason. HaarPSI (the logit of a
pooled similarity near 1) and the sharpness index (the log erfc of a large
argument) are ill-conditioned: their f32 rounding is amplified, and the
JAX f32 values lie several times further from a float64 evaluation of the
same formula than the port's. So those are held within 1e-4 of JAX's and
within 1e-5 of the port's own float64 value. NIQE's score ends in a float64 pseudo-inverse of a covariance
whose condition number is about 3e8, so its scores are held within 1e-4,
its fitted pristine parameters within 1e-5. LPIPS from the
same VGG16 weights, crossed by ``load_jax_params`` or read by both packages
from a torchvision-named file the test writes, within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepinv_tpu.loss as JL
import deepinv_tpu.models as JM
import deepinv_tpu_torch.loss as TL
import deepinv_tpu_torch.models as TM
from deepinv_tpu.core.tensorlist import TensorList as JaxTensorList
from deepinv_tpu_torch.core import TensorList
from deepinv_tpu_torch.models.convert import upstream_state_dict, vgg16_names
from test_torch_adversarial import numpy_he_init  # noqa: F401 (an autouse fixture)
from test_torch_drunet import DEV, jax_params

BOUND = 1e-5


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def pair(shape=(2, 3, 32, 32), seed=0, noise=0.05):
    """A ground truth in [0, 1] and a noisy estimate clipped to [0, 1]."""
    rng = np.random.default_rng(seed)
    x = rng.random(shape).astype(np.float32)
    x_net = np.clip(x + noise * rng.standard_normal(shape), 0, 1).astype(np.float32)
    return x_net, x


def both(name, *args, x_net=None, x=None, **kwargs):
    """The JAX and the port's metric ``name`` on the same pair."""
    if x_net is None:
        x_net, x = pair()
    metric = getattr(JL, name)(*args, **kwargs)
    ref = jax.jit(lambda a, b: metric(a, b))(jnp.asarray(x_net), jnp.asarray(x))
    got = getattr(TL, name)(*args, **kwargs)(torch.from_numpy(x_net), torch.from_numpy(x))
    return np.asarray(got), np.asarray(ref)


# the ill-conditioned metrics: within ILL_BOUND of JAX's and BOUND of the
# port's own float64 value
ILL = ("HaarPSI", "SharpnessIndex")
ILL_BOUND = 1e-4

CASES = {
    "NMSE": ("NMSE", (), {}),
    "MAE": ("MAE", (), {}),
    "SNR": ("SNR", (), {}),
    "SSIM": ("SSIM", (), {}),
    "SSIM_range_per_image": ("SSIM", (), {"max_pixel": None, "min_pixel": None}),
    "SSIM_crop_mean": ("SSIM", (), {"center_crop": 24, "reduction": "mean"}),
    "LpNorm": ("LpNorm", (), {"p": 1.5}),
    "LpNorm_onesided": ("LpNorm", (), {"onesided": True}),
    "L1L2": ("L1L2", (), {"alpha": 0.3}),
    "SpectralAngleMapper": ("SpectralAngleMapper", (), {}),
    "ERGAS": ("ERGAS", (4,), {}),
    "GMSD": ("GMSD", (), {}),
    "HaarPSI": ("HaarPSI", (), {}),
    "HaarPSI_gray_no_subsampling": ("HaarPSI", (), {"preprocess_with_subsampling": False}),
    "CosineSimilarity": ("CosineSimilarity", (), {}),
    "BlurStrength": ("BlurStrength", (), {}),
    "SharpnessIndex": ("SharpnessIndex", (), {}),
    "SharpnessIndex_no_periodic": ("SharpnessIndex", (), {"periodic_component": False}),
    "MSE_norm_min_max": ("MSE", (), {"norm_inputs": "min_max", "reduction": "mean"}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_metric_matches_jax(case):
    name, args, kwargs = CASES[case]
    x_net, x = pair()
    if case.startswith("HaarPSI_gray"):
        x_net, x = x_net[:, :1], x[:, :1]
    got, ref = both(name, *args, x_net=x_net, x=x, **kwargs)
    assert got.shape == ref.shape
    if name not in ILL:
        assert rel(got, ref) <= BOUND, (case, got, ref)
        return
    assert rel(got, ref) <= ILL_BOUND, (case, got, ref)
    f64 = getattr(TL, name)(*args, **kwargs)(torch.from_numpy(x_net).double(),
                                             torch.from_numpy(x).double())
    assert rel(got, f64) <= BOUND, (case, got, f64)


def test_multiscale_ssim_matches_jax():
    """MS-SSIM's five scales need a 176² image."""
    x_net, x = pair((1, 1, 176, 176), seed=1)
    got, ref = both("SSIM", multiscale=True, x_net=x_net, x=x)
    assert rel(got, ref) <= BOUND


def test_functions_recovery_coefficient_and_sum_match_jax():
    """``cal_mse``, ``cal_mae``, ``signal_noise_ratio``, the recovery
    coefficient in a mask, and a sum of two metrics."""
    x_net, x = pair(seed=2)
    for fn in ("cal_mse", "cal_mae", "signal_noise_ratio"):
        assert rel(getattr(TL, fn)(torch.from_numpy(x_net), torch.from_numpy(x)),
                   getattr(JL, fn)(jnp.asarray(x_net), jnp.asarray(x))) <= BOUND, fn
    mask = (np.random.default_rng(3).random(x.shape) > 0.5).astype(np.float32)
    got = TL.RecoveryCoefficient()(torch.from_numpy(x_net), torch.from_numpy(x),
                                   mask=torch.from_numpy(mask))
    ref = JL.RecoveryCoefficient()(jnp.asarray(x_net), jnp.asarray(x), mask=jnp.asarray(mask))
    assert rel(got, ref) <= BOUND
    got = (TL.MAE() + TL.SSIM())(torch.from_numpy(x_net), torch.from_numpy(x))
    ref = (JL.MAE() + JL.SSIM())(jnp.asarray(x_net), jnp.asarray(x))
    assert rel(got, ref) <= BOUND
    # a higher-better metric as a loss: its own inversion (1 - m for these)
    a, b = torch.from_numpy(x_net), torch.from_numpy(x)
    for name in ("SSIM", "CosineSimilarity", "PSNR", "RecoveryCoefficient"):
        kw = {"mask": torch.from_numpy(mask)} if name == "RecoveryCoefficient" else {}
        m = getattr(TL, name)()(a, b, **kw)
        assert torch.equal(getattr(TL, name)(train_loss=True)(a, b, **kw),
                           getattr(TL, name)().invert_metric(m)), name


def test_qnr_matches_jax():
    """QNR of a 4-band fused image against its 4x smaller multispectral and
    its panchromatic image (the pan resized as ``jax.image.resize``)."""
    rng = np.random.default_rng(4)
    fused = rng.random((2, 4, 32, 32)).astype(np.float32)
    ms = rng.random((2, 4, 8, 8)).astype(np.float32)
    pan = rng.random((2, 1, 32, 32)).astype(np.float32)
    ref = jax.jit(lambda f, m, p: JL.QNR(alpha=1.0, beta=0.5)(x_net=f, y=JaxTensorList([m, p])))(
        jnp.asarray(fused), jnp.asarray(ms), jnp.asarray(pan))
    got = TL.QNR(alpha=1.0, beta=0.5)(x_net=torch.from_numpy(fused),
                                      y=TensorList([torch.from_numpy(ms), torch.from_numpy(pan)]))
    assert rel(got, ref) <= BOUND


def _vgg_pair(seed=5):
    ref = JM.VGG16Features(key=jax.random.key(seed))
    port = TM.load_jax_params(TM.VGG16Features(device=DEV), jax_params(ref))
    return ref, port


def test_vgg16_features_match_jax():
    """The five stages of a gray input (repeated to RGB) and the state dict's
    torchvision names."""
    ref, port = _vgg_pair()
    x = np.random.default_rng(6).random((2, 1, 32, 32)).astype(np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    want = ref(jnp.asarray(x))
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    for g, w in zip(got, want):
        assert rel(g, w) <= BOUND
    names = vgg16_names(port)
    assert names["convs.0.weight"] == "features.0.weight"
    assert names["convs.12.bias"] == "features.28.bias" and len(names) == 26


def test_lpips_matches_jax(tmp_path):
    """LPIPS on VGG16 weights crossed from JAX (channel mean), and with both
    packages reading a torchvision-named ``vgg16`` file and an ``lpips``
    ``vgg.pth`` of linear weights that the test writes."""
    ref_vgg, port_vgg = _vgg_pair(seed=7)
    x_net, x = pair(seed=8)
    jl = JL.LPIPS(allow_random_weights=True)
    jl.backbone = ref_vgg
    tl = TL.LPIPS(allow_random_weights=True, device=DEV)
    tl.backbone = port_vgg
    args = (torch.from_numpy(x_net), torch.from_numpy(x))
    lpips = lambda m, a, b: m(a, b)
    with torch.no_grad():
        assert rel(tl(*args), lpips(jl, jnp.asarray(x_net), jnp.asarray(x))) <= BOUND
    vgg_path = tmp_path / "vgg16.pth"
    torch.save(upstream_state_dict(port_vgg, vgg16_names(port_vgg)), vgg_path)
    widths = (64, 128, 256, 512, 512)
    rng = np.random.default_rng(9)
    lin_path = tmp_path / "lpips_vgg.pth"
    torch.save({f"lin{k}.model.1.weight": torch.from_numpy(
        rng.random((1, c, 1, 1)).astype(np.float32)) for k, c in enumerate(widths)}, lin_path)
    jl = JL.LPIPS(vgg_pretrained=str(vgg_path), lin_pretrained=str(lin_path))
    tl = TL.LPIPS(vgg_pretrained=str(vgg_path), lin_pretrained=str(lin_path), device=DEV)
    with torch.no_grad():
        assert rel(tl(*args), lpips(jl, jnp.asarray(x_net), jnp.asarray(x))) <= BOUND
    with pytest.raises(ValueError, match="pretrained VGG weights"):
        TL.LPIPS(device=DEV)


def _phantoms(n=3, size=64, seed=10):
    """Seeded piecewise-smooth images in [0, 1]: discs over a gradient."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    out = []
    for _ in range(n):
        img = 0.3 * xx + 0.2 * yy
        for _ in range(6):
            cy, cx, r = rng.random(3) * [1, 1, 0.3]
            img = img + 0.4 * rng.random() * (((yy - cy) ** 2 + (xx - cx) ** 2) < r ** 2)
        out.append(np.clip(img + 0.01 * rng.standard_normal(img.shape), 0, 1)[None])
    return [o.astype(np.float32) for o in out]


def test_niqe_matches_jax(tmp_path):
    """NIQE's pristine parameters fitted by ``create_weights`` on seeded
    phantoms in both packages, then the scores of a 2x3x64² batch; the port
    also reloads what it saved."""
    data = _phantoms()
    jn = JL.NIQE(patch_size=8)
    # the JAX features jitted (the pipeline op by op compiles each primitive)
    jn._multiscale_features = jax.jit(jn._multiscale_features, static_argnums=1)
    tn = TL.NIQE(patch_size=8)
    want = jn.create_weights(data, sharpness_threshold=0.2)
    got = tn.create_weights(data, sharpness_threshold=0.2, save_path=str(tmp_path / "niqe.npz"))
    assert rel(got["mu"], want["mu"]) <= BOUND
    assert rel(got["cov"], want["cov"]) <= BOUND
    x_net, _ = pair((2, 3, 64, 64), seed=11)
    ref = jn(jnp.asarray(x_net))
    assert rel(tn(torch.from_numpy(x_net)), ref) <= 1e-4
    reloaded = TL.NIQE(weights_path=str(tmp_path / "niqe.npz"), patch_size=8)
    assert rel(reloaded(torch.from_numpy(x_net)), ref) <= 1e-4
    with pytest.raises(RuntimeError, match="not loaded"):
        TL.NIQE(patch_size=8)(torch.from_numpy(x_net))
