"""The port's model wrappers against the JAX package's, on the CPU: the
gradient-step denoisers (GSPnP's training gradient against JAX's second
derivative), the equivariant wrappers (with the port's drawn rotations handed
to the JAX transform), the time and complex adapters, MMSE, the noise-level
estimators, the [-1, 1] and score-model wrappers, EPLL, the REST client's
payload, and ``Transform.iterate_params`` / ``symmetrize``.

Weights cross by ``load_jax_params``; f32 bounds are 1e-5 (max abs error over
the reference's max), 1e-4 through a second derivative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepinv_tpu.models as JM
import deepinv_tpu.physics as JP
import deepinv_tpu.transform as JT
import deepinv_tpu_torch.models as TM
import deepinv_tpu_torch.physics as TP
import deepinv_tpu_torch.transform as TT
from deepinv_tpu_torch.models.convert import drunet_names, upstream_state_dict
from test_torch_drunet import DEV, jax_params


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _dncnn(cin=1, cout=1, seed=0, depth=3, nf=8):
    ref = JM.DnCNN(cin, cout, depth=depth, nf=nf, key=jax.random.key(seed))
    rng = np.random.default_rng(seed)
    for conv in [ref.in_conv, *ref.conv_list, ref.out_conv]:
        conv.bias = jnp.asarray(rng.standard_normal(conv.bias.shape) * 0.05, jnp.float32)
    port = TM.load_jax_params(TM.DnCNN(cin, cout, depth=depth, nf=nf, device=DEV),
                              jax_params(ref))
    return ref, port


def _img(shape, seed=1):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def test_gsdrunet_matches_jax_and_loads_its_checkpoint(tmp_path):
    """``GSDRUNet`` (an ELU DRUNet, 2 blocks, nc 8) against JAX's, f32; its
    upstream checkpoint, prefixed ``student_grad.model.``, read by both."""
    kw = dict(in_channels=1, out_channels=1, nc=(8, 8, 8, 8))
    ref = JM.GSDRUNet(key=jax.random.key(1), **kw)
    port = TM.GSDRUNet(device=DEV, **kw)
    TM.load_jax_params(port, jax_params(ref))
    x = _img((1, 1, 32, 32))
    got = port(torch.from_numpy(x), 0.1).detach().numpy()
    assert _rel(got, ref(jnp.asarray(x), 0.1)) <= 1e-5
    sd = {f"student_grad.model.{k}": v
          for k, v in upstream_state_dict(port.student, drunet_names(port.student)).items()}
    path = str(tmp_path / "gs.pth")
    torch.save(sd, path)
    p2 = TM.GSDRUNet(pretrained=path, device=DEV, **kw)
    j2 = JM.GSDRUNet(pretrained=path, key=jax.random.key(2), **kw)
    for k, v in jax_params(ref).items():
        assert np.array_equal(p2.state_dict()[k].numpy(), v)
        assert np.array_equal(np.asarray(jax_params(j2)[k]), v)


def test_gspnp_training_gradient_matches_jax_second_derivative():
    """A loss through ``GSPnP(DnCNN)``'s output differentiated in the DnCNN's
    weights: a second derivative, against ``jax.grad`` of JAX's ``GSPnP``."""
    jden, tden = _dncnn(seed=3)
    jgs, tgs = JM.GSPnP(jden, alpha=0.7), TM.GSPnP(tden, alpha=0.7)
    x, xt = _img((2, 1, 10, 10), 4), _img((2, 1, 10, 10), 5)

    def jloss(gs):
        return jnp.mean((gs(jnp.asarray(x), 0.1) - jnp.asarray(xt)) ** 2)

    jl, jg = jax.value_and_grad(jloss)(jgs)
    tl = ((tgs(torch.from_numpy(x), 0.1) - torch.from_numpy(xt)) ** 2).mean()
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5 * float(jl)
    want = jax_params(jg)
    for n, p in tgs.named_parameters():
        assert _rel(p.grad.numpy(), want[n]) <= 1e-4, n


def _fixed_params(jtransform, params):
    """The JAX transform made to draw ``params`` (the port's draws)."""
    jtransform.get_params = lambda x, key=None: {k: jnp.asarray(v.numpy())
                                                 for k, v in params.items()}
    return jtransform


def test_equivariant_denoiser_matches_jax():
    """``EquivariantDenoiser`` over a DnCNN with 3 random rotations: the port's
    draws (seed 0) handed to the JAX rotation, f32."""
    jden, tden = _dncnn(seed=6)
    x = _img((2, 1, 8, 8), 7)
    params = TT.Rotate(multiples=90, n_trans=3).get_params(
        torch.from_numpy(x), torch.Generator().manual_seed(0))
    assert len(set(params["theta"].tolist())) > 1
    jrot = _fixed_params(JT.Rotate(multiples=90, n_trans=3), params)
    port = TM.EquivariantDenoiser(tden, TT.Rotate(multiples=90, n_trans=3))
    with torch.no_grad():
        got = port(torch.from_numpy(x), 0.1).numpy()
    assert _rel(got, JM.EquivariantDenoiser(jden, jrot)(jnp.asarray(x), 0.1)) <= 1e-5


def test_equivariant_reconstructor_matches_jax():
    """``EquivariantReconstructor`` of ``D(A^T y)`` on inpainting with 2
    rotations: the composed physics ``A T_g`` and its adjoint, f32."""
    jden, tden = _dncnn(seed=8)
    mask = (_img((1, 8, 8), 9) < 0.6).astype(np.float32)
    jp = JP.Inpainting(img_size=(1, 8, 8), mask=jnp.asarray(mask))
    tp = TP.Inpainting((1, 8, 8), mask=torch.from_numpy(mask), device=DEV)
    x = _img((2, 1, 8, 8), 10)
    y = x * mask
    params = TT.Rotate(multiples=90, n_trans=2).get_params(
        torch.from_numpy(x), torch.Generator().manual_seed(0))
    jrot = _fixed_params(JT.Rotate(multiples=90, n_trans=2), params)
    jrec = JM.EquivariantReconstructor(lambda v, phys: jden(phys.A_adjoint(v), 0.1), jrot)
    port = TM.EquivariantReconstructor(lambda v, phys: tden(phys.A_adjoint(v), 0.1),
                                       TT.Rotate(multiples=90, n_trans=2))
    with torch.no_grad():
        got = port(torch.from_numpy(y), tp).numpy()
    assert _rel(got, jrec(jnp.asarray(y), jp)) <= 1e-5


class _Masked:
    def __init__(self, mask):
        self.mask = mask


def test_time_and_complex_adapters_match_jax():
    """``TimeAgnosticNet`` frame by frame, ``TimeAveragingNet`` over the
    acquired frames of a (B, C, T, H, W) mask, ``ComplexDenoiser`` stacked and
    separate (and ``to_complex_denoiser``), f32."""
    jd1, td1 = _dncnn(seed=11)
    jd2, td2 = _dncnn(2, 2, seed=12)
    y = _img((2, 1, 3, 8, 8), 13)
    mask = (_img((2, 1, 3, 8, 8), 14) < 0.5).astype(np.float32)
    with torch.no_grad():
        got = TM.TimeAgnosticNet(td1)(torch.from_numpy(y)).numpy()
        assert _rel(got, JM.TimeAgnosticNet(jd1)(jnp.asarray(y))) <= 1e-5
        got = TM.TimeAveragingNet(lambda v, p: td1(v))(torch.from_numpy(y * mask),
                                                       _Masked(torch.from_numpy(mask)))
        want = JM.TimeAveragingNet(lambda v, p: jd1(v))(jnp.asarray(y * mask),
                                                        _Masked(jnp.asarray(mask)))
        assert _rel(got, want) <= 1e-5
        z = _img((2, 1, 8, 8), 15) + 1j * _img((2, 1, 8, 8), 16)
        for jc, tc in ((JM.ComplexDenoiser(jd2), TM.to_complex_denoiser(td2)),
                       (JM.ComplexDenoiser(jd1, separate=True),
                        TM.ComplexDenoiserWrapper(td1, separate=True))):
            got = tc(torch.from_numpy(z.astype(np.complex64)), 0.1).numpy()
            want = np.asarray(jc(jnp.asarray(z.astype(np.complex64)), 0.1))
            assert got.dtype == np.complex64
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_mmse_and_noise_estimators_match_jax():
    """``MMSE`` over 6 signals under Gaussian denoising; the wavelet (db4
    MAD) and patch-covariance noise estimates on noisy images, f32."""
    xs = _img((6, 1, 8, 8), 17)
    y = xs[:2] + 0.1 * np.random.default_rng(18).standard_normal((2, 1, 8, 8)).astype(np.float32)
    got = TM.MMSE(xs, sigma=0.1, device=DEV)(torch.from_numpy(y), TP.Denoising()).numpy()
    assert _rel(got, JM.MMSE(xs, sigma=0.1)(jnp.asarray(y), JP.Denoising())) <= 1e-5
    img = _img((2, 1, 32, 32), 19) * 0.2 + 0.1 * np.random.default_rng(20).standard_normal(
        (2, 1, 32, 32)).astype(np.float32)
    for tm, jm in ((TM.WaveletNoiseEstimator(), JM.WaveletNoiseEstimator()),
                   (TM.PatchCovarianceNoiseEstimator(), JM.PatchCovarianceNoiseEstimator())):
        got = tm(torch.from_numpy(img)).numpy()
        assert got.shape == (2,) and _rel(got, jm(jnp.asarray(img))) <= 1e-4


def _score_net(x, t):
    """A small score network of both frameworks: tanh(x) scaled by time."""
    t = t.reshape((-1,) + (1,) * (x.ndim - 1))
    if isinstance(x, torch.Tensor):
        return torch.tanh(x) * (1 + t.to(x.dtype))
    return jnp.tanh(x) * (1 + t.astype(x.dtype))


@pytest.mark.parametrize("case", ["vp_table_epsilon", "ve_callable_sample",
                                  "vp_scale_v", "integer_time", "tweedie"])
def test_score_model_wrapper_matches_jax(case):
    """``ScoreModelWrapper`` over a small score function: tabulated and
    callable schedules, the derived ones, each prediction type, integer time
    and the bare Tweedie form; its denoiser call and ``score``, f32."""
    sig = np.linspace(0.01, 2.0, 50).astype(np.float32)
    kws = {
        "vp_table_epsilon": lambda be: dict(sigma_t=be.asarray(sig), variance_preserving=True,
                                            n_timesteps=50),
        "ve_callable_sample": lambda be: dict(sigma_t=lambda t: 0.02 + 3.0 * t,
                                              variance_exploding=True,
                                              prediction_type="sample"),
        "vp_scale_v": lambda be: dict(scale_t=be.asarray(np.linspace(1.0, 0.3, 50)
                                                         .astype(np.float32)),
                                      variance_preserving=True, n_timesteps=50,
                                      prediction_type="v_prediction"),
        "integer_time": lambda be: dict(sigma_t=be.asarray(sig), variance_preserving=True,
                                        n_timesteps=50, takes_integer_time=True,
                                        clip_output=False),
        "tweedie": lambda be: dict(),
    }[case]
    tw = TM.ScoreModelWrapper(_score_net, **kws(torch))
    jw = JM.ScoreModelWrapper(_score_net, **kws(jnp))
    x = _img((2, 1, 6, 6), 21)
    sigma = 0.3 if case == "tweedie" else np.array([0.2, 0.5], np.float32)
    got = tw(torch.from_numpy(x), torch.as_tensor(sigma)).numpy()
    assert _rel(got, jw(jnp.asarray(x), jnp.asarray(sigma))) <= 1e-5
    if case != "tweedie":
        t = np.array([0.3, 0.7], np.float32)
        got = tw.score(torch.from_numpy(x), torch.from_numpy(t)).numpy()
        assert _rel(got, jw.score(jnp.asarray(x), jnp.asarray(t))) <= 1e-5


def test_small_wrappers_client_and_transform_helpers():
    """``MinusOneOneDenoiserWrapper``, ``EPLLDenoiser`` with JAX's mixture,
    ``DiffusersDenoiserWrapper`` raising as JAX's does, the client's payload
    round trip (no socket), and ``iterate_params`` / ``symmetrize``."""
    jd, td = _dncnn(seed=22)
    x = _img((1, 1, 12, 12), 23)
    with torch.no_grad():
        got = TM.MinusOneOneDenoiserWrapper(td)(torch.from_numpy(x), 0.1).numpy()
        assert _rel(got, JM.MinusOneOneDenoiserWrapper(jd)(jnp.asarray(x), 0.1)) <= 1e-5
        je = JM.EPLLDenoiser(patch_size=4, channels=1, key=jax.random.key(3))
        te = TM.load_jax_params(TM.EPLLDenoiser(patch_size=4, channels=1, device=DEV),
                                jax_params(je))
        got = te(torch.from_numpy(x), 0.1).numpy()
        assert _rel(got, je(jnp.asarray(x), 0.1)) <= 1e-4
    for wrapper in (TM.DiffusersDenoiserWrapper, JM.DiffusersDenoiserWrapper):
        with pytest.raises(ImportError):
            wrapper()
    client = TM.Client("http://localhost:1", api_key="k")
    y = torch.from_numpy(x)
    body = client.payload(y, TP.Denoising(), sigma=0.1, tag="a", skip=[1])
    assert body["physics"] == "Denoising" and body["kwargs"] == {"sigma": 0.1, "tag": "a"}
    assert np.array_equal(client.deserialize(body["y"]), x)
    assert body == {**JM.Client("http://localhost:1").payload(jnp.asarray(x), JP.Denoising(),
                                                               sigma=0.1, tag="a", skip=[1])}
    rot = TT.Rotate(multiples=90, n_trans=2)
    its = rot.iterate_params({"theta": torch.tensor([0.0, 90.0, 180.0])})
    jits = JT.Rotate(multiples=90).iterate_params({"theta": jnp.asarray([0.0, 90.0, 180.0])})
    assert [float(d["theta"]) for d in its] == [float(d["theta"][0]) for d in jits]
    f = rot.symmetrize(lambda v: td(v, 0.1))
    with torch.no_grad():
        out = f(y, generator=torch.Generator().manual_seed(0))
        params = rot.get_params(y, torch.Generator().manual_seed(0))
        want = rot.inverse(td(rot.transform(y, **params), 0.1), **params).mean(0, keepdim=True)
        stacked = rot.symmetrize(lambda v: td(v, 0.1), average=False)(y)
    assert torch.allclose(out, want, atol=1e-6) and stacked.shape == (2, 1, 12, 12)
