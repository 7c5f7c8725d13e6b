"""The port's TV prox op, ``TVPrior`` and ``TVDenoiser`` against the JAX
package on the CPU.

The CUDA kernel itself runs only on a GPU (chip_smoke.py compares it with its
plain version there). Here the op takes its plain PyTorch version, which is
held to the JAX XLA loop ``_xla_impl``, to the Pallas kernel ``_pallas_impl``
run in interpret mode (as tests/test_ops_battery.py:125-135 runs it) and, for
gradients, to ``jax.grad`` through the kernel's custom_vjp. Inputs come from
a numpy seed.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepinv_tpu.models import TVDenoiser as JaxTVDenoiser
from deepinv_tpu.ops.pallas import tv as jax_tv
from deepinv_tpu.optim import TVPrior as JaxTVPrior
from deepinv_tpu_torch.models import TVDenoiser
from deepinv_tpu_torch.ops.kernels import build
from deepinv_tpu_torch.ops.kernels.tv import (_SEG_THREADS, CLUSTER_SIZES, SMEM_MAX, TAU,
                                              _check_cuda, chambolle_prox, chambolle_prox_plain,
                                              div_op, grad_op, tv_plan)
from deepinv_tpu_torch.optim import TVPrior
from deepinv_tpu_torch.utils.profiling import counters

SHAPES = [(1, 2, 16, 24), (1, 1, 13, 17)]


def _x(shape, seed=0):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_prox_matches_xla_loop(shape):
    """Plain version vs ``_xla_impl`` (tv.py:88), 30 iterations: atol 1e-5
    (both f32, the same update; observed ~1e-7)."""
    x = _x(shape)
    want = np.asarray(jax_tv._xla_impl(jnp.asarray(x), 0.1, 30))
    got = chambolle_prox_plain(torch.from_numpy(x), 0.1, 30)
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_op_matches_pallas_interpret(shape):
    """The op on a CPU tensor vs the Pallas kernel in interpret mode
    (tv.py:70), 30 iterations: atol 1e-5."""
    x = _x(shape, seed=1)
    want = np.asarray(jax_tv._pallas_impl(jnp.asarray(x), jnp.asarray(0.2), 30))
    got = chambolle_prox(torch.from_numpy(x), 0.2, 30)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("gamma_shape", [(2, 1, 1, 1), (2, 3, 1, 1)])
def test_per_sample_and_per_plane_gamma_match_xla_loop(gamma_shape):
    """A per-sample (or per-plane) gamma vs ``_xla_impl`` with the same
    array, and each sample against its own scalar prox: atol 1e-5."""
    x = _x((2, 3, 16, 16), seed=2)
    g = np.random.default_rng(3).uniform(0.05, 0.3, gamma_shape).astype(np.float32)
    want = np.asarray(jax_tv._xla_impl(jnp.asarray(x), jnp.asarray(g), 30))
    got = chambolle_prox(torch.from_numpy(x), torch.from_numpy(g), 30)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    if gamma_shape[1] == 1:
        one = chambolle_prox(torch.from_numpy(x[1:]), float(g[1, 0, 0, 0]), 30)
        np.testing.assert_allclose(got[1:].numpy(), one.numpy(), atol=1e-6)


@pytest.mark.parametrize("gamma_shape", [(), (2, 1, 1, 1)])
def test_gradients_match_jax_custom_vjp(gamma_shape):
    """Gradients in x and gamma of ``sum(w * prox(x, gamma))`` against
    ``jax.grad`` through ``chambolle_prox``'s custom_vjp (whose backward is
    autodiff of ``_xla_impl``, as the port's is of the plain version):
    rtol 1e-4."""
    x = _x((2, 1, 12, 14), seed=4)
    w = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)
    g = np.full(gamma_shape, 0.15, np.float32) if gamma_shape else np.float32(0.15)
    if gamma_shape:
        g[1] = 0.25

    def loss(xx, gg):
        return jnp.sum(jnp.asarray(w) * jax_tv.chambolle_prox(xx, gg, 20))

    want_x, want_g = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    gt = torch.tensor(g).requires_grad_()
    (chambolle_prox(xt, gt, 20) * torch.from_numpy(w)).sum().backward()
    assert gt.grad.shape == gt.shape
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_x), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(gt.grad.numpy(), np.asarray(want_g), rtol=1e-4, atol=1e-6)


def test_grad_and_div_match_jax_and_are_adjoint():
    """``grad_op``/``div_op`` against the JAX package's ``_grad_op``/``_div_op``
    (prior.py:171-184), and ``<grad u, p> = -<u, div p>``; ``nabla`` and
    ``nabla_adjoint`` of ``TVPrior`` (4D and 5D) against the JAX ones, and
    adjoint to 1e-5 relative."""
    from deepinv_tpu.optim.prior import _div_op as jax_div, _grad_op as jax_grad

    rng = np.random.default_rng(6)
    u = rng.standard_normal((2, 3, 9, 11)).astype(np.float32)
    p = rng.standard_normal((2, 3, 9, 11, 2)).astype(np.float32)
    np.testing.assert_allclose(grad_op(torch.from_numpy(u)).numpy(),
                               np.asarray(jax_grad(jnp.asarray(u))), atol=1e-6)
    np.testing.assert_allclose(div_op(torch.from_numpy(p)).numpy(),
                               np.asarray(jax_div(jnp.asarray(p))), atol=1e-6)
    lhs = float((grad_op(torch.from_numpy(u)).double() * torch.from_numpy(p).double()).sum())
    rhs = -float((torch.from_numpy(u).double() * div_op(torch.from_numpy(p)).double()).sum())
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)
    for shape in [(2, 3, 9, 11), (1, 2, 5, 6, 7)]:
        v = rng.standard_normal(shape).astype(np.float32)
        q = rng.standard_normal(shape + (len(shape) - 2,)).astype(np.float32)
        Nv = TVPrior.nabla(torch.from_numpy(v))
        Nq = TVPrior.nabla_adjoint(torch.from_numpy(q))
        np.testing.assert_allclose(Nv.numpy(), np.asarray(JaxTVPrior.nabla(jnp.asarray(v))),
                                   atol=1e-6)
        np.testing.assert_allclose(Nq.numpy(),
                                   np.asarray(JaxTVPrior.nabla_adjoint(jnp.asarray(q))),
                                   atol=1e-5)
        lhs = float((Nv.double() * torch.from_numpy(q).double()).sum())
        rhs = float((torch.from_numpy(v).double() * Nq.double()).sum())
        assert abs(lhs - rhs) <= 1e-5 * abs(lhs)
    with pytest.raises(ValueError):
        TVPrior.nabla(torch.zeros(3, 4, 5))
    with pytest.raises(ValueError):
        TVPrior.nabla_adjoint(torch.zeros(3, 4, 5, 2))


def test_tv_prior_fn_grad_and_prox_match_jax():
    """``TVPrior.fn`` (rtol 1e-5), its autograd gradient against ``jax.grad``
    (rtol 1e-4), and its prox through the op and with ``use_pallas=False``
    against the JAX prox (atol 1e-5)."""
    x = _x((2, 1, 16, 20), seed=7)
    prior, ref = TVPrior(n_it_max=25), JaxTVPrior(n_it_max=25)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    np.testing.assert_allclose(prior.fn(xt).numpy(), np.asarray(ref.fn(xj)), rtol=1e-5)
    np.testing.assert_allclose(prior.grad(xt).numpy(), np.asarray(ref.grad(xj)), rtol=1e-4,
                               atol=1e-5)
    want = np.asarray(ref.prox(xj, gamma=0.1))
    np.testing.assert_allclose(prior.prox(xt, gamma=0.1).numpy(), want, atol=1e-5)
    plain = TVPrior(n_it_max=25, use_pallas=False)
    np.testing.assert_allclose(plain.prox(xt, gamma=0.1).numpy(), want, atol=1e-5)


def test_tv_denoiser_matches_jax():
    """``TVDenoiser(n_it_max)(x, ths)`` (classic.py:73) against the JAX
    denoiser, atol 1e-5; it denoises a piecewise-constant image as the JAX
    doctest does; ``prox_tau_fx`` and ``prox_sigma_g_conj`` match too."""
    rng = np.random.default_rng(8)
    clean = np.zeros((1, 1, 16, 16), np.float32)
    clean[..., 8:] = 1.0
    noisy = (clean + 0.1 * rng.standard_normal(clean.shape)).astype(np.float32)
    port, ref = TVDenoiser(n_it_max=50), JaxTVDenoiser(n_it_max=50)
    got = port(torch.from_numpy(noisy), 0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref(jnp.asarray(noisy), 0.1)), atol=1e-5)
    assert float(((got.numpy() - clean) ** 2).mean()) < float(((noisy - clean) ** 2).mean())
    u = rng.standard_normal((1, 1, 4, 5, 2)).astype(np.float32)
    np.testing.assert_allclose(port.prox_sigma_g_conj(torch.from_numpy(u), 0.5).numpy(),
                               np.asarray(ref.prox_sigma_g_conj(jnp.asarray(u), 0.5)), atol=1e-6)
    np.testing.assert_allclose(
        port.prox_tau_fx(torch.from_numpy(noisy), torch.from_numpy(clean)).numpy(),
        np.asarray(ref.prox_tau_fx(jnp.asarray(noisy), jnp.asarray(clean))), atol=1e-6)


def test_cpu_tensor_takes_the_plain_version():
    """On a CPU tensor the op runs the plain version (bit for bit), counts no
    launch and builds nothing."""
    x = torch.from_numpy(_x((1, 3, 10, 12), seed=9))
    before = counters["kernel.chambolle_prox.launches"]
    assert torch.equal(chambolle_prox(x, 0.3, 15), chambolle_prox_plain(x, 0.3, 15))
    assert counters["kernel.chambolle_prox.launches"] == before
    assert build.load_library.cache_info().currsize == 0


@pytest.mark.parametrize("case", ["f64", "one_dim", "empty", "n_iter", "spatial_gamma",
                                  "batch_vector_gamma", "mismatched_gamma", "cluster_too_small",
                                  "cluster_size", "resident_too_large", "global_with_cluster",
                                  "variant"])
def test_kernel_input_checks_raise(case):
    """What the CUDA kernel does not take raises before any launch: float64,
    fewer than two dims, an empty tensor, a negative n_iter, a gamma that
    varies inside a plane or does not broadcast to x; and a forced layout
    that cannot hold the plane (a cluster too small for a 256^2 plane, a
    cluster size not in CLUSTER_SIZES, the resident variant for a 1024^2
    plane, a cluster size for the global variant, an unknown variant). The
    accepted gammas map to one value per plane."""
    x = torch.zeros((2, 3, 8, 8))
    big = torch.zeros(1).expand(1, 1, 1024, 1024)
    mid = torch.zeros(1).expand(1, 1, 256, 256)
    bad = {
        "f64": (x.double(), torch.tensor(0.1), 5),
        "one_dim": (torch.zeros(8), torch.tensor(0.1), 5),
        "empty": (torch.zeros((0, 3, 8, 8)), torch.tensor(0.1), 5),
        "n_iter": (x, torch.tensor(0.1), -1),
        "spatial_gamma": (x, torch.full((2, 1, 8, 8), 0.1), 5),
        "batch_vector_gamma": (x, torch.tensor([0.1, 0.2]), 5),
        "mismatched_gamma": (x, torch.full((3, 1, 1, 1), 0.1), 5),
        "cluster_too_small": (mid, torch.tensor(0.1), 5, "resident", 1),
        "cluster_size": (mid, torch.tensor(0.1), 5, None, 3),
        "resident_too_large": (big, torch.tensor(0.1), 5, "resident"),
        "global_with_cluster": (mid, torch.tensor(0.1), 5, "global", 8),
        "variant": (mid, torch.tensor(0.1), 5, "shared"),
    }[case]
    with pytest.raises(TypeError if case == "f64" else ValueError):
        _check_cuda(*bad)
    assert torch.equal(_check_cuda(x, torch.tensor(0.5), 5), torch.full((6,), 0.5))
    assert _check_cuda(x, torch.tensor(0.5), 5).stride() == (0,)  # a view: no copy kernel
    g = torch.tensor([0.1, 0.2]).reshape(2, 1, 1, 1)
    assert torch.equal(_check_cuda(x, g, 5), g.reshape(2, 1).expand(2, 3).reshape(-1))
    g = torch.arange(6.0).reshape(2, 3, 1, 1)
    assert torch.equal(_check_cuda(x, g, 0), torch.arange(6.0))


def test_tv_modules_import_no_jax():
    """The port's TV modules stand alone: importing them loads no JAX module
    and nothing of the JAX package."""
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import deepinv_tpu_torch.ops.kernels.tv, deepinv_tpu_torch.optim.prior\n"
        "import deepinv_tpu_torch.models.classic, deepinv_tpu_torch.optim.iterators\n"
        "import deepinv_tpu_torch.ops.radon_slice, deepinv_tpu_torch.physics.tomography\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in ('jax', 'jaxlib', 'deepinv_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=str(Path(__file__).parents[1]))
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_without_device_need_cuda():
    """With no CUDA device, an entry point built without ``device`` raises
    and names ``device="cpu"``: there is no quiet fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the GPU")
    from deepinv_tpu_torch.models import DnCNN, DRUNet
    from deepinv_tpu_torch.ops import gaussian_blur
    from deepinv_tpu_torch.optim import optim_builder
    from deepinv_tpu_torch.physics import MRI, BlurFFT, GaussianNoise, Tomography

    makers = [
        lambda: BlurFFT((1, 8, 8), filter=gaussian_blur(1.0)),
        lambda: MRI(img_size=(8, 8)),
        lambda: Tomography(angles=4, img_width=8, method="slice"),
        lambda: GaussianNoise(0.1),
        lambda: DRUNet(nc=(8, 8, 8, 8), nb=1),
        lambda: DnCNN(1, 1, depth=3),
        lambda: optim_builder("PGD", prior=TVPrior(), max_iter=2),
    ]
    for make in makers:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            make()
    assert BlurFFT((1, 8, 8), filter=gaussian_blur(1.0), device="cpu").mask.device.type == "cpu"


# The plan (pure Python): the shapes chip_smoke.py's K7 checks and TV problems
# use, (H, W, planes) -> (variant, cluster size)
PLAN_SHAPES = {(37, 53, 1): ("resident", 8), (256, 256, 3): ("resident", 16),
               (256, 256, 2): ("resident", 16), (256, 256, 24): ("resident", 8),
               (512, 512, 1): ("resident", 16), (1024, 1024, 1): ("global", 0),
               (500, 300, 1): ("resident", 16), (250, 250, 1): ("resident", 16),
               (37, 53, 40): ("resident", 2)}


@pytest.mark.parametrize("hwn", sorted(PLAN_SHAPES))
def test_plan_picks_variant_and_cluster(hwn):
    """The plan's variant and cluster size for each plane shape and count the
    smoke holds to the plain version: 256^2 in a cluster of 8 (8192 pixels a
    CTA), doubled to 16 while the planes fit the 132 SMs (1x3x256^2, not
    8x3x256^2), a small plane likewise, 512^2 in 16, 1024^2 on the global
    variant; and the clusters of all the planes never exceed the SMs once
    doubled."""
    H, W, n = hwn
    plan = tv_plan(H, W, planes=n)
    assert (plan.variant, plan.cluster) == PLAN_SHAPES[hwn]
    base = tv_plan(H, W, planes=10 ** 6)
    assert plan.cluster == base.cluster or n * plan.cluster <= 132


def _bands(plan, H):
    """The rows ``[r0, r1)`` of each CTA of a resident cluster
    (``tv_resident`` in csrc/tv_prox.cu: CTA k owns ``[k band, (k+1) band)``)."""
    return [(k * plan.band, min(H, (k + 1) * plan.band)) for k in range(plan.cluster)]


def _all_resident_plans():
    for H, W in [(37, 53), (61, 17), (256, 256), (250, 250), (500, 300), (512, 512),
                 (1024, 256), (256, 1024), (3, 700), (700, 3)]:
        for cs in CLUSTER_SIZES:
            try:
                yield (H, W), tv_plan(H, W, "resident", cs)
            except ValueError:
                pass


def test_plan_bands_cover_rows_and_fit_shared_memory():
    """For every cluster size that holds a plane: the bands cover every row
    exactly once and none is empty, the warps cover every band row and
    column (31 columns x seg rows each, within the threads ``_SEG_THREADS``
    allows a CTA for that seg), and a CTA's shared memory (xg, ph, pw of its
    band and 7 halo rows) stays within the 227 KB a block may use."""
    seen = 0
    for (H, W), plan in _all_resident_plans():
        bands = _bands(plan, H)
        rows = [r for r0, r1 in bands for r in range(r0, r1)]
        assert rows == list(range(H)), (H, W, plan)
        assert all(r1 > r0 for r0, r1 in bands)
        chunks = -(-W // 31)
        assert plan.threads == chunks * -(-plan.band // plan.seg) * 32 <= _SEG_THREADS[plan.seg]
        assert chunks * 31 >= W
        assert plan.smem == 4 * (3 * plan.band + 7) * W <= SMEM_MAX == 227 * 1024
        seen += 1
    assert seen >= 20


@pytest.mark.parametrize("hw", [(1024, 1024), (3000, 128), (600, 600), (64, 1100)])
def test_plan_too_large_for_16_ctas_takes_global(hw):
    """A plane that no cluster of up to 16 CTAs holds takes the global
    variant by default, and forcing the resident variant raises."""
    assert tv_plan(*hw).variant == "global"
    with pytest.raises(ValueError):
        tv_plan(*hw, variant="resident")
    for cs in CLUSTER_SIZES:
        with pytest.raises(ValueError):
            tv_plan(*hw, cluster=cs)


def _resident_walk(x, gamma, n_iter, plan):
    """``tv_resident`` (csrc/tv_prox.cu) emulated in numpy float32, read for
    read: each CTA of the plan's cluster holds the kernel's flat shared memory
    (xg, ph and pw of its band with their halo rows, the top slots), each warp
    of 32 lanes (31 columns and the next) walks its ``seg`` rows as ``walk``
    does, without masks past its first row (column -1 is the previous row's
    last element; u one column right comes by a shuffle down), then the owner
    lanes write their rows and push the band's edge rows into the neighbours'
    slots of the next parity. Asserts after every step that ph of row H - 1
    and pw of column W - 1, halo rows included, are exactly 0: the unmasked
    reads rely on it. Returns out = x - gamma div p."""
    f32 = np.float32
    tau, tiny = f32(TAU), f32(1e-30)
    H, W = x.shape
    band, seg = plan.band, plan.seg
    oh = (band + 1) * W
    ow = oh + (band + 2) * W
    otop = ow + (band + 2) * W
    xf = x.reshape(-1)
    chunks = -(-W // 31)
    j = np.arange(chunks)[:, None] * 31 + np.arange(32)[None, :]   # (chunks, 32) lanes
    jj = np.minimum(j, W - 1)
    owner = (np.arange(32)[None, :] < 31) & (j < W)
    ctas = []
    for k in range(plan.cluster):
        r0, r1 = k * band, min(H, (k + 1) * band)
        sm = np.zeros(otop + 2 * W, f32)
        q = r0 * W + np.arange((r1 - r0 + 1) * W)
        sm[:q.size] = np.where(q < H * W, xf[np.minimum(q, H * W - 1)] / f32(gamma), f32(0))
        groups = [(s0, min(r1, s0 + seg)) for s0 in range(r0, r0 + band, seg) if s0 < r1]
        ctas.append((r0, r1, sm, groups))
    for t in range(n_iter):
        slot, nxt = t & 1, (t + 1) & 1
        new = []
        for r0, r1, sm, groups in ctas:
            for s0, s1 in groups:
                base = (s0 - r0) * W + jj
                ph_u = (f32(0) if s0 == 0 else
                        sm[oh + base - W] if s0 > r0 else sm[otop + slot * W + jj])
                dh = (sm[oh + base] if s0 < H - 1 else f32(0)) - (ph_u if s0 > 0 else f32(0))
                dw = (np.where(jj < W - 1, sm[ow + base], f32(0))
                      - np.where(jj > 0, sm[ow + base - 1], f32(0)))
                uc = (dh + dw) - sm[base]
                last_off = W + (slot * W if s1 == r1 else 0)
                at, rows = base, s1 - s0
                phc, pwc = sm[oh + at], sm[ow + at]
                nph, npw = [], []
                for s in range(rows):
                    last = s == rows - 1
                    off = last_off if last else W
                    phn, pwn = sm[oh + at + off], sm[ow + at + off]
                    pwl = sm[ow + at + off - 1]
                    ud = ((phn - phc) + (pwn - pwl)) - sm[at + W]
                    ur = np.concatenate([uc[:, 1:], uc[:, 31:]], 1)   # __shfl_down_sync
                    eh = ud - uc if (not last or s1 < H) else np.zeros_like(uc)
                    ew = ur - uc
                    denom = f32(1) + tau * np.sqrt(np.maximum(eh * eh + ew * ew, tiny))
                    nph.append((phc + tau * eh) / denom)
                    npw.append((pwc + tau * ew) / denom)
                    phc, pwc, uc, at = phn, pwn, ud, at + W
                new.append((nph, npw))
        it = iter(new)
        for k, (r0, r1, sm, groups) in enumerate(ctas):
            for s0, s1 in groups:
                nph, npw = next(it)
                for s, (h, w) in enumerate(zip(nph, npw)):
                    sm[oh + (s0 - r0 + s) * W + j[owner]] = h[owner]
                    sm[ow + (s0 - r0 + s) * W + j[owner]] = w[owner]
                    if s0 + s == r1 - 1 and r1 < H:   # the band's last row, down
                        ctas[k + 1][2][otop + nxt * W + j[owner]] = h[owner]
                if s0 == r0 and k > 0:   # the band's first row, up
                    ctas[k - 1][2][oh + (band + nxt) * W + j[owner]] = nph[0][owner]
                    ctas[k - 1][2][ow + (band + nxt) * W + j[owner]] = npw[0][owner]
        for r0, r1, sm, _ in ctas:
            assert not sm[ow:otop].reshape(band + 2, W)[:, W - 1].any(), t
            if r1 == H:
                assert not sm[oh + (H - 1 - r0) * W:oh + (H - r0) * W].any(), t
    out = []
    slot = n_iter & 1
    for r0, r1, sm, _ in ctas:
        ph = sm[oh:oh + (r1 - r0) * W].reshape(-1, W)
        pw = sm[ow:ow + (r1 - r0) * W].reshape(-1, W)
        i = np.arange(r0, r1)[:, None]
        ph_up = np.concatenate([sm[otop + slot * W:otop + (slot + 1) * W][None], ph[:-1]])
        dh = np.where(i < H - 1, ph, f32(0)) - np.where(i > 0, ph_up, f32(0))
        pw_l = np.concatenate([np.zeros((r1 - r0, 1), f32), pw[:, :-1]], 1)
        dw = (np.where(np.arange(W) < W - 1, pw, f32(0))
              - np.where(np.arange(W) > 0, pw_l, f32(0)))
        out.append(x[r0:r1] - f32(gamma) * (dh + dw))
    return np.concatenate(out)


@pytest.mark.parametrize("hw,cluster", [((61, 17), 1), ((61, 17), 2), ((61, 17), 4),
                                        ((61, 17), 8), ((61, 17), 16), ((31, 40), 16),
                                        ((10, 70), 4), ((20, 32), 4), ((9, 63), 2),
                                        ((300, 20), 1), ((256, 40), 1)])
def test_resident_schedule_matches_plain_prox(hw, cluster):
    """The resident kernel's reads, band and halo schedule, emulated on the
    plan's layout (ragged last bands, a one-row last band at 31 rows in 16
    CTAs, the last column on lane 31 at W = 32, walks of 2 to 32 rows),
    reproduce the JAX package's XLA loop ``_xla_impl`` and the plain prox:
    atol 1e-5 (float32 both; the emulation drops the masks the loop takes)."""
    x = _x(hw, seed=10)
    plan = tv_plan(*hw, cluster=cluster)
    got = _resident_walk(x, 0.07, 25, plan)
    want = np.asarray(jax_tv._xla_impl(jnp.asarray(x)[None, None], 0.07, 25))[0, 0]
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, chambolle_prox_plain(torch.from_numpy(x), 0.07, 25).numpy(),
                               atol=1e-5)
