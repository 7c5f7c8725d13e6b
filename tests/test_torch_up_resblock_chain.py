"""The port's up-projection chain op (K2/K3) against the JAX package.

The CUDA kernel runs only on a GPU (chip_smoke.py compares it with its plain
version there). Here, on the CPU, the op takes its plain PyTorch version,
which is held to both TPU variants of ``fused_up_resblock_chain_folded`` run
in Pallas interpret mode (``DEEPINV_TPU_UP_KERNEL=1`` and ``=2``), to the JAX
f32 reference and to the JAX custom_vjp's gradients. The projection kernel's
packed layout and epilogue addressing (``csrc/proj2x2.cuh``) are replayed in
PyTorch. Inputs come from a numpy seed; NHWC <-> NCHW is a transpose, and the
JAX package's W-folded tensor is a reshape of NHWC.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deepinv_tpu.ops.pallas.resblock_chain import (_lax_up_resblocks_f32, _unfold,
                                                   fused_up_resblock_chain_folded)
from deepinv_tpu_torch.ops.kernels import build
from deepinv_tpu_torch.ops.kernels.up_resblock_chain import (_check_cuda, pack_up_weights,
                                                             up_plain, up_resblock_chain,
                                                             up_resblock_chain_plain,
                                                             up_resblocks_f32)
from deepinv_tpu_torch.utils.profiling import counters


def _inputs(R, seed=0, shape=(1, 8, 6, 32)):
    """v as NHWC ``shape``, the IOHW up weight and the chain weights."""
    rng = np.random.default_rng(seed)
    Ci = shape[-1]
    v = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((Ci, 64, 2, 2)) * (2 / (4 * Ci)) ** 0.5).astype(np.float32)
    w1 = (rng.standard_normal((R, 64, 64, 3, 3)) * 0.05).astype(np.float32)
    w2 = (rng.standard_normal((R, 64, 64, 3, 3)) * 0.05).astype(np.float32)
    return v, w, w1, w2


def _nchw(v_nhwc):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(v_nhwc, np.float32).transpose(0, 3, 1, 2)))


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


def test_up_resblocks_f32_matches_jax_reference():
    """f32 op reference vs ``_lax_up_resblocks_f32`` (resblock_chain.py:270):
    the same f32 arithmetic in another order, relative error <= 1e-4."""
    v, w, w1, w2 = _inputs(2)
    want = _unfold(_lax_up_resblocks_f32(jnp.asarray(v), jnp.asarray(w), jnp.asarray(w1),
                                         jnp.asarray(w2)))
    got = up_resblocks_f32(_nchw(v), *(torch.from_numpy(a) for a in (w, w1, w2)))
    assert got.shape == (1, 64, 16, 12)
    assert _rel(got.numpy(), want) <= 1e-4


@pytest.mark.parametrize("variant", ["1", "2"])
@pytest.mark.parametrize("R", [1, 2])
def test_plain_matches_pallas_interpret(variant, R, monkeypatch):
    """bf16 plain version vs the TPU kernel in interpret mode, K2
    (``DEEPINV_TPU_UP_KERNEL=1``, the projection in the kernel) and K3 (``=2``,
    the projection in XLA): bf16 rounding in two implementations, relative
    max error <= 2e-2 (the JAX test's bound, tests/test_models.py:691-723)."""
    monkeypatch.setenv("DEEPINV_TPU_UP_KERNEL", variant)
    v, w, w1, w2 = _inputs(R, seed=10 + R)
    vb = jnp.asarray(v, jnp.bfloat16)
    want = _unfold(fused_up_resblock_chain_folded(vb, jnp.asarray(w), jnp.asarray(w1),
                                                  jnp.asarray(w2), True)).astype(jnp.float32)
    got = up_resblock_chain(_nchw(vb.astype(jnp.float32)).to(torch.bfloat16),
                            *(torch.from_numpy(a) for a in (w, w1, w2)))
    assert got.dtype == torch.bfloat16 and got.shape == (1, 64, 16, 12)
    assert _rel(got.float().numpy(), want) <= 2e-2


def test_gradients_match_jax_custom_vjp():
    """Gradients of the autograd.Function vs ``jax.grad`` through the JAX
    custom_vjp: both are autodiff of the f32 reference, relative error
    <= 3e-2 (tests/test_models.py:712-721)."""
    v, w, w1, w2 = _inputs(2, seed=7)
    vb = jnp.asarray(v, jnp.bfloat16)

    def loss(*a):
        return jnp.sum(fused_up_resblock_chain_folded(*a, True).astype(jnp.float32))

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(vb, jnp.asarray(w), jnp.asarray(w1),
                                                jnp.asarray(w2))
    vt = _nchw(vb.astype(jnp.float32)).to(torch.bfloat16).requires_grad_()
    ws = [torch.from_numpy(a).requires_grad_() for a in (w, w1, w2)]
    up_resblock_chain(vt, *ws).float().sum().backward()
    assert vt.grad.dtype == torch.bfloat16 and ws[0].grad.dtype == torch.float32
    got_v = vt.grad.float().numpy().transpose(0, 2, 3, 1)
    assert _rel(got_v, np.asarray(want[0], np.float32)) <= 3e-2
    for t, g in zip(ws, want[1:]):
        assert _rel(t.grad.numpy(), g) <= 3e-2


def test_plain_rounds_once_per_projection_and_conv():
    """The plain version's rounding: the projection in f32 on bf16 values,
    rounded once; then one rounding after conv1's ReLU and one after conv2's
    residual add. Batch 2 and a ragged 5 x 3 input."""
    v, w, w1, w2 = _inputs(1, seed=3, shape=(2, 5, 3, 16))
    vb = _nchw(v).to(torch.bfloat16)
    wb = [torch.from_numpy(a).to(torch.bfloat16).float() for a in (w, w1, w2)]
    h = F.conv_transpose2d(vb.float(), wb[0], stride=2).to(torch.bfloat16)
    t = torch.relu(F.conv2d(h.float(), wb[1][0], padding=1)).to(torch.bfloat16)
    want = (h.float() + F.conv2d(t.float(), wb[2][0], padding=1)).to(torch.bfloat16)
    got = up_resblock_chain_plain(vb, *(torch.from_numpy(a) for a in (w, w1, w2)))
    assert got.shape == (2, 64, 10, 6) and torch.equal(got, want)


def emulate_proj_up(v_nhwc, wpk, Co):
    """The kUp projection as ``csrc/proj2x2.cuh`` addresses it: the GEMM of
    the flat NHWC pixels with the packed rows, each 64-column block of the
    product scattered to phase ``n0 // Co``, channels ``n0 % Co``."""
    B, Hm, Wm, K = v_nhwc.shape
    prod = v_nhwc.reshape(-1, K).float() @ wpk.float().t()          # (M, 4 Co)
    p = torch.arange(B * Hm * Wm)
    b, rem = p // (Hm * Wm), p % (Hm * Wm)
    out = torch.zeros(B, 2 * Hm, 2 * Wm, Co)
    for n0 in range(0, 4 * Co, 64):
        phase, co0 = n0 // Co, n0 % Co
        y, x = 2 * (rem // Wm) + (phase >> 1), 2 * (rem % Wm) + (phase & 1)
        out[b, y, x, co0:co0 + 64] = prod[:, n0:n0 + 64]
    return out.to(torch.bfloat16)


@pytest.mark.parametrize("Ci,Co", [(128, 64), (32, 128)])
def test_packed_up_layout_replays_the_transposed_conv(Ci, Co):
    """The kernel's packed weight rows ``(ph*2 + pw)*Co + co`` and its
    epilogue's scatter give the transposed conv of every phase, on an input
    that is not symmetric: equal to :func:`up_plain` up to the f32 order of
    the sum (one bf16 ulp)."""
    rng = np.random.default_rng(Ci)
    v = torch.from_numpy(rng.standard_normal((2, 3, 5, Ci)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((Ci, Co, 2, 2)).astype(np.float32) * 0.1)
    wpk = pack_up_weights(w)
    assert wpk.shape == (4 * Co, Ci) and wpk.dtype == torch.bfloat16 and wpk.is_contiguous()
    assert wpk[(1 * 2 + 0) * Co + 5, 7] == w[7, 5, 1, 0].to(torch.bfloat16)
    got = emulate_proj_up(v, wpk, Co).permute(0, 3, 1, 2).float()
    want = up_plain(v.permute(0, 3, 1, 2), w).float()
    assert _rel(got.numpy(), want.numpy()) <= 1e-2


def test_cpu_tensor_takes_the_plain_version():
    """On a CPU tensor the op runs the plain version: no kernel launch is
    counted and nothing is built."""
    v, w, w1, w2 = _inputs(1, shape=(1, 4, 4, 16))
    args = (_nchw(v).to(torch.bfloat16), *(torch.from_numpy(a) for a in (w, w1, w2)))
    before = counters["kernel.up_resblock_chain.launches"]
    assert torch.equal(up_resblock_chain(*args), up_resblock_chain_plain(*args))
    assert counters["kernel.up_resblock_chain.launches"] == before
    assert build.load_library.cache_info().currsize == 0


@pytest.mark.parametrize("case", ["f32", "ci", "strided", "up", "chain"])
def test_kernel_input_checks_raise(case):
    """What the CUDA kernel does not take raises before any launch: non-bf16
    activations, Ci not a multiple of 16, non-contiguous activations,
    misshapen packed weights."""
    v = torch.zeros((1, 32, 4, 4), dtype=torch.bfloat16)
    wup = torch.zeros((256, 32), dtype=torch.bfloat16)
    wp = torch.zeros((2, 9, 64, 64), dtype=torch.bfloat16)
    if case == "f32":
        with pytest.raises(TypeError):
            _check_cuda(v.float(), wup, wp, wp)
        return
    bad = {"ci": (torch.zeros((1, 24, 4, 4), dtype=torch.bfloat16), wup, wp, wp),
           "strided": (torch.zeros((1, 32, 4, 8), dtype=torch.bfloat16)[..., ::2], wup, wp, wp),
           "up": (v, wup[:128], wp, wp),
           "chain": (v, wup, wp, wp[:, :, :32])}[case]
    with pytest.raises(ValueError):
        _check_cuda(*bad)
    _check_cuda(v, wup, wp, wp)
