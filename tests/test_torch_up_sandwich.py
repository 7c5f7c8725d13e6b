"""The port's sandwich op (K4, DRUNet's whole up tail) against the JAX package.

The CUDA kernel runs only on a GPU (chip_smoke.py compares it with its plain
version there). Here, on the CPU, the op takes its plain PyTorch version,
which is held to ``fused_up_sandwich_folded`` run in Pallas interpret mode, to
the JAX f32 reference ``_lax_sandwich_f32`` and to the JAX custom_vjp's
gradients, at the shapes of tests/test_models_battery2.py:148-185. The down
projection's packed layout and A-row gather (``csrc/proj2x2.cuh``) and the
conv tile's per-block weight slices at 128 channels (``csrc/conv3x3.cuh``)
are replayed in PyTorch. Inputs come from a numpy seed; the JAX package's NHWC
and W-folded tensors are transposes and reshapes of the port's NCHW ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deepinv_tpu.ops.pallas.resblock_chain import (_fold, _lax_sandwich_f32, _unfold,
                                                   fused_up_sandwich_folded)
from deepinv_tpu_torch.ops.kernels import build
from deepinv_tpu_torch.ops.kernels.resblock_chain import pack_weights
from deepinv_tpu_torch.ops.kernels.up_sandwich import (_check_cuda, pack_down_weights,
                                                       pack_sandwich, sandwich_f32,
                                                       up_sandwich, up_sandwich_plain)
from deepinv_tpu_torch.utils.profiling import counters

WEIGHTS = ("w_up2", "w1s1", "w2s1", "w_down", "w_up1", "w1s", "w2s")


def _inputs(R1=2, R0=2, seed=0, B=1, Ci2=16, H2=4, W2=4):
    """s2 (NHWC), d0 (NCHW) and the seven weights, scaled as in
    tests/test_models_battery2.py:156-165."""
    rng = np.random.default_rng(seed)

    def n(shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    s2 = n((B, H2, W2, Ci2))
    d0 = n((B, 64, 4 * H2, 4 * W2))
    ws = (n((Ci2, 128, 2, 2), 0.1), n((R1, 128, 128, 3, 3), 0.03), n((R1, 128, 128, 3, 3), 0.03),
          n((128, 64, 2, 2), 0.05), n((128, 64, 2, 2), 0.1), n((R0, 64, 64, 3, 3), 0.05),
          n((R0, 64, 64, 3, 3), 0.05))
    return s2, d0, ws


def _nchw(v_nhwc):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(v_nhwc, np.float32).transpose(0, 3, 1, 2)))


def _bf16(a):
    """A float32 array rounded to bf16, as a numpy float32 array."""
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


def _jax_args(s2, d0, ws):
    return (jnp.asarray(s2, jnp.bfloat16), _fold(jnp.asarray(d0, jnp.bfloat16)),
            *(jnp.asarray(w) for w in ws))


def test_sandwich_f32_matches_jax_reference():
    """f32 op reference vs ``_lax_sandwich_f32`` (resblock_chain.py:510): the
    same f32 arithmetic in another order, relative error <= 1e-4."""
    s2, d0, ws = _inputs()
    want = _unfold(_lax_sandwich_f32(jnp.asarray(s2), _fold(jnp.asarray(d0)),
                                     *(jnp.asarray(w) for w in ws)))
    got = sandwich_f32(_nchw(s2), torch.from_numpy(d0), *(torch.from_numpy(w) for w in ws))
    assert got.shape == (1, 64, 16, 16)
    assert _rel(got.numpy(), want) <= 1e-4


@pytest.mark.parametrize("R1,R0", [(2, 2), (1, 3)])
def test_plain_matches_pallas_interpret(R1, R0):
    """bf16 plain version vs the TPU kernel ``_sandwich_kernel`` in interpret
    mode: bf16 rounding at the same points in two implementations, relative
    max error <= 2e-2 (the JAX test's bound, test_models_battery2.py:173)."""
    s2, d0, ws = _inputs(R1, R0, seed=R1 + 4 * R0)
    want = _unfold(fused_up_sandwich_folded(*_jax_args(s2, d0, ws), True)).astype(jnp.float32)
    got = up_sandwich(_nchw(_bf16(s2)).to(torch.bfloat16),
                      torch.from_numpy(_bf16(d0)).to(torch.bfloat16),
                      *(torch.from_numpy(w) for w in ws))
    assert got.dtype == torch.bfloat16 and got.shape == (1, 64, 16, 16)
    assert _rel(got.float().numpy(), want) <= 2e-2


def test_gradients_match_jax_custom_vjp():
    """Gradients of the autograd.Function vs ``jax.grad`` through the JAX
    custom_vjp, for s2, d0 and every weight: both are autodiff of the f32
    reference, relative error <= 3e-2 (test_models_battery2.py:175-183)."""
    s2, d0, ws = _inputs(seed=9)

    def loss(*a):
        return jnp.sum(fused_up_sandwich_folded(*a, True).astype(jnp.float32))

    want = jax.grad(loss, argnums=tuple(range(9)))(*_jax_args(s2, d0, ws))
    s2t = _nchw(_bf16(s2)).to(torch.bfloat16).requires_grad_()
    d0t = torch.from_numpy(_bf16(d0)).to(torch.bfloat16).requires_grad_()
    wt = [torch.from_numpy(w).requires_grad_() for w in ws]
    up_sandwich(s2t, d0t, *wt).float().sum().backward()
    assert s2t.grad.dtype == torch.bfloat16 and wt[0].grad.dtype == torch.float32
    assert _rel(s2t.grad.float().numpy().transpose(0, 2, 3, 1), want[0].astype(jnp.float32)) <= 3e-2
    assert _rel(d0t.grad.float().numpy(), _unfold(want[1]).astype(jnp.float32)) <= 3e-2
    for name, t, g in zip(WEIGHTS, wt, want[2:]):
        assert _rel(t.grad.numpy(), g) <= 3e-2, name


def test_plain_rounds_at_the_kernel_points():
    """The plain version's rounding: the skip ``a1 + down2x2(d0)`` is summed
    in f32 and rounded once (x2 is not rounded on its own), at batch 2 and a
    ragged scale 2 of 3 x 5."""
    s2, d0, ws = _inputs(1, 1, seed=5, B=2, H2=3, W2=5)
    s2b, d0b = _nchw(s2).to(torch.bfloat16), torch.from_numpy(d0).to(torch.bfloat16)
    wb = [torch.from_numpy(w).to(torch.bfloat16).float() for w in ws]

    def block(h, w1, w2):
        t = torch.relu(F.conv2d(h.float(), w1, padding=1)).to(torch.bfloat16)
        return (h.float() + F.conv2d(t.float(), w2, padding=1)).to(torch.bfloat16)

    a1 = block(F.conv_transpose2d(s2b.float(), wb[0], stride=2).to(torch.bfloat16),
               wb[1][0], wb[2][0])
    a1 = (a1.float() + F.conv2d(d0b.float(), wb[3], stride=2)).to(torch.bfloat16)
    want = block(F.conv_transpose2d(a1.float(), wb[4], stride=2).to(torch.bfloat16),
                 wb[5][0], wb[6][0])
    got = up_sandwich_plain(s2b, d0b, *(torch.from_numpy(w) for w in ws))
    assert got.shape == (2, 64, 12, 20) and torch.equal(got, want)


def emulate_proj_down_add(d0_nhwc, wpk, dst_nhwc):
    """The kDownAdd projection as ``csrc/proj2x2.cuh`` addresses it: the A row
    of output pixel (i, j) is the two 2Cs-long runs d0[b, 2i + dh, 2j:2j+2, :]
    (k = dh*2Cs + dw*Cs + ci), times the packed rows, added to dst in f32 and
    rounded once."""
    B, H, W, Cs = d0_nhwc.shape
    rows = d0_nhwc.reshape(B, H // 2, 2, W // 2, 2 * Cs).permute(0, 1, 3, 2, 4)
    A = rows.reshape(-1, 4 * Cs).float()
    out = dst_nhwc.reshape(-1, wpk.shape[0]).float() + A @ wpk.float().t()
    return out.reshape(dst_nhwc.shape).to(torch.bfloat16)


def test_packed_down_layout_replays_the_strided_conv():
    """The kernel's packed down weight (column ``dh*128 + dw*64 + ci``) and
    its A-row gather give ``dst + conv2d(d0, w, stride=2)`` on an input that
    is not symmetric, up to the f32 order of the sum (one bf16 ulp)."""
    rng = np.random.default_rng(1)
    d0 = torch.from_numpy(rng.standard_normal((2, 64, 6, 10)).astype(np.float32)).to(torch.bfloat16)
    dst = torch.from_numpy(rng.standard_normal((2, 128, 3, 5)).astype(np.float32)).to(
        torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((128, 64, 2, 2)).astype(np.float32) * 0.1)
    wpk = pack_down_weights(w)
    assert wpk.shape == (128, 256) and wpk.dtype == torch.bfloat16 and wpk.is_contiguous()
    assert wpk[9, 1 * 128 + 0 * 64 + 3] == w[9, 3, 1, 0].to(torch.bfloat16)
    got = emulate_proj_down_add(d0.permute(0, 2, 3, 1), wpk, dst.permute(0, 2, 3, 1))
    want = (dst.float() + F.conv2d(d0.float(), w.to(torch.bfloat16).float(), stride=2))
    assert _rel(got.permute(0, 3, 1, 2).float().numpy(), want.numpy()) <= 1e-2


def emulate_conv_tile(x, wpk_layer):
    """A 3x3 conv as ``csrc/conv3x3.cuh`` stages it: the block of output
    channels ``64h:64h+64`` takes the contiguous slice ``wpk[9h:9h+9]`` (tap,
    co % 64, ci) and sums the nine shifted inputs' products in f32."""
    B, Ci, H, W = x.shape
    xp = F.pad(x.float(), (1, 1, 1, 1))
    halves = []
    for h in range(wpk_layer.shape[0] // 9):
        wb = wpk_layer[9 * h:9 * h + 9].float()
        halves.append(sum(torch.einsum("bchw,oc->bohw", xp[:, :, ky:ky + H, kx:kx + W],
                                       wb[ky * 3 + kx]) for ky in range(3) for kx in range(3)))
    return torch.cat(halves, 1)


@pytest.mark.parametrize("Co", [64, 128])
def test_packed_conv_layout_gives_each_block_its_channels(Co):
    """The conv tile's packed weights ``[(co // 64) * 9 + tap][co % 64][ci]``
    (one contiguous slice per block of 64 output channels) give the 3x3 conv
    on an input that is not symmetric, up to the f32 order of the sum."""
    rng = np.random.default_rng(Co)
    x = torch.from_numpy(rng.standard_normal((2, Co, 5, 7)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((1, Co, Co, 3, 3)).astype(np.float32) * 0.05)
    wpk = pack_weights(w)
    assert wpk.shape == (1, 9 * Co // 64, 64, Co) and wpk.is_contiguous()
    assert wpk[0, (Co // 64 - 1) * 9 + 1 * 3 + 2, 3, 5] == w[0, Co - 61, 5, 1, 2].to(torch.bfloat16)
    got = emulate_conv_tile(x, wpk[0])
    want = F.conv2d(x.float(), w[0].to(torch.bfloat16).float(), padding=1)
    assert _rel(got.numpy(), want.numpy()) <= 1e-5


def test_cpu_tensor_takes_the_plain_version():
    """On a CPU tensor the op runs the plain version: no kernel launch is
    counted and nothing is built."""
    s2, d0, ws = _inputs(1, 1, H2=2, W2=2)
    args = (_nchw(s2).to(torch.bfloat16), torch.from_numpy(d0).to(torch.bfloat16),
            *(torch.from_numpy(w) for w in ws))
    before = counters["kernel.up_sandwich.launches"]
    assert torch.equal(up_sandwich(*args), up_sandwich_plain(*args))
    assert counters["kernel.up_sandwich.launches"] == before
    assert build.load_library.cache_info().currsize == 0


@pytest.mark.parametrize("case", ["f32", "ci2", "d0", "up2", "chain1", "down"])
def test_kernel_input_checks_raise(case):
    """What the CUDA kernel does not take raises before any launch: non-bf16
    activations, Ci2 not a multiple of 16, a d0 that is not 4x s2, misshapen
    packed weights."""
    s2, d0, ws = _inputs(1, 1, H2=2, W2=2)
    s2t = _nchw(s2).to(torch.bfloat16)
    d0t = torch.from_numpy(d0).to(torch.bfloat16)
    packed = list(pack_sandwich(*(torch.from_numpy(w) for w in ws)))
    if case == "f32":
        with pytest.raises(TypeError):
            _check_cuda(s2t.float(), d0t, packed)
        return
    if case == "ci2":
        s2t = torch.zeros((1, 24, 2, 2), dtype=torch.bfloat16)
    elif case == "d0":
        d0t = d0t[..., :4]
    elif case == "up2":
        packed[0] = packed[0][:256]
    elif case == "chain1":
        packed[1] = packed[1][:, :9]
    else:
        packed[3] = packed[3].t().contiguous()
    with pytest.raises(ValueError):
        _check_cuda(s2t, d0t, packed)
