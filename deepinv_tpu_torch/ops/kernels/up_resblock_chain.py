"""DRUNet scale-0 up path: 2x2 stride-2 transposed conv + resblock chain
(port of ``fused_up_resblock_chain_folded``, deepinv_tpu/ops/pallas/
resblock_chain.py:302).

``up_resblock_chain(v, w_up, w1s, w2s)`` computes ``_lax_up_resblocks_f32``'s
function (resblock_chain.py:270) with the TPU kernels' rounding: the
transposed conv (Ci -> 64, kernel == stride) with f32 accumulation and one
bf16 rounding, then R blocks of ``h <- h + conv3x3(relu(conv3x3(h)))`` with one
rounding per conv. The skip add ``v + x2`` is the caller's, already rounded.

- On a CUDA tensor it launches the hand-written kernels of
  ``deepinv_tpu_torch/csrc/up_resblock_chain.cu`` (the source says what bounds
  it and how it is laid out): the projection on the wgmma + TMA kernel of
  ``csrc/proj2x2_wgmma.cuh`` and the chain on K1's 64-channel wgmma tile
  (launch plans :func:`~.conv_tile.proj_plan` and
  :func:`~.conv_tile.conv_tile_plan`), or raises: there is no fallback. The
  two TPU variants, ``_up_resblock_kernel`` :62 (the projection in the kernel) and
  ``_up_resblock_kernel2`` :97 (the projection in XLA, the default), compute
  the same function and differ only in where the H-interleave happens; here
  it is the projection's epilogue, so one op stands for both.
- On a CPU tensor it runs :func:`up_resblock_chain_plain`, the plain PyTorch
  version with the kernel's rounding.
- The batch is native (a grid dimension); the JAX gate fuses at B = 1 only
  (resblock_chain.py:292).
- The gradient is autodiff of the f32 reference :func:`up_resblocks_f32`, like
  the JAX ``custom_vjp`` backward (resblock_chain.py:394-399).

``profiling.counters["kernel.up_resblock_chain.launches"]`` counts kernel
launches (one per call that reaches the kernel); each call opens the span
``dinv.kernel.up_resblock_chain`` with its analytic cost
(:func:`up_resblock_chain_cost`).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ...utils.profiling import counters, kernel_span
from .resblock_chain import (C, _sms, check_activations, check_packed, count_tile_launches,
                             first_order_only, int_array, pack_weights, resblock_chain_plain,
                             resblocks_f32)

__all__ = ["up_resblock_chain", "up_resblock_chain_plain", "up_resblocks_f32",
           "pack_up_weights", "pack_up_chain", "up_plain"]


def pack_up_weights(w_iohw: torch.Tensor) -> torch.Tensor:
    """(Ci, Co, 2, 2) IOHW transposed-conv weight -> (4*Co, Ci) bf16 with
    row ``(ph*2 + pw)*Co + co``: the projection kernels' weight layout
    (``csrc/proj2x2_wgmma.cuh`` and ``csrc/proj2x2.cuh``, kUp)."""
    Ci, Co = w_iohw.shape[:2]
    return w_iohw.detach().permute(2, 3, 1, 0).reshape(4 * Co, Ci).to(
        torch.bfloat16).contiguous()


def pack_up_chain(w_up, w1s, w2s):
    """The three weights in the kernel's layouts, in argument order."""
    return pack_up_weights(w_up), pack_weights(w1s), pack_weights(w2s)


def up_plain(v, w_iohw):
    """The transposed conv (kernel == stride) in f32 on bf16 values, rounded
    to bf16 once: the projection as the kernel computes it."""
    w = w_iohw.to(torch.bfloat16).float()
    return F.conv_transpose2d(v.to(torch.bfloat16).float(), w, stride=2).to(torch.bfloat16)


def up_resblocks_f32(v, w_iohw, w1s, w2s):
    """f32 reference on NCHW (counterpart of ``_lax_up_resblocks_f32``,
    resblock_chain.py:270); the backward of :func:`up_resblock_chain` is
    autodiff of this function."""
    return resblocks_f32(F.conv_transpose2d(v.float(), w_iohw.float(), stride=2), w1s, w2s)


def up_resblock_chain_plain(v, w_iohw, w1s, w2s):
    """Plain PyTorch version with the kernel's rounding: the projection
    rounded once, then :func:`resblock_chain_plain`."""
    return resblock_chain_plain(up_plain(v, w_iohw), w1s, w2s)


def _check_cuda(v, wup, w1p, w2p):
    if v.dim() != 4 or v.shape[1] % 16:
        raise ValueError("up_resblock_chain kernel takes (B, Ci, H/2, W/2) with Ci a multiple "
                         f"of 16, got {tuple(v.shape)}")
    check_activations(v, "up_resblock_chain", v.shape[1])
    check_packed(v, (wup,), (4 * C, v.shape[1]), "up weight (see pack_up_weights)")
    check_packed(v, (w1p, w2p), (w1p.shape[0], 9, C, C), "chain weights (see pack_weights)")


def _launch(v, wup, w1p, w2p, tile: str = "wgmma"):
    """Run the CUDA kernel: ``v`` read in channels_last memory (a copy only
    if it is NCHW-contiguous), the projection into the ping-pong buffer
    ``a``, 2R conv launches, and ``a`` handed back as an NCHW view
    (channels_last memory). ``tile`` is private: ``"wgmma"`` (the default)
    or ``"mma"``, the earlier mma.sync kernels, kept so that the two can be
    timed side by side."""
    from .build import load_library
    from .conv_tile import conv_tile_plan, proj_plan

    _check_cuda(v, wup, w1p, w2p)
    if tile not in ("wgmma", "mma"):
        raise ValueError(f"tile must be 'wgmma' or 'mma', got {tile!r}")
    lib = load_library()
    B, Ci, H2, W2 = v.shape
    R = int(w1p.shape[0])
    src = v.contiguous(memory_format=torch.channels_last)
    a = torch.empty((B, 2 * H2, 2 * W2, C), dtype=torch.bfloat16, device=v.device)
    t = torch.empty_like(a)
    ptrs = [ctypes.c_void_p(x.data_ptr()) for x in (src, a, t, wup, w1p, w2p)]
    with torch.cuda.device(v.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(v.device).cuda_stream)
        if tile == "mma":
            rc = lib.deepinv_up_resblock_chain_bf16(*ptrs, B, H2, W2, Ci, R, stream)
        else:
            sms = _sms(v.device.index)
            chain = conv_tile_plan(B, 2 * H2, 2 * W2, sms).args()
            plans = proj_plan("up", B, H2, W2, Ci, C, sms).args() + chain
            rc = lib.deepinv_up_resblock_chain_wgmma_bf16(*ptrs, B, H2, W2, Ci, R,
                                                          int_array(plans), stream)
    if rc != 0:
        msg = lib.deepinv_cuda_error_string(rc).decode()
        raise RuntimeError(f"up_resblock_chain kernel launch failed: CUDA error {rc} ({msg})")
    counters["kernel.up_resblock_chain.launches"] += 1
    if tile == "wgmma":
        count_tile_launches(chain, 2 * R)
    return a.permute(0, 3, 1, 2)


class _UpResblockChain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, w_up, w1s, w2s, wup_p, w1p, w2p):
        ctx.save_for_backward(v, w_up, w1s, w2s)
        if v.is_cuda:
            return _launch(v, wup_p, w1p, w2p)
        return up_resblock_chain_plain(v, w_up, w1s, w2s)

    @staticmethod
    def backward(ctx, g):
        """Autodiff of the f32 version on detached copies; no second
        derivative (:func:`~.resblock_chain.first_order_only`)."""
        saved = ctx.saved_tensors
        with torch.enable_grad():
            args = [x.detach().float().requires_grad_() for x in saved]
            grads = torch.autograd.grad(up_resblocks_f32(*args), args, g.detach().float())
        grads = first_order_only("up_resblock_chain",
                                 [d.to(x.dtype) for d, x in zip(grads, saved)], (g, *saved))
        return (*grads, None, None, None)


def up_resblock_chain_cost(B: int, H2: int, W2: int, R: int):
    """Analytic (flops, HBM bytes) of the op on ``(B, Ci, H2, W2)``: B times
    the JAX package's count of one image in its default variant, the
    projection in XLA (resblock_chain.py:359-361)."""
    H, G = 2 * H2, W2
    flops = R * 2 * (2 * H * (2 * G) * C * C * 9)
    nbytes = 2 * (H2 * (G + 2) + H * G // 2) * 128 * 2 + 2 * R * 3 * 2 * 128 * 128 * 2
    return B * flops, B * nbytes


def up_resblock_chain(v, w_up, w1s, w2s, packed=None):
    """Transposed-conv upsample (2x2, stride 2, Ci -> 64) and R residual
    blocks at C = 64, bf16 in and out.

    :param v: ``(B, Ci, H/2, W/2)`` bf16 activations, the skip add already
        applied; Ci a multiple of 16 on the GPU.
    :param w_up: transposed-conv weight ``(Ci, 64, 2, 2)`` (IOHW).
    :param w1s: stacked OIHW conv1 weights ``(R, 64, 64, 3, 3)``.
    :param w2s: stacked OIHW conv2 weights ``(R, 64, 64, 3, 3)``.
    :param packed: :func:`pack_up_chain` of the three weights if the caller
        keeps them; packed here otherwise (CUDA only).
    :return: ``(B, 64, H, W)`` bf16. From the kernel it is an NCHW view of
        channels_last memory.
    """
    with kernel_span("up_resblock_chain", *up_resblock_chain_cost(
            v.shape[0], v.shape[2], v.shape[3], w1s.shape[0])):
        if packed is None:
            packed = pack_up_chain(w_up, w1s, w2s) if v.is_cuda else (None,) * 3
        return _UpResblockChain.apply(v, w_up, w1s, w2s, *packed)
