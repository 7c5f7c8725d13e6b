"""DRUNet's whole up tail below scale 2, the "sandwich" (port of
``fused_up_sandwich_folded``, deepinv_tpu/ops/pallas/resblock_chain.py:579).

``up_sandwich(s2, d0, w_up2, w1s1, w2s1, w_down, w_up1, w1s, w2s)`` computes
``_lax_sandwich_f32``'s function (resblock_chain.py:510) with the rounding of
the TPU kernel ``_sandwich_kernel`` (:442), f32 accumulation throughout:

1. the up2 projection (transposed conv 2x2 stride 2, Ci2 -> 128), rounded
   to bf16 once;
2. R1 scale-1 blocks at C = 128: conv1 then ReLU, rounded once; conv2 plus
   the residual in f32, rounded once;
3. the skip ``a1 <- bf16(a1 + down2x2(d0))``: the strided conv of the scale-0
   down-chain output ``d0`` (w_down, 128 <- 64) recomputed and added in f32,
   the sum rounded once (x2 is never rounded on its own here, unlike the
   unfused path, resblock_chain.py:479-485);
4. the up1 projection (128 -> 64), rounded once;
5. R0 scale-0 blocks at C = 64, as ``resblock_chain``.

- On a CUDA tensor it launches the hand-written kernels of
  ``deepinv_tpu_torch/csrc/up_sandwich.cu`` (the source says what bounds it and
  how it is laid out), or raises: there is no fallback. Every stage runs on
  wgmma fed by TMA: the three projections on ``csrc/proj2x2_wgmma.cuh``, the
  scale-1 chain on the 128-channel cluster tile of
  ``csrc/conv3x3_c128_wgmma.cuh``, the scale-0 chain on K1's 64-channel tile
  (launch plans in :mod:`~.conv_tile`).
- On a CPU tensor it runs :func:`up_sandwich_plain`, the plain PyTorch version
  with the kernel's rounding.
- The batch is native (a grid dimension); the JAX gate fuses at B = 1 only
  (resblock_chain.py:550).
- The gradient is autodiff of the f32 reference :func:`sandwich_f32`, like the
  JAX ``custom_vjp`` backward (resblock_chain.py:647-654).

``up_sandwich.launches`` counts kernel launches (one per call that reaches
the kernel).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .resblock_chain import (C, _sms, check_activations, check_packed, first_order_only,
                             int_array, pack_weights, resblock_chain_plain, resblocks_f32)
from .up_resblock_chain import pack_up_weights, up_plain

__all__ = ["up_sandwich", "up_sandwich_plain", "sandwich_f32", "pack_down_weights",
           "pack_sandwich"]

C1 = 2 * C  # scale-1 channels the kernel is built for


def pack_down_weights(w_oihw: torch.Tensor) -> torch.Tensor:
    """(Co, Ci, 2, 2) OIHW strided-conv weight -> (Co, 4*Ci) bf16 with
    column ``dh*2Ci + dw*Ci + ci``: the down-projection kernels' layout
    (``csrc/proj2x2_wgmma.cuh`` and ``csrc/proj2x2.cuh``, kDownAdd)."""
    Co, Ci = w_oihw.shape[:2]
    return w_oihw.detach().permute(0, 2, 3, 1).reshape(Co, 4 * Ci).to(
        torch.bfloat16).contiguous()


def pack_sandwich(w_up2, w1s1, w2s1, w_down, w_up1, w1s, w2s):
    """All seven weights in the kernel's layouts, in argument order."""
    return (pack_up_weights(w_up2), pack_weights(w1s1), pack_weights(w2s1),
            pack_down_weights(w_down), pack_up_weights(w_up1), pack_weights(w1s),
            pack_weights(w2s))


def sandwich_f32(s2, d0, w_up2, w1s1, w2s1, w_down, w_up1, w1s, w2s):
    """f32 reference on NCHW (counterpart of ``_lax_sandwich_f32``,
    resblock_chain.py:510); the backward of :func:`up_sandwich` is autodiff
    of this function."""
    a1 = resblocks_f32(F.conv_transpose2d(s2.float(), w_up2.float(), stride=2), w1s1, w2s1)
    a1 = a1 + F.conv2d(d0.float(), w_down.float(), stride=2)
    return resblocks_f32(F.conv_transpose2d(a1, w_up1.float(), stride=2), w1s, w2s)


def up_sandwich_plain(s2, d0, w_up2, w1s1, w2s1, w_down, w_up1, w1s, w2s):
    """Plain PyTorch version with the kernel's rounding: f32 arithmetic on
    bf16 values, one bf16 rounding at each of the points listed above."""
    a1 = resblock_chain_plain(up_plain(s2, w_up2), w1s1, w2s1)
    wd = w_down.to(torch.bfloat16).float()
    a1 = (a1.float() + F.conv2d(d0.to(torch.bfloat16).float(), wd, stride=2)).to(torch.bfloat16)
    return resblock_chain_plain(up_plain(a1, w_up1), w1s, w2s)


def _check_cuda(s2, d0, packed):
    if s2.dim() != 4 or s2.shape[1] % 16:
        raise ValueError("up_sandwich kernel takes s2 (B, Ci2, H/4, W/4) with Ci2 a multiple "
                         f"of 16, got {tuple(s2.shape)}")
    B, Ci2, H2, W2 = s2.shape
    check_activations(s2, "up_sandwich", Ci2)
    check_activations(d0, "up_sandwich")
    want = (B, C, 4 * H2, 4 * W2)
    if tuple(d0.shape) != want or d0.device != s2.device:
        raise ValueError(f"up_sandwich kernel takes d0 {want} on s2's device, "
                         f"got {tuple(d0.shape)}")
    wup2, w1s1, w2s1, wd, wup1, w1s, w2s = packed
    check_packed(s2, (wup2,), (4 * C1, Ci2), "up2 weight (see pack_up_weights)")
    check_packed(s2, (w1s1, w2s1), (w1s1.shape[0], 18, C, C1),
                 "scale-1 chain weights (see pack_weights)")
    check_packed(s2, (wd,), (C1, 4 * C), "down weight (see pack_down_weights)")
    check_packed(s2, (wup1,), (4 * C, C1), "up1 weight (see pack_up_weights)")
    check_packed(s2, (w1s, w2s), (w1s.shape[0], 9, C, C), "scale-0 chain weights")


@functools.lru_cache(maxsize=None)
def _c128_clusters(index) -> int:
    """How many clusters of the 128-channel tile device ``index`` holds at
    once (the plan's wave); raises if none."""
    from .build import load_library

    lib = load_library()
    with torch.cuda.device(index):
        count = lib.deepinv_conv_c128_max_clusters()
    if count <= 0:
        why = (f"CUDA error {-count} ({lib.deepinv_cuda_error_string(-count).decode()})"
               if count < 0 else "0 clusters fit")
        raise RuntimeError(f"up_sandwich: the device holds no cluster of the 128-channel conv "
                           f"tile: {why}")
    return count


def _launch(s2, d0, packed, tile: str = "wgmma"):
    """Run the CUDA kernel: s2 and d0 read in channels_last memory (a copy
    only if NCHW-contiguous), the scale-1 and scale-0 ping-pong buffers
    allocated here, and the scale-0 result handed back as an NCHW view
    (channels_last memory). ``tile`` is private: ``"wgmma"`` (the default)
    or ``"mma"``, the earlier mma.sync kernels, kept so that the two can be
    timed side by side."""
    from .build import load_library
    from .conv_tile import conv128_tile_plan, conv_tile_plan, proj_plan

    _check_cuda(s2, d0, packed)
    if tile not in ("wgmma", "mma"):
        raise ValueError(f"tile must be 'wgmma' or 'mma', got {tile!r}")
    lib = load_library()
    B, Ci2, H2, W2 = s2.shape
    H1, W1 = 2 * H2, 2 * W2
    src2 = s2.contiguous(memory_format=torch.channels_last)
    src0 = d0.contiguous(memory_format=torch.channels_last)
    kw = {"dtype": torch.bfloat16, "device": s2.device}
    a1 = torch.empty((B, H1, W1, C1), **kw)
    t1 = torch.empty_like(a1)
    a0 = torch.empty((B, 2 * H1, 2 * W1, C), **kw)
    t0 = torch.empty_like(a0)
    ptrs = [ctypes.c_void_p(x.data_ptr()) for x in (src2, src0, a1, t1, a0, t0, *packed)]
    dims = (B, H2, W2, Ci2, int(packed[1].shape[0]), int(packed[5].shape[0]))
    with torch.cuda.device(s2.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(s2.device).cuda_stream)
        if tile == "mma":
            rc = lib.deepinv_up_sandwich_bf16(*ptrs, *dims, stream)
        else:
            idx = s2.device.index
            sms = _sms(idx)
            plans = (proj_plan("up", B, H2, W2, Ci2, C1, sms).args()
                     + conv128_tile_plan(B, H1, W1, _c128_clusters(idx)).args()
                     + proj_plan("down_add", B, H1, W1, 4 * C, C1, sms).args()
                     + proj_plan("up", B, H1, W1, C1, C, sms).args()
                     + conv_tile_plan(B, 2 * H1, 2 * W1, sms).args())
            rc = lib.deepinv_up_sandwich_wgmma_bf16(*ptrs, *dims, int_array(plans), stream)
    if rc != 0:
        msg = lib.deepinv_cuda_error_string(rc).decode()
        raise RuntimeError(f"up_sandwich kernel launch failed: CUDA error {rc} ({msg})")
    up_sandwich.launches += 1
    return a0.permute(0, 3, 1, 2)


def _chain128(h, w1p, w2p):
    """The scale-1 chain alone on the 128-channel cluster tile: R blocks of
    ``h <- h + conv(relu(conv(h)))`` on ``h`` (B, 128, H, W) bf16 with packed
    weights (R, 18, 64, 128) (:func:`pack_weights`). Private: it holds the
    tile to :func:`resblock_chain_plain` on its own, and counts no launch."""
    from .build import load_library
    from .conv_tile import conv128_tile_plan

    check_activations(h, "up_sandwich scale-1 chain", C1)
    check_packed(h, (w1p, w2p), (w1p.shape[0], 18, C, C1), "scale-1 chain weights")
    lib = load_library()
    B, _, H, W = h.shape
    a = torch.empty((B, H, W, C1), dtype=torch.bfloat16, device=h.device)
    a.copy_(h.permute(0, 2, 3, 1))
    t = torch.empty_like(a)
    with torch.cuda.device(h.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(h.device).cuda_stream)
        plan = conv128_tile_plan(B, H, W, _c128_clusters(h.device.index)).args()
        rc = lib.deepinv_resblock_chain_c128_wgmma_bf16(
            *(ctypes.c_void_p(x.data_ptr()) for x in (a, t, w1p, w2p)), B, H, W,
            int(w1p.shape[0]), int_array(plan), stream)
    if rc != 0:
        msg = lib.deepinv_cuda_error_string(rc).decode()
        raise RuntimeError(f"up_sandwich scale-1 chain launch failed: CUDA error {rc} ({msg})")
    return a.permute(0, 3, 1, 2)


class _UpSandwich(torch.autograd.Function):
    @staticmethod
    def forward(ctx, s2, d0, *rest):
        weights, packed = rest[:7], rest[7:]
        ctx.save_for_backward(s2, d0, *weights)
        if s2.is_cuda:
            return _launch(s2, d0, packed)
        return up_sandwich_plain(s2, d0, *weights)

    @staticmethod
    def backward(ctx, g):
        """Autodiff of the f32 version on detached copies; no second
        derivative (:func:`~.resblock_chain.first_order_only`)."""
        saved = ctx.saved_tensors
        with torch.enable_grad():
            args = [x.detach().float().requires_grad_() for x in saved]
            grads = torch.autograd.grad(sandwich_f32(*args), args, g.detach().float())
        grads = first_order_only("up_sandwich", [d.to(x.dtype) for d, x in zip(grads, saved)],
                                 (g, *saved))
        return (*grads, *([None] * 7))


def up_sandwich(s2, d0, w_up2, w1s1, w2s1, w_down, w_up1, w1s, w2s, packed=None):
    """DRUNet's up tail below scale 2 as one op, bf16 in and out.

    :param s2: scale-2 activations ``(B, Ci2, H/4, W/4)`` bf16, the skip add
        ``v + x3`` already applied; Ci2 a multiple of 16 on the GPU.
    :param d0: scale-0 down-chain output ``(B, 64, H, W)`` bf16.
    :param w_up2: up2 transposed-conv weight ``(Ci2, 128, 2, 2)`` (IOHW).
    :param w1s1: stacked scale-1 conv1 weights ``(R1, 128, 128, 3, 3)``.
    :param w2s1: stacked scale-1 conv2 weights ``(R1, 128, 128, 3, 3)``.
    :param w_down: scale-0 -> 1 strided-conv weight ``(128, 64, 2, 2)`` (OIHW).
    :param w_up1: up1 transposed-conv weight ``(128, 64, 2, 2)`` (IOHW).
    :param w1s: stacked scale-0 conv1 weights ``(R0, 64, 64, 3, 3)``.
    :param w2s: stacked scale-0 conv2 weights ``(R0, 64, 64, 3, 3)``.
    :param packed: :func:`pack_sandwich` of the seven weights if the caller
        keeps them; packed here otherwise (CUDA only).
    :return: ``(B, 64, H, W)`` bf16, before DRUNet's tail skip. From the kernel
        it is an NCHW view of channels_last memory.
    """
    weights = (w_up2, w1s1, w2s1, w_down, w_up1, w1s, w2s)
    if packed is None:
        packed = pack_sandwich(*weights) if s2.is_cuda else (None,) * 7
    return _UpSandwich.apply(s2, d0, *weights, *packed)


up_sandwich.launches = 0
