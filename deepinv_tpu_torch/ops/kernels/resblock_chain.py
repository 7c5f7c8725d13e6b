"""DRUNet scale-0 residual-block chain at 64 channels (port of
deepinv_tpu/ops/pallas/resblock_chain.py).

``resblock_chain(h, w1s, w2s)`` runs R blocks of
``h <- h + conv3x3(relu(conv3x3(h)))`` (C = 64, pad 1, bias-free) with bf16
activations, f32 accumulation and one bf16 rounding per conv — the contract of
``fused_resblock_chain_folded`` (resblock_chain.py:199, kernel
``_resblock_kernel`` :43, per-layer math ``conv_chain._layer`` :85-109).

- On a CUDA tensor it launches the hand-written kernel
  ``deepinv_tpu_torch/csrc/resblock_chain.cu`` on the wgmma + TMA conv tile
  of ``csrc/conv3x3_wgmma.cuh`` (the sources say what bounds it and how it
  is laid out; :func:`~.conv_tile.conv_tile_plan` gives its launch plan), or
  raises: there is no fallback.
- On a CPU tensor it runs :func:`resblock_chain_plain`, the plain PyTorch
  version with the kernel's rounding.
- The batch is native (a grid dimension of the kernel); the JAX package maps
  the per-image kernel with ``lax.map`` (resblock_chain.py:183-195).
- The gradient is autodiff of the f32 chain :func:`resblocks_f32`, like the
  JAX ``custom_vjp`` backward (resblock_chain.py:246-250).

``resblock_chain.launches`` counts kernel launches (one per call that reaches
the kernel), so a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

__all__ = ["resblock_chain", "resblock_chain_plain", "resblocks_f32", "pack_weights",
           "pack_weights_transposed", "check_activations", "check_packed", "int_array", "C"]

C = 64  # channel width the kernel is built for


def pack_weights(ws: torch.Tensor) -> torch.Tensor:
    """(R, Co, Ci, 3, 3) OIHW, Co a multiple of 64 -> (R, 9 * Co/64, 64, Ci)
    bf16, ``[r][(co // 64) * 9 + ky*3+kx][co % 64][ci]``: the conv tile's
    weight layout, one block's 64 output channels contiguous (at Co = 64,
    ``[r][ky*3+kx][co][ci]``). Callers that reuse weights pack them once."""
    R, Co, Ci = ws.shape[:3]
    return ws.detach().reshape(R, Co // C, C, Ci, 3, 3).permute(0, 1, 4, 5, 2, 3).reshape(
        R, 9 * (Co // C), C, Ci).to(torch.bfloat16).contiguous()


def pack_weights_transposed(ws: torch.Tensor) -> torch.Tensor:
    """(R, Co, Ci, 3, 3) OIHW -> the :func:`pack_weights` layout of the
    transposed conv's weights, ``[r][ky*3+kx][ci][co] = ws[r][co][ci][2-ky][2-kx]``
    (at 64 channels): the taps flipped and input and output swapped, so that
    the conv tile computes a conv's input gradient as a conv (``_bwd``'s
    ``flip``/``swapaxes``, deepinv_tpu/ops/pallas/conv_chain.py:447-448).
    Callers pack once per weight version, as for :func:`pack_weights`."""
    return pack_weights(ws.detach().transpose(1, 2).flip((3, 4)))


def resblocks_f32(h, w1s, w2s):
    """f32 reference of the chain on NCHW (counterpart of
    ``_lax_resblocks_f32``, resblock_chain.py:139); the backward of
    :func:`resblock_chain` is autodiff of this function."""
    h = h.float()
    for r in range(w1s.shape[0]):
        t = F.relu(F.conv2d(h, w1s[r].float(), padding=1))
        h = h + F.conv2d(t, w2s[r].float(), padding=1)
    return h


def resblock_chain_plain(h, w1s, w2s):
    """Plain PyTorch version with the kernel's rounding: f32 convs of bf16
    values, ReLU and residual add in f32, one bf16 rounding per conv."""
    h = h.to(torch.bfloat16)
    w1s = w1s.to(torch.bfloat16).float()
    w2s = w2s.to(torch.bfloat16).float()
    for r in range(w1s.shape[0]):
        t = F.relu(F.conv2d(h.float(), w1s[r], padding=1)).to(torch.bfloat16)
        h = (h.float() + F.conv2d(t.float(), w2s[r], padding=1)).to(torch.bfloat16)
    return h


def check_activations(h, op: str, channels: int = C):
    """Raise unless ``h`` is what the port's chain kernels take:
    ``(B, channels, H, W)`` bf16, contiguous NCHW or channels_last."""
    if h.dtype != torch.bfloat16:
        raise TypeError(f"{op} kernel takes bf16 activations, got {h.dtype}")
    if h.dim() != 4 or h.shape[1] != channels or min(h.shape) < 1:
        raise ValueError(f"{op} kernel takes (B, {channels}, H, W), got {tuple(h.shape)}")
    if not (h.is_contiguous() or h.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError(f"{op} kernel takes a contiguous NCHW or channels_last tensor")


def check_packed(h, ws, shape, what: str):
    """Raise unless every packed weight in ``ws`` is a contiguous bf16 tensor
    of ``shape`` on ``h``'s device, 16-byte aligned (TMA reads it)."""
    for w in ws:
        if (tuple(w.shape) != tuple(shape) or w.dtype != torch.bfloat16
                or not w.is_contiguous() or w.device != h.device or w.data_ptr() % 16):
            raise ValueError(f"packed {what} must be contiguous, 16-byte aligned "
                             f"{tuple(shape)} bf16 on the activations' device")


def _check_cuda(h, w1p, w2p):
    check_activations(h, "resblock_chain")
    check_packed(h, (w1p, w2p), (w1p.shape[0], 9, C, C), "weights (see pack_weights)")


def tile_args(h, tile: str):
    """The C entry point's name suffix and trailing plan arguments for the
    conv tile ``tile``: ``"wgmma"`` (the default: wgmma + TMA,
    ``csrc/conv3x3_wgmma.cuh``, with the plan of ``conv_tile_plan``) or
    ``"mma"`` (the earlier mma.sync tile of ``csrc/conv3x3.cuh``, kept so that
    the two can be timed side by side)."""
    if tile == "mma":
        return "", ()
    if tile != "wgmma":
        raise ValueError(f"tile must be 'wgmma' or 'mma', got {tile!r}")
    from .conv_tile import conv_tile_plan

    B, _, H, W = h.shape
    plan = conv_tile_plan(B, H, W, _sms(h.device.index))
    return "_wgmma", (plan.strip, plan.depth, plan.smem_bytes, plan.rows_per_cta, plan.grid)


@functools.lru_cache(maxsize=None)
def _sms(index) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def int_array(values):
    """``values`` as a C int array: the launch plans the C entry points take."""
    return (ctypes.c_int * len(values))(*values)


def _launch(h, w1p, w2p, tile: str = "wgmma"):
    """Run the CUDA kernel: NCHW -> NHWC copy into the ping-pong buffer ``a``,
    2R conv launches, and ``a`` handed back as an NCHW view (channels_last
    memory). ``tile`` is private: see :func:`tile_args`."""
    from .build import load_library

    _check_cuda(h, w1p, w2p)
    suffix, plan = tile_args(h, tile)
    lib = load_library()
    B, _, H, W = h.shape
    a = torch.empty((B, H, W, C), dtype=torch.bfloat16, device=h.device)
    a.copy_(h.permute(0, 2, 3, 1))
    t = torch.empty_like(a)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        rc = getattr(lib, f"deepinv_resblock_chain{suffix}_bf16")(
            ctypes.c_void_p(a.data_ptr()), ctypes.c_void_p(t.data_ptr()),
            ctypes.c_void_p(w1p.data_ptr()), ctypes.c_void_p(w2p.data_ptr()),
            B, H, W, int(w1p.shape[0]), *plan, ctypes.c_void_p(stream))
    if rc != 0:
        msg = lib.deepinv_cuda_error_string(rc).decode()
        raise RuntimeError(f"resblock_chain kernel launch failed: CUDA error {rc} ({msg})")
    resblock_chain.launches += 1
    return a.permute(0, 3, 1, 2)


class _ResblockChain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w1s, w2s, w1p, w2p):
        ctx.save_for_backward(h, w1s, w2s)
        if h.is_cuda:
            return _launch(h, w1p, w2p)
        return resblock_chain_plain(h, w1s, w2s)

    @staticmethod
    def backward(ctx, g):
        h, w1s, w2s = ctx.saved_tensors
        with torch.enable_grad():
            args = [v.detach().float().requires_grad_() for v in (h, w1s, w2s)]
            out = resblocks_f32(*args)
            dh, dw1, dw2 = torch.autograd.grad(out, args, g.float())
        return dh.to(h.dtype), dw1.to(w1s.dtype), dw2.to(w2s.dtype), None, None


def resblock_chain(h, w1s, w2s, packed=None):
    """R residual blocks at C = 64: ``h + conv2(relu(conv1(h)))`` applied R
    times, bf16 in and out.

    :param h: ``(B, 64, H, W)`` bf16 activations (B, H, W >= 1).
    :param w1s: stacked OIHW conv1 weights ``(R, 64, 64, 3, 3)``.
    :param w2s: stacked OIHW conv2 weights ``(R, 64, 64, 3, 3)``.
    :param packed: ``(pack_weights(w1s), pack_weights(w2s))`` if the caller
        keeps them; packed here otherwise (CUDA only).
    :return: ``(B, 64, H, W)`` bf16. From the kernel it is an NCHW view of
        channels_last memory.
    """
    if packed is None:
        packed = ((pack_weights(w1s), pack_weights(w2s)) if h.is_cuda
                  else (None, None))
    return _ResblockChain.apply(h, w1s, w2s, *packed)


resblock_chain.launches = 0
