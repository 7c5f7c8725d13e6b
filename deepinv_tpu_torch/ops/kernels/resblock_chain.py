"""DRUNet scale-0 residual-block chain at 64 channels (port of
deepinv_tpu/ops/pallas/resblock_chain.py).

``resblock_chain(h, w1s, w2s)`` runs R blocks of
``h <- h + conv3x3(relu(conv3x3(h)))`` (C = 64, pad 1, bias-free) with bf16
activations, f32 accumulation and one bf16 rounding per conv — the contract of
``fused_resblock_chain_folded`` (resblock_chain.py:199, kernel
``_resblock_kernel`` :43, per-layer math ``conv_chain._layer`` :85-109).

- On a CUDA tensor it launches the hand-written kernel
  ``deepinv_tpu_torch/csrc/resblock_chain.cu`` (the source says what bounds it
  and how it is laid out), or raises: there is no fallback.
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

import torch
import torch.nn.functional as F

__all__ = ["resblock_chain", "resblock_chain_plain", "resblocks_f32",
           "pack_weights", "check_activations", "C"]

C = 64  # channel width the kernel is built for


def pack_weights(ws: torch.Tensor) -> torch.Tensor:
    """(R, 64, 64, 3, 3) OIHW -> (R, 9, 64, 64) bf16, ``[r][ky*3+kx][co][ci]``:
    the kernel's weight layout. Callers that reuse weights pack them once."""
    R = ws.shape[0]
    return ws.detach().permute(0, 3, 4, 1, 2).reshape(R, 9, C, C).to(
        torch.bfloat16).contiguous()


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


def check_activations(h, op: str):
    """Raise unless ``h`` is what the port's 64-channel chain kernels take:
    ``(B, 64, H, W)`` bf16, contiguous NCHW or channels_last."""
    if h.dtype != torch.bfloat16:
        raise TypeError(f"{op} kernel takes bf16 activations, got {h.dtype}")
    if h.dim() != 4 or h.shape[1] != C or min(h.shape) < 1:
        raise ValueError(f"{op} kernel takes (B, {C}, H, W), got {tuple(h.shape)}")
    if not (h.is_contiguous() or h.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError(f"{op} kernel takes a contiguous NCHW or channels_last tensor")


def _check_cuda(h, w1p, w2p):
    check_activations(h, "resblock_chain")
    R = w1p.shape[0]
    for w in (w1p, w2p):
        if (w.shape != (R, 9, C, C) or w.dtype != torch.bfloat16
                or not w.is_contiguous() or w.device != h.device):
            raise ValueError("packed weights must be contiguous (R, 9, 64, 64) bf16 "
                             "on the activations' device (see pack_weights)")


def _launch(h, w1p, w2p):
    """Run the CUDA kernel: NCHW -> NHWC copy into the ping-pong buffer ``a``,
    2R conv launches, and ``a`` handed back as an NCHW view (channels_last
    memory)."""
    from .build import load_library

    _check_cuda(h, w1p, w2p)
    lib = load_library()
    B, _, H, W = h.shape
    a = torch.empty((B, H, W, C), dtype=torch.bfloat16, device=h.device)
    a.copy_(h.permute(0, 2, 3, 1))
    t = torch.empty_like(a)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        rc = lib.deepinv_resblock_chain_bf16(
            ctypes.c_void_p(a.data_ptr()), ctypes.c_void_p(t.data_ptr()),
            ctypes.c_void_p(w1p.data_ptr()), ctypes.c_void_p(w2p.data_ptr()),
            B, H, W, int(w1p.shape[0]), ctypes.c_void_p(stream))
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
