"""DnCNN conv3x3 + bias + ReLU chain at 64 channels (port of
deepinv_tpu/ops/pallas/conv_chain.py).

``conv_chain(h, ws, bs)`` runs L layers of ``h <- bf16(relu(conv3x3(h) + b))``
(C = 64, pad 1) with f32 accumulation, the bias added in f32 and one bf16
rounding per layer — the contract of ``fused_conv3x3_relu_chain``
(conv_chain.py:276, kernel ``_chain_kernel`` :112, per-layer math ``_layer``
:85-109, odd tail ``_lax_chain`` :175).

- On a CUDA tensor it launches the hand-written kernel
  ``deepinv_tpu_torch/csrc/conv_chain.cu`` (the source says what bounds it and
  how it is laid out), or raises: there is no fallback. Any L >= 1 runs in the
  kernel; the TPU kernel fuses an even prefix and runs an odd last layer in
  XLA (:323-324).
- On a CPU tensor it runs :func:`conv_chain_plain`, the plain PyTorch version
  with the kernel's rounding (``_lax_chain``'s arithmetic).
- The batch is native (a grid dimension of the kernel); the JAX package maps
  the per-image kernel with ``lax.map`` (conv_chain.py:262-272).
- The gradient is autodiff of the chain in f32 with the forward's bf16
  rounding points. The JAX package's custom backward over stashed activations
  (``_fwd``/``_bwd`` :386-460, TPU kernel K6) is training, and waits for
  ROADMAP queue 1 item 7.

``conv_chain.launches`` counts kernel launches (one per call that reaches the
kernel), so a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .resblock_chain import C, check_activations, pack_weights

__all__ = ["conv_chain", "conv_chain_plain", "chain_f32", "pack_weights", "pack_bias", "C"]


def pack_bias(bs: torch.Tensor) -> torch.Tensor:
    """(L, 64) biases -> contiguous f32, the kernel's bias layout."""
    return bs.detach().float().contiguous()


def chain_f32(h, ws, bs):
    """f32 reference of the chain (counterpart of ``_lax_chain_f32``,
    conv_chain.py:189)."""
    h = h.float()
    for l in range(ws.shape[0]):
        h = F.relu(F.conv2d(h, ws[l].float(), bs[l].float(), padding=1))
    return h


def _chain_rounded(h, ws, bs):
    """The chain in f32 with the kernel's bf16 rounding points, in a form
    autograd differentiates: bf16 weights, the bias in f32, one bf16 rounding
    per layer (``_chain_bf16_rounded`` of tests/test_models.py:633-645)."""
    a = h.float()
    for l in range(ws.shape[0]):
        z = F.conv2d(a, ws[l].to(torch.bfloat16).float(), bs[l].float(), padding=1)
        a = F.relu(z).to(torch.bfloat16).float()
    return a


def conv_chain_plain(h, ws, bs):
    """Plain PyTorch version with the kernel's rounding: f32 convs of bf16
    values, bias and ReLU in f32, one bf16 rounding per layer."""
    return _chain_rounded(h.to(torch.bfloat16), ws, bs).to(torch.bfloat16)


def _check_cuda(h, wp, bp):
    check_activations(h, "conv_chain")
    L = wp.shape[0]
    if (L < 1 or wp.shape != (L, 9, C, C) or wp.dtype != torch.bfloat16
            or not wp.is_contiguous() or wp.device != h.device):
        raise ValueError("packed weights must be contiguous (L, 9, 64, 64) bf16 with L >= 1 "
                         "on the activations' device (see pack_weights)")
    if (bp.shape != (L, C) or bp.dtype != torch.float32 or not bp.is_contiguous()
            or bp.device != h.device):
        raise ValueError("packed biases must be contiguous (L, 64) float32 on the "
                         "activations' device (see pack_bias)")


def _launch(h, wp, bp):
    """Run the CUDA kernel: layer 0 reads ``h`` in channels_last memory (a
    copy only if it is NCHW-contiguous), the layers alternate between two
    NHWC buffers, and the last one is handed back as an NCHW view
    (channels_last memory)."""
    from .build import load_library

    _check_cuda(h, wp, bp)
    lib = load_library()
    B, _, H, W = h.shape
    L = int(wp.shape[0])
    src = h.contiguous(memory_format=torch.channels_last)
    a = torch.empty((B, H, W, C), dtype=torch.bfloat16, device=h.device)
    t = torch.empty_like(a)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        rc = lib.deepinv_conv_chain_bf16(
            ctypes.c_void_p(src.data_ptr()), ctypes.c_void_p(a.data_ptr()),
            ctypes.c_void_p(t.data_ptr()), ctypes.c_void_p(wp.data_ptr()),
            ctypes.c_void_p(bp.data_ptr()), B, H, W, L, ctypes.c_void_p(stream))
    if rc != 0:
        msg = lib.deepinv_cuda_error_string(rc).decode()
        raise RuntimeError(f"conv_chain kernel launch failed: CUDA error {rc} ({msg})")
    conv_chain.launches += 1
    return (a if L % 2 else t).permute(0, 3, 1, 2)


class _ConvChain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, ws, bs, wp, bp):
        ctx.save_for_backward(h, ws, bs)
        if h.is_cuda:
            return _launch(h, wp, bp)
        return conv_chain_plain(h, ws, bs)

    @staticmethod
    def backward(ctx, g):
        h, ws, bs = ctx.saved_tensors
        with torch.enable_grad():
            args = [v.detach().float().requires_grad_() for v in (h, ws, bs)]
            out = _chain_rounded(*args)
            dh, dw, db = torch.autograd.grad(out, args, g.float())
        return dh.to(h.dtype), dw.to(ws.dtype), db.to(bs.dtype), None, None


def conv_chain(h, ws, bs, packed=None):
    """L layers of ``relu(conv3x3(h) + b)`` at C = 64, bf16 in and out.

    :param h: ``(B, 64, H, W)`` bf16 activations (B, H, W >= 1).
    :param ws: stacked OIHW weights ``(L, 64, 64, 3, 3)``.
    :param bs: stacked biases ``(L, 64)``.
    :param packed: ``(pack_weights(ws), pack_bias(bs))`` if the caller keeps
        them; packed here otherwise (CUDA only).
    :return: ``(B, 64, H, W)`` bf16. From the kernel it is an NCHW view of
        channels_last memory.
    """
    if packed is None:
        packed = (pack_weights(ws), pack_bias(bs)) if h.is_cuda else (None, None)
    return _ConvChain.apply(h, ws, bs, *packed)


conv_chain.launches = 0
