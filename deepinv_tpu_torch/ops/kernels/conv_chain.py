"""DnCNN conv3x3 + bias + ReLU chain at 64 channels (port of
deepinv_tpu/ops/pallas/conv_chain.py).

``conv_chain(h, ws, bs)`` runs L layers of ``h <- bf16(relu(conv3x3(h) + b))``
(C = 64, pad 1) with f32 accumulation, the bias added in f32 and one bf16
rounding per layer — the contract of ``fused_conv3x3_relu_chain``
(conv_chain.py:276, kernel ``_chain_kernel`` :112, per-layer math ``_layer``
:85-109, odd tail ``_lax_chain`` :175).

- On a CUDA tensor it launches the hand-written kernel
  ``deepinv_tpu_torch/csrc/conv_chain.cu`` on the wgmma + TMA conv tile of
  ``csrc/conv3x3_wgmma.cuh`` (the sources say what bounds it and how it is
  laid out), or raises: there is no fallback. Any L >= 1 runs in the
  kernel; the TPU kernel fuses an even prefix and runs an odd last layer in
  XLA (:323-324).
- On a CPU tensor it runs :func:`conv_chain_plain`, the plain PyTorch version
  with the kernel's rounding (``_lax_chain``'s arithmetic).
- The batch is native (a grid dimension of the kernel); the JAX package maps
  the per-image kernel with ``lax.map`` (conv_chain.py:262-272).
- When autograd needs the gradient of ``h``, ``ws`` or ``bs``, the forward
  is the training forward of the JAX ``custom_vjp`` (``_fwd`` :386): the
  stash op :func:`conv_chain_stash` (the hand-written kernel K6 on the wgmma
  tile on a CUDA tensor, :func:`conv_chain_stash_plain` on a CPU tensor)
  keeps every layer's output, and the backward :func:`stash_backward` mirrors
  ``_bwd`` (:405-457) over that stash with no recompute: on a CUDA tensor its
  dX chain runs on the wgmma tile with the ReLU mask and the bias gradient in
  the tile's epilogue (``csrc/conv_chain.cu``), dW on cuDNN. The chain has
  no forward-mode derivative, as the JAX ``custom_vjp`` has none: ``jvp``
  through it raises.

``fused_chains_disabled()`` is the counterpart of the JAX trace-time switch
(conv_chain.py:208-224): inside it every kernel gate of the port (DnCNN's
hidden chain, DRUNet's K1, K2/K3 and K4 stages) takes the layers instead.

``conv_chain.launches`` counts K5 launches and ``conv_chain_stash.launches``
K6 launches (one per call that reaches the kernel), and
``stash_backward.launches`` the backward's kernel launches (L + 2 a call: the
head, L dX layers, the fold), so a run can show that its main path went
through the kernels.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch
import torch.nn.functional as F

from .resblock_chain import (C, _tf32_convs, check_activations, first_order_only, pack_weights,
                             pack_weights_transposed, tile_args)

__all__ = ["conv_chain", "conv_chain_plain", "conv_chain_stash", "conv_chain_stash_plain",
           "stash_backward", "chain_f32", "pack_weights", "pack_weights_transposed", "pack_bias",
           "C", "fused_chains_disabled", "fused_disabled"]

_FUSED_DISABLED = False


@contextlib.contextmanager
def fused_chains_disabled():
    """Inside this context every kernel gate of the port returns False
    (conv_chain.py:211): DnCNN's hidden chain and DRUNet's stages run as
    layers. Nests, and restores the previous state on exit."""
    global _FUSED_DISABLED
    prev, _FUSED_DISABLED = _FUSED_DISABLED, True
    try:
        yield
    finally:
        _FUSED_DISABLED = prev


def fused_disabled() -> bool:
    """Whether :func:`fused_chains_disabled` is active (conv_chain.py:223)."""
    return _FUSED_DISABLED


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


def _plain_layers(h, ws, bs):
    """The chain's layers with the kernel's rounding, yielding each layer's
    bf16 output: f32 convs of bf16 values and bf16 weights, bias and ReLU in
    f32, one bf16 rounding per layer (``_lax_chain``'s arithmetic)."""
    a = h.to(torch.bfloat16)
    for l in range(ws.shape[0]):
        z = F.conv2d(a.float(), ws[l].to(torch.bfloat16).float(), bs[l].float(), padding=1)
        a = F.relu(z).to(torch.bfloat16)
        yield a


def conv_chain_plain(h, ws, bs):
    """Plain PyTorch version with the kernel's rounding (K5)."""
    for a in _plain_layers(h, ws, bs):
        pass
    return a


def conv_chain_stash_plain(h, ws, bs):
    """Plain PyTorch version of the stash (K6): :func:`conv_chain_plain`'s
    layers, each layer's bf16 output kept. Returns ``(L, B, H, W, 64)`` bf16
    NHWC, the slots of ``_fused_fwd_stash_impl``'s stash through
    ``_acts_to_nhwc`` (conv_chain.py:377)."""
    return torch.stack([a.permute(0, 2, 3, 1) for a in _plain_layers(h, ws, bs)])


def _check_cuda(h, wp, bp):
    check_activations(h, "conv_chain")
    L = wp.shape[0]
    if (L < 1 or wp.shape != (L, 9, C, C) or wp.dtype != torch.bfloat16
            or not wp.is_contiguous() or wp.device != h.device or wp.data_ptr() % 16):
        raise ValueError("packed weights must be contiguous, 16-byte aligned (L, 9, 64, 64) "
                         "bf16 with L >= 1 on the activations' device (see pack_weights)")
    if (bp.shape != (L, C) or bp.dtype != torch.float32 or not bp.is_contiguous()
            or bp.device != h.device):
        raise ValueError("packed biases must be contiguous (L, 64) float32 on the "
                         "activations' device (see pack_bias)")


def _run(entry: str, h, wp, bp, outs, plan=()):
    """Call the C entry point ``entry`` on ``h`` (channels_last memory, 16-byte
    aligned: a copy only if it is not), the output buffers ``outs``, the
    packed weights and the launch plan's ints ``plan``, on the current
    stream; raise on a CUDA error."""
    from .build import load_library

    lib = load_library()
    B, _, H, W = h.shape
    src = h.contiguous(memory_format=torch.channels_last)
    if src.data_ptr() % 16:   # TMA reads the input
        src = src.clone(memory_format=torch.channels_last)
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (src, *outs, wp, bp)]
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        rc = getattr(lib, entry)(*ptrs, B, H, W, int(wp.shape[0]), *plan,
                                 ctypes.c_void_p(stream))
    if rc != 0:
        msg = lib.deepinv_cuda_error_string(rc).decode()
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc} ({msg})")


def _launch(h, wp, bp, tile: str = "wgmma"):
    """Run the K5 CUDA kernel: the layers alternate between two NHWC buffers,
    and the last one is handed back as an NCHW view (channels_last memory).
    ``tile`` is private (``resblock_chain.tile_args``): ``"mma"`` runs the
    earlier tile, to time the two side by side."""
    _check_cuda(h, wp, bp)
    suffix, plan = tile_args(h, tile)
    B, _, H, W = h.shape
    a = torch.empty((B, H, W, C), dtype=torch.bfloat16, device=h.device)
    t = torch.empty_like(a)
    _run(f"deepinv_conv_chain{suffix}_bf16", h, wp, bp, (a, t), plan)
    conv_chain.launches += 1
    return (a if wp.shape[0] % 2 else t).permute(0, 3, 1, 2)


def _launch_stash(h, wp, bp, tile: str = "wgmma"):
    """Run the K6 CUDA kernel: layer l writes slot l of a fresh
    ``(L, B, H, W, 64)`` bf16 stash. ``tile`` is private, as for
    :func:`_launch`."""
    _check_cuda(h, wp, bp)
    suffix, plan = tile_args(h, tile)
    B, _, H, W = h.shape
    acts = torch.empty((wp.shape[0], B, H, W, C), dtype=torch.bfloat16, device=h.device)
    _run(f"deepinv_conv_chain_stash{suffix}_bf16", h, wp, bp, (acts,), plan)
    conv_chain_stash.launches += 1
    return acts


def conv_chain_stash(h, ws, bs, packed=None):
    """The chain's training forward (``_fused_fwd_stash_impl``,
    conv_chain.py:328): every layer's bf16 output, as ``(L, B, H, W, 64)``
    NHWC; the chain's output is the last slot. On a CUDA tensor it launches
    the hand-written kernel K6 (``csrc/conv_chain.cu``, on the wgmma tile)
    or raises; on a CPU
    tensor it runs :func:`conv_chain_stash_plain`. Not differentiable itself:
    :func:`conv_chain` calls it under autograd.

    :param packed: ``(pack_weights(ws), pack_bias(bs))`` if the caller keeps
        them; packed here otherwise (CUDA only).
    """
    if not h.is_cuda:
        return conv_chain_stash_plain(h, ws, bs)
    wp, bp = packed if packed is not None else (pack_weights(ws), pack_bias(bs))
    return _launch_stash(h, wp, bp)


def _wgrad(x_in, d, shape, bf16_dw: bool, plain: bool):
    """dW of one layer from its input and its masked cotangent (NCHW views):
    a bf16 cuDNN wgrad (f32 accumulation, one rounding) for bf16 weights on
    the card; otherwise a conv of the bf16 values in f32, with TF32 allowed
    on the card (exact for bf16 values, f32 sums)."""
    if bf16_dw:
        return torch.nn.grad.conv2d_weight(x_in, shape, d, padding=1)
    with contextlib.nullcontext() if plain else _tf32_convs():
        return torch.nn.grad.conv2d_weight(x_in.float(), shape, d.float(), padding=1)


def _nchw(a):
    """An NHWC tensor as an NCHW view (channels_last memory)."""
    return a.permute(0, 3, 1, 2)


def stash_backward(h, ws, acts, g, plain=None, route: str = "kernels"):
    """Backward of the chain from its stash, with no forward recompute
    (``_bwd``, conv_chain.py:405-457). For l from L-1 down to 0:

    - ``d <- d * (acts[l] > 0)``, the mask of the stashed, rounded output;
    - ``db[l] = sum d`` in f32;
    - ``dW[l] = conv(x_in, d)`` with the batch as the contraction, f32
      accumulation and an f32 result, ``x_in`` being ``h`` for l = 0 and
      ``acts[l-1]`` otherwise; ``_bwd`` returns it in the weights' dtype
      (:457), so bf16 weights (as under autocast) get it rounded once to bf16;
    - ``d <- bf16(conv(d, flip(W[l]) with I/O swapped))``: the transposed
      conv of ``d`` by the bf16 weights, f32 accumulation, one rounding.

    ``d`` starts as ``bf16(g)``. On the card (the default route,
    ``"kernels"``) the hand-written kernels of ``csrc/conv_chain.cu`` run it:
    a head kernel masks ``bf16(g)`` by the last slot; then L dX convs on the
    wgmma tile with the weights packed by :func:`pack_weights_transposed`,
    each but the last (l = 0, which writes dh) writing the next layer's
    ``d`` already masked and adding it into per-CTA sums; a fold adds the
    sums into db in a fixed order (the same bits from run to run). dW stays
    a cuDNN wgrad of the masked ``d`` the tile wrote: bf16 for bf16 weights
    (f32 accumulation, one rounding), for f32 weights a conv of the bf16
    values in f32 with TF32 allowed (exact for bf16 values, f32 sums). The
    plain version (the CPU's, or ``plain=True``) does dX and dW as f32 convs
    of the bf16 values under the caller's precision settings, dW in f32. The
    two differ only in the order of the f32 sums and, for bf16 weights, dW's
    final rounding, which the caller's cast to the weights' dtype makes
    anyway.

    :param h: ``(B, 64, H, W)`` chain input; ``ws``: ``(L, 64, 64, 3, 3)``;
        ``acts``: ``(L, B, H, W, 64)`` bf16 stash; ``g``: ``(B, 64, H, W)``
        cotangent of the output.
    :param plain: run the plain version; by default, on CPU tensors only.
    :param route: private: ``"cudnn"`` runs the card's earlier route (cuDNN
        bf16 dgrad, a mask pass and a sum), kept to time the two in turns.
    :return: ``(dh, dW, db)``: ``(B, 64, H, W)`` bf16 (channels_last memory),
        ``(L, 64, 64, 3, 3)`` (float32, or bf16 on the card for bf16 weights)
        and ``(L, 64)`` float32.
    """
    if route not in ("kernels", "cudnn"):
        raise ValueError(f"route must be 'kernels' or 'cudnn', got {route!r}")
    L = ws.shape[0]
    plain = not g.is_cuda if plain is None else plain
    bf16_dw = not plain and ws.dtype == torch.bfloat16
    if not plain and route == "kernels":
        return _backward_kernels(h, ws, acts, g, bf16_dw)
    wb = ws.detach().to(torch.bfloat16)
    d = g.to(torch.bfloat16)
    dws, dbs = [None] * L, [None] * L
    for l in range(L - 1, -1, -1):
        # ReLU's backward from its (stashed) output: d where acts[l] > 0
        d = torch.ops.aten.threshold_backward(d, _nchw(acts[l]), 0)
        dbs[l] = d.sum((0, 2, 3), dtype=torch.float32)
        x_in = h.to(torch.bfloat16) if l == 0 else _nchw(acts[l - 1])
        dws[l] = _wgrad(x_in, d, wb[l].shape, bf16_dw, plain)
        if plain:
            d = F.conv_transpose2d(d.float(), wb[l].float(), padding=1).to(torch.bfloat16)
        else:
            d = F.conv_transpose2d(d, wb[l], padding=1)
    return d, torch.stack(dws), torch.stack(dbs)


def _backward_kernels(h, ws, acts, g, bf16_dw: bool):
    """:func:`stash_backward` on the card's kernels: the head, L dX layers on
    the wgmma tile (a cuDNN wgrad before each) and the fold, each counted in
    ``stash_backward.launches``; raises on what the kernels do not take."""
    from .build import load_library

    L = ws.shape[0]
    B, _, H, W = h.shape
    if tuple(h.shape) != (B, C, H, W) or tuple(g.shape) != (B, C, H, W) or g.device != h.device:
        raise ValueError(f"stash_backward takes a cotangent of shape {(B, C, H, W)} on the "
                         f"input's device, got {tuple(g.shape)} on {g.device}")
    if tuple(ws.shape) != (L, C, C, 3, 3) or ws.device != h.device:
        raise ValueError(f"stash_backward takes (L, {C}, {C}, 3, 3) weights on the input's "
                         f"device, got {tuple(ws.shape)} on {ws.device}")
    if (tuple(acts.shape) != (L, B, H, W, C) or acts.dtype != torch.bfloat16
            or not acts.is_contiguous() or acts.device != h.device or acts.data_ptr() % 16):
        raise ValueError(f"stash_backward takes a contiguous, 16-byte aligned {(L, B, H, W, C)} "
                         "bf16 stash on the input's device (see conv_chain_stash)")
    wt = pack_weights_transposed(ws)
    _, plan = tile_args(h, "wgmma")
    grid = plan[-1]
    dev = h.device
    # the cotangent as bf16 NHWC (channels_last memory): one copy only if it is not
    gd = g
    if (g.dtype != torch.bfloat16 or not g.is_contiguous(memory_format=torch.channels_last)
            or g.data_ptr() % 16):
        gd = torch.empty((B, C, H, W), dtype=torch.bfloat16, device=dev,
                         memory_format=torch.channels_last).copy_(g)
    d = torch.empty((2, B, H, W, C), dtype=torch.bfloat16, device=dev)   # d_l in d[l % 2]
    dh = torch.empty((B, H, W, C), dtype=torch.bfloat16, device=dev)
    partials = torch.empty((L, grid, C), dtype=torch.float32, device=dev)
    db = torch.empty((L, C), dtype=torch.float32, device=dev)
    lib = load_library()
    ptr = ctypes.c_void_p

    def call(entry, *args):
        rc = getattr(lib, entry)(*args, ptr(stream))
        if rc != 0:
            msg = lib.deepinv_cuda_error_string(rc).decode()
            raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc} ({msg})")
        stash_backward.launches += 1

    dws = [None] * L
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        call("deepinv_chain_bwd_head_bf16", ptr(gd.data_ptr()), ptr(acts[L - 1].data_ptr()),
             ptr(d[(L - 1) % 2].data_ptr()), ptr(partials[L - 1].data_ptr()), B, H, W, grid)
        for l in range(L - 1, -1, -1):
            x_in = h.to(torch.bfloat16) if l == 0 else _nchw(acts[l - 1])
            dws[l] = _wgrad(x_in, _nchw(d[l % 2]), ws[l].shape, bf16_dw, False)
            out = dh if l == 0 else d[(l - 1) % 2]
            call("deepinv_chain_bwd_dx_wgmma_bf16", ptr(d[l % 2].data_ptr()),
                 ptr(out.data_ptr()), ptr(acts.data_ptr()), ptr(wt.data_ptr()),
                 ptr(partials.data_ptr()), B, H, W, L, l, *plan)
        call("deepinv_chain_bwd_fold_f32", ptr(partials.data_ptr()), ptr(db.data_ptr()), L, grid)
    return _nchw(dh), torch.stack(dws), db


class _ConvChain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, ws, bs, wp, bp, stash):
        if not stash:
            return _launch(h, wp, bp) if h.is_cuda else conv_chain_plain(h, ws, bs)
        acts = conv_chain_stash(h, ws, bs, (wp, bp) if h.is_cuda else None)
        ctx.save_for_backward(h, ws, bs, acts)
        # a fresh tensor: a view of the saved stash would trip autograd's
        # version check after an in-place op of the caller
        return acts[-1].permute(0, 3, 1, 2).clone()

    @staticmethod
    def backward(ctx, g):
        """The stash backward; no second derivative (:func:`first_order_only`:
        the kernels' results carry no graph, and the plain version's detach
        the weights)."""
        h, ws, bs, acts = ctx.saved_tensors
        with torch.no_grad():
            dh, dw, db = stash_backward(h, ws, acts, g)
        results = (dh.to(h.dtype), dw.to(ws.dtype), db.to(bs.dtype))
        return (*first_order_only("conv_chain", results, (g, h, ws, bs)), None, None, None)

    @staticmethod
    def jvp(ctx, *tangents):
        raise RuntimeError(
            "the DnCNN conv-chain kernel op has no forward-mode derivative (like the JAX "
            "custom_vjp it ports): run forward-mode AD, e.g. SureGaussianLoss, inside "
            "fused_chains_disabled(), as Trainer(fused_chains=False) does")


def conv_chain(h, ws, bs, packed=None):
    """L layers of ``relu(conv3x3(h) + b)`` at C = 64, bf16 in and out.

    :param h: ``(B, 64, H, W)`` bf16 activations (B, H, W >= 1).
    :param ws: stacked OIHW weights ``(L, 64, 64, 3, 3)``.
    :param bs: stacked biases ``(L, 64)``.
    :param packed: ``(pack_weights(ws), pack_bias(bs))`` if the caller keeps
        them; packed here otherwise (CUDA only).
    :return: ``(B, 64, H, W)`` bf16. From the kernel it is an NCHW view of
        channels_last memory. Under autograd (a gradient of ``h``, ``ws`` or
        ``bs`` is needed) the forward runs the stash op (K6 on the card) and
        the backward :func:`stash_backward`; otherwise K5 runs.
    """
    stash = torch.is_grad_enabled() and any(t.requires_grad for t in (h, ws, bs))
    if packed is None:
        packed = (pack_weights(ws), pack_bias(bs)) if h.is_cuda else (None, None)
    return _ConvChain.apply(h, ws, bs, *packed, stash)


conv_chain.launches = 0
conv_chain_stash.launches = 0
stash_backward.launches = 0
