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
  JAX ``custom_vjp`` backward (resblock_chain.py:246-250), for the inputs
  that need one (``ctx.needs_input_grad``).

``resblock_chain.launches`` counts kernel launches (one per call that reaches
the kernel), so a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import contextlib
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


class _FirstOrderOnly(torch.autograd.Function):
    """The identity on a kernel op's first derivative, joined to the op's
    inputs and cotangent, whose own derivative raises."""

    @staticmethod
    def forward(ctx, name, n, *tensors):
        ctx.name = name
        return tuple(t.clone() for t in tensors[:n])

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError(
            f"the {ctx.name} kernel op has no second derivative (its backward is a kernel "
            "launch or a recompute on detached copies): differentiate twice inside "
            "fused_chains_disabled(), which takes the layers")


def first_order_only(name: str, results, inputs) -> tuple:
    """``results`` (a kernel op's backward, None where no gradient is asked)
    as they are outside grad mode; inside it (``create_graph``) joined to
    ``inputs`` through a node whose derivative raises, so that a second
    derivative through the op raises instead of silently dropping the terms
    of the inputs' dependence, which the backward does not record."""
    if not torch.is_grad_enabled():
        return tuple(results)
    inputs = [t for t in inputs if isinstance(t, torch.Tensor) and t.requires_grad]
    kept = [r for r in results if r is not None]
    if not inputs or not kept:
        return tuple(results)
    joined = iter(_FirstOrderOnly.apply(name, len(kept), *kept, *inputs))
    return tuple(None if r is None else next(joined) for r in results)


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


@contextlib.contextmanager
def _tf32_convs():
    """cuDNN convs may use TF32 inside the block (the stash backward's dW:
    TF32 holds bf16 values exactly, so nothing is rounded; K1's backward)."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class _ResblockChain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w1s, w2s, w1p, w2p):
        ctx.save_for_backward(h, w1s, w2s)
        if h.is_cuda:
            return _launch(h, w1p, w2p)
        return resblock_chain_plain(h, w1s, w2s)

    @staticmethod
    def backward(ctx, g):
        """Autodiff of the f32 chain, for the inputs that need a gradient
        only: a DPS step asks for dh alone, which skips the dW convs, a third
        of the backward's arithmetic. TF32 convs: the recompute's inputs and
        weights are bf16 values, which TF32 holds exactly; the hidden
        activations and the cotangent round to TF32's 10-bit mantissa. No
        second derivative (:func:`first_order_only`)."""
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad(), _tf32_convs():
            args = [v.detach().float().requires_grad_(n) for v, n in zip(saved, need)]
            out = resblocks_f32(*args)
            grads = iter(torch.autograd.grad(out, [a for a, n in zip(args, need) if n],
                                             g.detach().float()))
        results = [next(grads).to(v.dtype) if n else None for v, n in zip(saved, need)]
        return (*first_order_only("resblock_chain", results, (g, *saved)), None, None)


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
