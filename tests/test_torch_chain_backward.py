"""The DnCNN chain's training path on the wgmma tile: K6 through one tensor
map over its stash, and the stash backward's kernels (the head, the dX
chain with the ReLU mask and the bias gradient in the tile's ``kMaskDb``
epilogue, the fold).

The CUDA kernels run only on a GPU (``chip_smoke.py`` holds them to their
plain versions there). Here their arithmetic is emulated in numpy the way
the kernels cut the work: each CTA's band of 128-pixel row-runs
(``conv_tile_plan``), the mask row-run read with zeros past the image's
right edge (TMA's out-of-bounds fill), each CTA's sums of the values it
writes and their fold in CTA order; the head's runs of pixels. The
emulation is held to the JAX package's backward ``_bwd``
(deepinv_tpu/ops/pallas/conv_chain.py:405) on the interpret-mode Pallas
stash, and the emulated K6 to ``_lax_chain``. Also: the transposed weight
packing, the stash map's batch coordinates, the entry points' C
signatures against their ctypes declarations, and the CPU dispatch.
"""

import ctypes
import re
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepinv_tpu.ops.pallas.conv_chain import (_acts_to_nhwc, _bwd, _fused_fwd_stash_impl,
                                               _lax_chain)
from deepinv_tpu_torch.ops.kernels import build
from deepinv_tpu_torch.ops.kernels.conv_chain import (conv_chain_stash, pack_weights,
                                                      pack_weights_transposed, stash_backward)
from deepinv_tpu_torch.ops.kernels.conv_tile import H100_SMS, conv_tile_plan
from test_torch_conv_tile import _bf16, _rel, band_of

C = 64
CSRC = Path(__file__).resolve().parents[1] / "deepinv_tpu_torch" / "csrc"

# (B, H, W, SMs): one image of one strip in bands of one row, and a ragged
# shape of two strips (the second 24 of 128 columns inside the image) in
# bands of 3 rows with a last band of 2 (the interpret-mode Pallas stash
# takes an even H and W / 2)
SHAPES = [(1, 16, 16, H100_SMS), (1, 8, 152, 6)]


def tile_layer(src, in_b0, wpk, plan, B, out, out_b0, bias=None, aux=None, aux_b0=0):
    """One launch of ``conv3x3_wgmma`` as the tile computes it, over maps
    that may stack several tensors along the batch: image b reads batch
    coordinate b + in_b0 of ``src`` and writes b + out_b0 of ``out`` (NHWC,
    bf16 values, f32 sums). Per CTA band and row: the haloed ring rows (zero
    outside the image), D[co, n] = sum over taps of W[tap] @ ring[dy][n +
    dx]^T for the row-run's 128 pixels, then the epilogue and one bf16
    rounding. ``bias``: kBiasRelu. ``aux``: kMaskDb, the mask row-run read
    at b + aux_b0 with zeros past the right edge; the values kept where it is
    positive, and the CTA's sums of the rounded values over all 128 pixels
    returned as its row of the ``(grid, 64)`` partials. Neither: kRound. The
    store keeps the pixels inside the image."""
    _, H, W, _ = src.shape
    partials = np.zeros((plan.grid, C), np.float32)
    for cta in range(plan.grid):
        b, x0, y0, rows = band_of(plan, H, cta)
        assert b < B
        n = min(plan.strip, W - x0)
        for y in range(y0, y0 + rows):
            ring = np.zeros((3, plan.strip + 2, C), np.float32)
            for dy in range(3):
                yy = y + dy - 1
                if 0 <= yy < H:
                    lo, hi = max(x0 - 1, 0), min(x0 + plan.strip + 1, W)
                    ring[dy, lo - (x0 - 1):hi - (x0 - 1)] = src[b + in_b0, yy, lo:hi]
            d = np.zeros((C, plan.strip), np.float32)
            for tap in range(9):
                dy, dx = divmod(tap, 3)
                d += wpk[tap] @ ring[dy, dx:dx + plan.strip].T
            v = d.T
            if aux is not None:
                mask = np.zeros((plan.strip, C), np.float32)   # TMA fills zeros past W
                mask[:n] = aux[b + aux_b0, y, x0:x0 + n]
                v = _bf16(np.where(mask > 0, v, 0))
                partials[cta] += v.sum(0, dtype=np.float32)
            elif bias is not None:
                v = _bf16(np.maximum(v + bias, 0))
            else:
                v = _bf16(v)
            out[b + out_b0, y, x0:x0 + n] = v[:n]
    return partials


def head(g, act, grid):
    """``chain_bwd_head``: d = where(act > 0, g, 0) over (B, H, W, 64) NHWC
    bf16 values, and the sums of d of each CTA's contiguous run of pixels
    ``[N i / grid, N (i + 1) / grid)``."""
    d = np.where(act > 0, g, 0).astype(np.float32)
    flat = d.reshape(-1, C)
    N = flat.shape[0]
    partials = np.stack([flat[N * i // grid:N * (i + 1) // grid].sum(0, dtype=np.float32)
                         for i in range(grid)])
    return d, partials


def emulate_backward(h, ws, acts, g, plan):
    """The stash backward as the card's kernels run it (``_backward_kernels``):
    the head, dW[l] from the masked d_l (an f32 conv of bf16 values), the dX
    launch that writes d_{l-1} masked (kMaskDb, l >= 1) or dh (kRound), the
    fold of the partials in CTA order. h, g: NCHW; acts: (L, B, H, W, 64)."""
    L = ws.shape[0]
    B, _, H, W = h.shape
    wt = pack_weights_transposed(torch.from_numpy(ws)).float().numpy()
    stash = acts.reshape(L * B, H, W, C)   # the one map over the stash
    partials = np.zeros((L, plan.grid, C), np.float32)
    d, partials[L - 1] = head(_bf16(g.transpose(0, 2, 3, 1)), acts[L - 1], plan.grid)
    dws = [None] * L
    x0 = torch.from_numpy(_bf16(h))
    for l in range(L - 1, -1, -1):
        x_in = x0 if l == 0 else torch.from_numpy(acts[l - 1]).permute(0, 3, 1, 2)
        dws[l] = torch.nn.grad.conv2d_weight(x_in, (C, C, 3, 3),
                                             torch.from_numpy(d).permute(0, 3, 1, 2),
                                             padding=1).numpy()
        out = np.full((B, H, W, C), np.nan, np.float32)
        if l:
            partials[l - 1] = tile_layer(d, 0, wt[l], plan, B, out, 0, aux=stash,
                                         aux_b0=(l - 1) * B)
        else:
            tile_layer(d, 0, wt[0], plan, B, out, 0)
        assert not np.isnan(out).any()
        d = out
    db = np.zeros((L, C), np.float32)
    for i in range(plan.grid):   # the fold: CTA order
        db += partials[:, i]
    return d.transpose(0, 3, 1, 2), np.stack(dws), db


def _jax_stash_and_bwd(h, ws, bs, g):
    """The JAX package's stash (interpret-mode Pallas, per image) as
    ``(L, B, H, W, 64)`` NHWC bf16 values, and ``_bwd`` on it: dh, dW, db
    (summed over the images)."""
    B, _, H, W = h.shape
    acts, dh, dw, db = [], [], 0, 0
    for b in range(B):
        hj = jnp.asarray(h[b:b + 1], jnp.bfloat16)
        _, a = _fused_fwd_stash_impl(hj, jnp.asarray(ws), jnp.asarray(bs), True)
        acts.append(np.asarray(_acts_to_nhwc(a, H, W).astype(jnp.float32)))
        r = _bwd(True, (hj, jnp.asarray(ws), jnp.asarray(bs), a, None), jnp.asarray(g[b:b + 1]))
        dh.append(np.asarray(r[0], np.float32))
        dw, db = dw + np.asarray(r[1]), db + np.asarray(r[2])
    return np.stack(acts, 1), np.concatenate(dh), dw, db


@pytest.mark.parametrize("B,H,W,sms", SHAPES)
def test_emulated_backward_matches_jax_bwd(B, H, W, sms):
    """The kernels' backward (head, kMaskDb tiles with their per-CTA sums
    and the fold, the last layer on kRound) vs ``_bwd`` on the JAX stash
    (L = 4): dh within 1e-2 (rounded to bf16 after every layer), db and dW
    within 1e-3 (relative max error)."""
    rng = np.random.default_rng(B * 1000 + W)
    plan = conv_tile_plan(B, H, W, sms=sms)
    if W > 128:   # the ragged shape: two strips, bands of several rows, a short last band
        assert plan.strips == 2 and plan.rows_per_cta > 1 and H % plan.rows_per_cta
    L = 4
    h = _bf16(rng.standard_normal((B, C, H, W)))
    ws = (rng.standard_normal((L, C, C, 3, 3)) * 0.08).astype(np.float32)
    bs = (rng.standard_normal((L, C)) * 0.02).astype(np.float32)
    g = rng.standard_normal((B, C, H, W)).astype(np.float32)
    acts, dh_j, dw_j, db_j = _jax_stash_and_bwd(h, ws, bs, g)
    dh, dw, db = emulate_backward(h, ws, acts, g, plan)
    assert _rel(dh, dh_j) <= 1e-2
    assert _rel(db, db_j) <= 1e-3
    assert _rel(dw, dw_j) <= 1e-3


def test_pixels_past_the_edge_add_nothing():
    """At the ragged shape the conv's values past the image's right edge are
    not zero, yet the kMaskDb partials hold only the written pixels' sums:
    the mask read there is TMA's zero fill. With a mask of ones there, the
    sums would differ."""
    rng = np.random.default_rng(3)
    B, H, W = 1, 7, 150
    plan = conv_tile_plan(B, H, W, sms=6)
    d = _bf16(rng.standard_normal((B, H, W, C)))
    act = _bf16(np.maximum(rng.standard_normal((B, H, W, C)), 0))
    wt = pack_weights_transposed(torch.from_numpy(
        (rng.standard_normal((1, C, C, 3, 3)) * 0.08).astype(np.float32))).float().numpy()[0]
    out = np.zeros((B, H, W, C), np.float32)
    partials = tile_layer(d, 0, wt, plan, B, out, 0, aux=act)
    np.testing.assert_allclose(partials.sum(0), out.sum((0, 1, 2)), rtol=1e-5, atol=1e-3)
    wide = np.pad(d, ((0, 0), (0, 0), (0, 2 * 128 - W), (0, 0)))   # the conv past the edge
    ones = np.pad(act, ((0, 0), (0, 0), (0, 2 * 128 - W), (0, 0)), constant_values=1.0)
    out_wide = np.zeros_like(wide)
    leaky = tile_layer(wide, 0, wt, conv_tile_plan(B, H, 256, sms=6), B, out_wide, 0, aux=ones)
    assert np.abs(out_wide[:, :, W:]).max() > 0
    assert np.abs(leaky.sum(0) - partials.sum(0)).max() > 1e-2


@pytest.mark.parametrize("L", [1, 3])
def test_pack_weights_transposed_matches_bwd_flip(L):
    """``pack_weights_transposed`` is the :func:`pack_weights` layout of
    ``_bwd``'s transposed weights (conv_chain.py:447-448): HWIO, taps
    flipped, I and O swapped; exactly, in bf16."""
    rng = np.random.default_rng(L)
    ws = rng.standard_normal((L, C, C, 3, 3)).astype(np.float32)
    got = pack_weights_transposed(torch.from_numpy(ws))
    assert got.shape == (L, 9, C, C) and got.dtype == torch.bfloat16 and got.is_contiguous()
    for l in range(L):
        w_hwio = jnp.transpose(jnp.asarray(ws[l]), (2, 3, 1, 0)).astype(jnp.bfloat16)
        w_t = jnp.swapaxes(jnp.flip(w_hwio, (0, 1)), 2, 3)   # [ky][kx][I = co][O = ci]
        want = np.asarray(jnp.transpose(w_t, (0, 1, 3, 2)).astype(jnp.float32)).reshape(9, C, C)
        assert np.array_equal(got[l].float().numpy(), want)


def test_transposed_weights_give_the_input_gradient():
    """The tile's conv by the transposed packing is the conv's input
    gradient: the emulated kRound layer against autograd's dX in f32."""
    rng = np.random.default_rng(9)
    B, H, W = 1, 6, 20
    plan = conv_tile_plan(B, H, W, sms=4)
    w = (rng.standard_normal((1, C, C, 3, 3)) * 0.08).astype(np.float32)
    d = _bf16(rng.standard_normal((B, H, W, C)))
    out = np.zeros((B, H, W, C), np.float32)
    tile_layer(d, 0, pack_weights_transposed(torch.from_numpy(w)).float().numpy()[0], plan, B,
               out, 0)
    x = torch.zeros((B, C, H, W), requires_grad=True)
    torch.nn.functional.conv2d(x, torch.from_numpy(_bf16(w[0])), padding=1).backward(
        torch.from_numpy(d).permute(0, 3, 1, 2))
    assert _rel(out.transpose(0, 3, 1, 2), x.grad.numpy()) <= 1e-2


@pytest.mark.parametrize("B,H,W,sms", [(2, 7, 136, 8), (1, 16, 16, H100_SMS)])
def test_emulated_k6_through_one_stash_map(B, H, W, sms):
    """K6 on the tile through one map over the whole stash, (L * B, H, W,
    64): layer l reads batch offset (l - 1) * B (the caller's input for l =
    0) and writes l * B. Every slot of a 3-layer chain vs ``_lax_chain``'s
    per-layer outputs within 2e-2 (chip_smoke.py's KERNEL_RTOL)."""
    rng = np.random.default_rng(B * 7 + W)
    L = 3
    plan = conv_tile_plan(B, H, W, sms=sms)
    h = rng.standard_normal((B, C, H, W)).astype(np.float32)
    ws = (rng.standard_normal((L, C, C, 3, 3)) * (2 / 576) ** 0.5).astype(np.float32)
    bs = (rng.standard_normal((L, C)) * 0.02).astype(np.float32)
    x = _bf16(h.transpose(0, 2, 3, 1))
    wp = pack_weights(torch.from_numpy(ws)).float().numpy()
    stash = np.full((L * B, H, W, C), np.nan, np.float32)
    for l in range(L):
        src, in_b0 = (x, 0) if l == 0 else (stash, (l - 1) * B)
        tile_layer(src, in_b0, wp[l], plan, B, stash, l * B, bias=bs[l])
    assert not np.isnan(stash).any()
    for l in range(L):
        want = _lax_chain(jnp.asarray(h, jnp.bfloat16), jnp.asarray(ws[:l + 1]),
                          jnp.asarray(bs[:l + 1]))
        got = stash[l * B:(l + 1) * B].transpose(0, 3, 1, 2)
        assert _rel(got, np.asarray(want.astype(jnp.float32))) <= 2e-2, l


def test_plan_and_stash_coordinates_at_the_train_batch():
    """At the train step's B = 16, 256², L = 18: each tile launch covers
    every pixel once; the head's runs of pixels cover every pixel once; the
    stash map's batch coordinates l * B + b are written once each, layer l +
    1 reads what layer l wrote, and dX launch l reads the mask of slot l -
    1; every row of the (L, grid, 64) partials is written once (the head row
    L - 1, launch l row l - 1)."""
    B, H, W, L = 16, 256, 256, 18
    plan = conv_tile_plan(B, H, W)
    seen = np.zeros((B, H, W), np.int32)
    for cta in range(plan.grid):
        b, x0, y0, rows = band_of(plan, H, cta)
        seen[b, y0:y0 + rows, x0:min(x0 + plan.strip, W)] += 1
    assert (seen == 1).all() and plan.grid <= H100_SMS
    N = B * H * W
    runs = [(N * i // plan.grid, N * (i + 1) // plan.grid) for i in range(plan.grid)]
    assert runs[0][0] == 0 and runs[-1][1] == N
    assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
    written = np.zeros(L * B, np.int32)
    for l in range(L):
        writes = [l * B + b for b in range(B)]
        written[writes] += 1
        if l:
            assert [(l - 1) * B + b for b in range(B)] == [w - B for w in writes]
    assert (written == 1).all()
    rows = sorted([L - 1] + [l - 1 for l in range(1, L)])
    assert rows == list(range(L))


def test_backward_on_cpu_builds_nothing():
    """On CPU tensors ``stash_backward`` runs its plain version: no kernel
    launch is counted, nothing is built, and the kernels' route needs the
    card only there; a route it does not know raises."""
    rng = np.random.default_rng(0)
    L, shape = 2, (1, C, 8, 8)
    h = torch.from_numpy(_bf16(rng.standard_normal(shape))).to(torch.bfloat16)
    ws = torch.from_numpy((rng.standard_normal((L, C, C, 3, 3)) * 0.08).astype(np.float32))
    bs = torch.zeros((L, C))
    g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    acts = conv_chain_stash(h, ws, bs)
    before = stash_backward.launches
    dh, dw, db = stash_backward(h, ws, acts, g)
    assert stash_backward.launches == before
    assert build.load_library.cache_info().currsize == 0
    for a, b in zip((dh, dw, db), stash_backward(h, ws, acts, g, route="cudnn")):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="route"):
        stash_backward(h, ws, acts, g, route="fast")


def _c_entry_points():
    """Each ``extern "C"`` function of the sources: name -> its parameters'
    ctypes (a pointer for ``void*``, an int for ``int``, an int array for
    ``const int*``)."""
    found = {}
    for src in sorted(CSRC.glob("*.cu")):
        text = src.read_text()
        for name, params in re.findall(r"^(?:int|const char\*) (deepinv_\w+)\(([^)]*)\)", text,
                                       re.M):
            kinds = []
            for p in (q.strip() for q in params.split(",")):
                if p in ("", "void"):
                    continue
                if "int*" in p.replace(" ", ""):
                    kinds.append("plans")
                elif "*" in p:
                    kinds.append(ctypes.c_void_p)
                else:
                    assert p.split()[0] == "int", (name, p)
                    kinds.append(ctypes.c_int)
            found[name] = kinds
    return found


def test_ctypes_declarations_match_the_c_entry_points():
    """``build._declare`` gives every C entry point of ``csrc/*.cu`` exactly
    its parameters (ctypes passes an undeclared pointer as a 32-bit int);
    the new K6 and backward entry points are among them."""
    lib = SimpleNamespace()
    entries = _c_entry_points()
    for name in entries:
        setattr(lib, name, SimpleNamespace())
    build._declare(lib)
    plans = ctypes.POINTER(ctypes.c_int)
    for name, kinds in entries.items():
        want = [plans if k == "plans" else k for k in kinds]
        assert getattr(lib, name).argtypes == want, name
    assert {"deepinv_conv_chain_stash_wgmma_bf16", "deepinv_chain_bwd_head_bf16",
            "deepinv_chain_bwd_dx_wgmma_bf16", "deepinv_chain_bwd_fold_f32"} <= set(entries)
