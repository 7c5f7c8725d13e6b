// DRUNet scale-0 residual-block chain at 64 channels, bf16, for sm_90a.
//
// Replaces the Pallas TPU kernel `_resblock_kernel`
// (deepinv_tpu/ops/pallas/resblock_chain.py:43, launched by `_fused_fwd_impl`
// :212). It computes R blocks of
//
//     h <- h + conv3x3(relu(conv3x3(h)))       C = 64, pad 1, no bias
//
// with bf16 activations and f32 accumulation, one bf16 rounding per conv:
// conv1 rounds after its ReLU; conv2 adds the (bf16) residual to its f32
// accumulator and rounds once (deepinv_tpu/ops/pallas/conv_chain.py:85-109).
//
// Layout. Activations are NHWC (channels last): this is exactly the memory of
// the TPU's W-folded (1, H, W/2, 128) tensor, lane q*64 + c. Weights arrive
// pre-packed tap-major, [r][tap = ky*3 + kx][co][ci] in bf16.
//
// Design. The entry point deepinv_resblock_chain_wgmma_bf16 (the default)
// runs 2R launches of the wgmma + TMA conv tile (conv3x3_wgmma.cuh, which
// says how a tile is computed) over two ping-pong buffers: `a` holds h (and
// receives each block's output in place), `t` holds relu(conv1(h)). Writing
// conv2's output into `a` in place is safe: within one launch `a` is read
// only as the residual of the row-runs a CTA writes, before it writes them;
// the conv input is `t`. The layers chain by programmatic dependent launch: a
// layer's CTAs load their weights while the previous layer finishes. The
// loop is wg::resblocks, which K2/K3 and K4 run too. The earlier entry
// point deepinv_resblock_chain_bf16 runs the same chain on the mma.sync tile
// of conv3x3.cuh; it stays so that the two tiles can be timed side by side.
//
// What bounds it on an H100. One conv at 1 x 64 x 256 x 256 is
// 2 * 256^2 * 64 * 64 * 9 = 4.8 GFLOP over ~16 MB of activation traffic
// (~300 FLOP/B), at the card's bf16 ridge; the 8 MB activation fits in the
// 50 MB L2, so the chain is compute-bound: 39 us for R = 4 at the bf16
// peak. The wgmma tile feeds the tensor cores from shared memory at ~44
// FLOP a byte (the mma.sync tile ~21) and loads the weights once a CTA. At
// B = 1 a launch has 4 output rows a CTA, so its fixed cost (the weights and
// the first ring rows before the first product, the last epilogue after the
// last) is a large part of it; at B = 8 (32 rows a CTA) the products are.

#include "conv3x3.cuh"
#include "conv3x3_wgmma.cuh"

extern "C" {

// Runs R residual blocks in place on `a` (B, H, W, 64) bf16, using `t` (same
// shape) as scratch. w1p/w2p: (R, 9, 64, 64) bf16 packed [r][tap][co][ci].
// Returns the first CUDA error of the launches (0 on success).
int deepinv_resblock_chain_bf16(void* a, void* t, const void* w1p, const void* w2p,
                                int B, int H, int W, int R, void* stream) {
  cudaError_t err = resblocks<C>(
      static_cast<__nv_bfloat16*>(a), static_cast<__nv_bfloat16*>(t),
      static_cast<const __nv_bfloat16*>(w1p), static_cast<const __nv_bfloat16*>(w2p), B, H, W,
      R, reinterpret_cast<cudaStream_t>(stream));
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// The same chain on the wgmma tile (conv3x3_wgmma.cuh), the default: 2R
// launches of conv3x3_wgmma, conv1 reading `a` into `t`, conv2 reading `t`
// and adding into `a` in place. strip .. grid: the launch plan of
// conv_tile_plan (ops/kernels/conv_tile.py), checked against the tile.
int deepinv_resblock_chain_wgmma_bf16(void* a, void* t, const void* w1p, const void* w2p,
                                      int B, int H, int W, int R, int strip, int depth,
                                      int smem_bytes, int rows_per_cta, int grid, void* stream) {
  const wg::Plan plan{strip, depth, smem_bytes, rows_per_cta, grid};
  return (int)wg::resblocks<wg::Tile64>(a, t, w1p, w2p, B, H, W, R, plan,
                            reinterpret_cast<cudaStream_t>(stream));
}

const char* deepinv_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
