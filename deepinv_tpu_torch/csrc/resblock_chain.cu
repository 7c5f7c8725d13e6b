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
// Design. One C entry point runs 2R launches of one direct-conv kernel
// (conv3x3_c64.cuh, which says how a tile is computed) over two ping-pong
// buffers: `a` holds h (and receives each block's output in place), `t` holds
// relu(conv1(h)). Writing conv2's output into `a` in place is safe: within one
// launch `a` is read only at the pixel each thread writes (the residual); the
// conv input is `t`.
//
// What bounds it on an H100. One conv at 1 x 64 x 256 x 256 is
// 2 * 256^2 * 64 * 64 * 9 = 4.8 GFLOP over ~16 MB of activation traffic
// (~300 FLOP/B), at the card's bf16 ridge; the 8 MB activation fits in the
// 50 MB L2, so the chain should be compute-bound. This first version uses
// mma.sync from shared memory, not wgmma/TMA, re-reads the weights per tile
// (L2-resident) and keeps two blocks of 4 warps per SM, so it will sit well
// below the tensor-core peak; wgmma, TMA, clusters and one persistent launch
// for the whole chain are later work.

#include "conv3x3_c64.cuh"

extern "C" {

// Runs R residual blocks in place on `a` (B, H, W, 64) bf16, using `t` (same
// shape) as scratch. w1p/w2p: (R, 9, 64, 64) bf16 packed [r][tap][co][ci].
// Returns the first CUDA error of the launches (0 on success).
int deepinv_resblock_chain_bf16(void* a, void* t, const void* w1p, const void* w2p,
                                int B, int H, int W, int R, void* stream) {
  cudaError_t err = allow_smem<kRelu>();
  if (err != cudaSuccess) return (int)err;
  err = allow_smem<kResidual>();
  if (err != cudaSuccess) return (int)err;

  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  __nv_bfloat16* pa = static_cast<__nv_bfloat16*>(a);
  __nv_bfloat16* pt = static_cast<__nv_bfloat16*>(t);
  const __nv_bfloat16* p1 = static_cast<const __nv_bfloat16*>(w1p);
  const __nv_bfloat16* p2 = static_cast<const __nv_bfloat16*>(w2p);
  for (int r = 0; r < R; ++r) {
    conv3x3_c64<kRelu><<<grid, NTHREADS, SMEM_BYTES, s>>>(
        pa, p1 + (size_t)r * TAP_ELEMS, nullptr, pt, H, W);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    conv3x3_c64<kResidual><<<grid, NTHREADS, SMEM_BYTES, s>>>(
        pt, p2 + (size_t)r * TAP_ELEMS, nullptr, pa, H, W);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

const char* deepinv_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
