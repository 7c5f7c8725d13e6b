// DRUNet scale-0 up path: the 2x2 stride-2 transposed conv Ci -> 64 and R
// residual blocks at 64 channels, bf16, for sm_90a.
//
// Replaces the two variants of one Pallas TPU function,
// `fused_up_resblock_chain_folded` (deepinv_tpu/ops/pallas/resblock_chain.py
// :302): `_up_resblock_kernel` :62 (launched by `_fused_up_fwd_impl` :319),
// which computes the projection as two per-H-phase matmuls in the kernel, and
// `_up_resblock_kernel2` :97 (`_fused_up_fwd_impl2` :350, the default), which
// takes the two phase planes from XLA dots and interleaves them in VMEM. Both
// compute
//
//     a = bf16(conv_transpose2x2(v))     f32 accumulation, one rounding
//     R x  a <- a + conv3x3(relu(conv3x3(a)))   (as resblock_chain.cu)
//
// The TPU variants differ only in where the H-interleave happens, a TPU
// layout question; here it is the address arithmetic of the projection's
// epilogue (proj2x2.cuh), so one kernel op stands for both.
//
// Layout. v is NHWC (B, H/2, W/2, Ci); the output is NHWC (B, H, W, 64),
// which is the memory of the TPU's W-folded (H, W/2, 128) tensor with lane
// pj*64 + co at pixel (2i + ph, 2j + pj). The transposed-conv weight arrives
// packed (4*64, Ci) bf16, row (ph*2 + pw)*64 + co; the chain weights as in
// resblock_chain.cu.
//
// Design. The default entry point, deepinv_up_resblock_chain_wgmma_bf16, runs
// the projection as one launch of the wgmma + TMA projection kernel
// (proj2x2_wgmma.cuh: a GEMM a row-run of 64 input pixels, whose epilogue
// scatters the two pw phases into one 128-pixel output row-run), then the
// chain as K1 runs it (wg::resblocks, conv3x3_wgmma.cuh: 2R launches of the
// 64-channel wgmma tile), all chained by programmatic dependent launch on the
// caller's stream. The chain is K1's: 64 channels on the 2x image; only the
// projection reads Ci channels. The earlier entry point,
// deepinv_up_resblock_chain_bf16, runs the same function on the mma.sync
// GEMM of proj2x2.cuh and the mma.sync tile of conv3x3.cuh; it stays so that
// the two can be timed side by side. What bounds it on an H100: at the bench
// shape (Ci = 128, 256²) the projection is 1.07 GFLOP over ~12 MB and the
// chain 38.7 GFLOP over 8 MB activations that stay in L2 at B = 1: the chain
// carries 97% of the operations and is compute-bound like K1.

#include "proj2x2.cuh"
#include "proj2x2_wgmma.cuh"

extern "C" {

// v: (B, H2, W2, Ci) bf16 NHWC, read only. a, t: (B, 2*H2, 2*W2, 64) bf16;
// the result is in `a`, `t` is scratch. wup: (256, Ci) bf16 packed; w1p/w2p:
// (R, 9, 64, 64) bf16 packed [r][tap][co][ci]. Ci a multiple of 16.
// Returns the first CUDA error of the launches (0 on success).
int deepinv_up_resblock_chain_bf16(const void* v, void* a, void* t, const void* wup,
                                   const void* w1p, const void* w2p, int B, int H2, int W2,
                                   int Ci, int R, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  __nv_bfloat16* pa = static_cast<__nv_bfloat16*>(a);
  cudaError_t err = launch_proj2x2<kUp>(static_cast<const __nv_bfloat16*>(v),
                                        static_cast<const __nv_bfloat16*>(wup), pa, B, H2, W2,
                                        Ci, C, s);
  if (err != cudaSuccess) return (int)err;
  err = resblocks<C>(pa, static_cast<__nv_bfloat16*>(t), static_cast<const __nv_bfloat16*>(w1p),
                     static_cast<const __nv_bfloat16*>(w2p), B, 2 * H2, 2 * W2, R, s);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// The same function on the wgmma + TMA kernels, the default. plans: the
// projection's launch plan (proj_plan: 6 ints) and the chain's
// (conv_tile_plan at the 2x image: 5 ints), checked against the kernels.
int deepinv_up_resblock_chain_wgmma_bf16(const void* v, void* a, void* t, const void* wup,
                                         const void* w1p, const void* w2p, int B, int H2,
                                         int W2, int Ci, int R, const int* plans,
                                         void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err = wgp::project<wgp::kUp>(v, wup, a, B, H2, W2, Ci, C, wgp::plan_at(plans), s);
  if (err == cudaSuccess)
    err = wg::resblocks<wg::Tile64>(a, t, w1p, w2p, B, 2 * H2, 2 * W2, R,
                                    wg::plan_at(plans + 6), s);
  return (int)err;
}

}  // extern "C"
