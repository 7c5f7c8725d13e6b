// DRUNet's whole up tail below scale 2 (the "sandwich"), bf16, for sm_90a.
//
// Replaces the Pallas TPU kernel `_sandwich_kernel`
// (deepinv_tpu/ops/pallas/resblock_chain.py:442, launched by
// `_sandwich_fwd_impl` :601). From the scale-2 input s2 (the skip add v + x3
// already applied) and the scale-0 down-chain output d0 it computes, with f32
// accumulation and the kernel's roundings:
//
//   1. a1 = bf16(conv_transpose2x2(s2))                    up2, Ci2 -> 128
//   2. R1 x  a1 <- a1 + conv3x3(relu(conv3x3(a1)))       at C = 128
//   3. a1 = bf16(a1 + conv2x2_stride2(d0))                the skip x2, recomputed
//      from d0; the f32 sum is rounded once (x2 is never rounded on its own)
//   4. a0 = bf16(conv_transpose2x2(a1))                    up1, 128 -> 64
//   5. R0 x  a0 <- a0 + conv3x3(relu(conv3x3(a0)))       at C = 64 (K1's tile)
//
// Layout. Everything is NHWC: s2 (B, H/4, W/4, Ci2), d0 and the output (B, H,
// W, 64) (the TPU's W-folded scale-0 tensor in memory), the scale-1 buffers
// (B, H/2, W/2, 128). Weights arrive packed: up2 (512, Ci2) and up1 (256, 128)
// as in up_resblock_chain.cu, the down-projection (128, 256) with k = dh*128 +
// dw*64 + ci, the chains R layers each in the conv tile's layout (conv3x3.cuh:
// [co / 64][tap][co % 64][ci]).
//
// Design. The TPU kernel keeps the scale-1 and scale-0 ping-pong buffers in
// VMEM (~110 MB budget); an SM has 227 KB, so here one C entry point issues
// the 3 projections and the 2(R1 + R0) conv launches in order on the caller's
// stream. The default, deepinv_up_sandwich_wgmma_bf16, runs every stage on
// wgmma fed by TMA, chained by programmatic dependent launch: the projections
// on proj2x2_wgmma.cuh (the skip's strided conv reads d0 as (B, H, W/2, 128)
// rows, in the packed weight's column order, and adds into a1 in place), the
// scale-1 chain on the 128-channel cluster tile of conv3x3_c128_wgmma.cuh
// (one layer's 288 KB of weights exceed an SM, so two CTAs of a cluster
// split the output channels, each with its half resident, and share each
// input row by TMA multicast), and the scale-0 chain on K1's 64-channel tile
// (wg::resblocks). The earlier entry point, deepinv_up_sandwich_bf16, runs
// the same function on the mma.sync kernels (proj2x2.cuh, conv3x3.cuh, whose
// 128-channel tile splits the output channels over two blocks) and stays so
// that the two can be timed side by side. What bounds it on an H100: 80.5
// GFLOP at the bench size, 97% of it in the two chains; at B = 1 every
// intermediate (scale 1: 4 MB, scale 0: 8 MB) stays in the 50 MB L2, so it
// is compute-bound; at B = 8 (a1, t1 33.5 MB; d0, a0, t0 67 MB) each layer
// also reads and writes its activations in device memory.

#include "conv3x3_c128_wgmma.cuh"
#include "proj2x2.cuh"
#include "proj2x2_wgmma.cuh"

extern "C" {

// s2: (B, H2, W2, Ci2) and d0: (B, 4*H2, 4*W2, 64), bf16 NHWC, read only.
// a1, t1: (B, 2*H2, 2*W2, 128) scratch; a0, t0: (B, 4*H2, 4*W2, 64), the
// result in `a0`. wup2: (512, Ci2); w1s1/w2s1: (R1, 18, 64, 128); wd: (128,
// 256); wup1: (256, 128); w1s/w2s: (R0, 9, 64, 64); all bf16 packed. Ci2 a
// multiple of 16. Returns the first CUDA error of the launches (0 on success).
int deepinv_up_sandwich_bf16(const void* s2, const void* d0, void* a1, void* t1, void* a0,
                             void* t0, const void* wup2, const void* w1s1, const void* w2s1,
                             const void* wd, const void* wup1, const void* w1s, const void* w2s,
                             int B, int H2, int W2, int Ci2, int R1, int R0, void* stream) {
  using bf = __nv_bfloat16;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  bf* pa1 = static_cast<bf*>(a1);
  bf* pa0 = static_cast<bf*>(a0);
  const int H1 = 2 * H2, W1 = 2 * W2;
  cudaError_t err = launch_proj2x2<kUp>(static_cast<const bf*>(s2),
                                        static_cast<const bf*>(wup2), pa1, B, H2, W2, Ci2,
                                        2 * C, s);
  if (err != cudaSuccess) return (int)err;
  err = resblocks<2 * C>(pa1, static_cast<bf*>(t1), static_cast<const bf*>(w1s1),
                         static_cast<const bf*>(w2s1), B, H1, W1, R1, s);
  if (err != cudaSuccess) return (int)err;
  err = launch_proj2x2<kDownAdd>(static_cast<const bf*>(d0), static_cast<const bf*>(wd), pa1,
                                 B, H1, W1, 4 * C, 2 * C, s);
  if (err != cudaSuccess) return (int)err;
  err = launch_proj2x2<kUp>(pa1, static_cast<const bf*>(wup1), pa0, B, H1, W1, 2 * C, C, s);
  if (err != cudaSuccess) return (int)err;
  err = resblocks<C>(pa0, static_cast<bf*>(t0), static_cast<const bf*>(w1s),
                     static_cast<const bf*>(w2s), B, 2 * H1, 2 * W1, R0, s);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// The same function on the wgmma + TMA kernels, the default. plans: the
// launch plans in launch order, checked against the kernels: up2 (proj_plan,
// 6 ints), the scale-1 chain (conv128_tile_plan, 5), the skip (proj_plan, 6),
// up1 (proj_plan, 6), the scale-0 chain (conv_tile_plan, 5).
int deepinv_up_sandwich_wgmma_bf16(const void* s2, const void* d0, void* a1, void* t1, void* a0,
                                   void* t0, const void* wup2, const void* w1s1,
                                   const void* w2s1, const void* wd, const void* wup1,
                                   const void* w1s, const void* w2s, int B, int H2, int W2,
                                   int Ci2, int R1, int R0, const int* plans, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int H1 = 2 * H2, W1 = 2 * W2;
  cudaError_t err =
      wgp::project<wgp::kUp>(s2, wup2, a1, B, H2, W2, Ci2, 2 * C, wgp::plan_at(plans), s);
  if (err == cudaSuccess)
    err = wg::resblocks<wg128::Tile>(a1, t1, w1s1, w2s1, B, H1, W1, R1,
                                     wg::plan_at(plans + 6), s);
  if (err == cudaSuccess)
    err = wgp::project<wgp::kDownAdd>(d0, wd, a1, B, H1, W1, 4 * C, 2 * C,
                                      wgp::plan_at(plans + 11), s);
  if (err == cudaSuccess)
    err = wgp::project<wgp::kUp>(a1, wup1, a0, B, H1, W1, 2 * C, C, wgp::plan_at(plans + 17), s);
  if (err == cudaSuccess)
    err = wg::resblocks<wg::Tile64>(a0, t0, w1s, w2s, B, 2 * H1, 2 * W1, R0,
                                    wg::plan_at(plans + 23), s);
  return (int)err;
}

// The scale-1 chain alone (R blocks in place on `a` (B, H, W, 128) with `t`
// as scratch; w1p/w2p (R, 18, 64, 128)) on the 128-channel cluster tile, for
// checking that tile on its own. plan: conv128_tile_plan (5 ints).
int deepinv_resblock_chain_c128_wgmma_bf16(void* a, void* t, const void* w1p, const void* w2p,
                                           int B, int H, int W, int R, const int* plan,
                                           void* stream) {
  return (int)wg::resblocks<wg128::Tile>(a, t, w1p, w2p, B, H, W, R, wg::plan_at(plan),
                               reinterpret_cast<cudaStream_t>(stream));
}

// How many clusters of the 128-channel tile the device holds at once, or a
// negative CUDA error.
int deepinv_conv_c128_max_clusters(void) {
  int count = 0;
  const cudaError_t err = wg128::max_clusters(&count);
  return err != cudaSuccess ? -(int)err : count;
}

}  // extern "C"
