// DnCNN hidden chain: L layers of conv3x3 + bias + ReLU at 64 channels, bf16,
// for sm_90a.
//
// Replaces the Pallas TPU kernel `_chain_kernel`
// (deepinv_tpu/ops/pallas/conv_chain.py:112, launched by `_fused_fwd_impl`
// :289; its experiment-script copy scripts/bench_pallas_dncnn.py:99 computes
// the same at L = 18). It computes L layers of
//
//     h <- bf16(relu(conv3x3(h) + b))          C = 64, pad 1
//
// with f32 accumulation, the bias added in f32 and one bf16 rounding per layer
// (conv_chain.py:85-109). The TPU kernel fuses an even prefix and runs an odd
// last layer in XLA with the same rounding (:323-324); here any L >= 1 runs in
// the kernel.
//
// Layout. Activations are NHWC (channels last), as the TPU's pixel-pair folded
// (H, W/2, 128) tensor is in memory. Weights arrive pre-packed tap-major,
// [l][tap = ky*3 + kx][co][ci] in bf16; biases as (L, 64) f32.
//
// Design. The TPU kernel keeps two whole images in VMEM for the chain; an SM
// has 227 KB of shared memory, so the entry point deepinv_conv_chain_wgmma_bf16
// (the default) runs L launches of the wgmma + TMA conv tile of
// conv3x3_wgmma.cuh (one CTA an SM over a band of 128-pixel row-runs, the
// layer's weights resident, input rows streamed by TMA) with a bias+ReLU
// epilogue, chained by programmatic dependent launch. Layer 0 reads the
// caller's input; the layers then alternate between two NHWC buffers `a` and
// `t`, which at 1 x 64 x 256 x 256 (8 MB each) stay in the 50 MB L2. The
// earlier entry point deepinv_conv_chain_bf16 runs the same chain on the
// mma.sync tile of conv3x3.cuh (8 x 16 pixels a block), kept to time the two.
//
// What bounds it on an H100: as for resblock_chain.cu, ~300 FLOP per byte of
// activation traffic per layer, at the bf16 ridge, with the activations in L2:
// compute, 87 GFLOP at 1 x 64 x 256 x 256, L = 18: 0.088 ms at the bf16
// peak. The wgmma tile reads ~44 FLOP a byte from shared memory (the
// mma.sync tile ~21); what it leaves is a launch's fixed cost, a large part
// of a layer at B = 1.
//
// The training forward (second entry point). It replaces the Pallas TPU kernel
// `_chain_kernel_stash` (conv_chain.py:129, launched by `_fused_fwd_stash_impl`
// :328), the forward of the chain's custom_vjp: the same L layers, with every
// layer's output kept for the backward, which then needs no recompute (its
// ReLU masks and dW inputs are the stashed activations). The TPU keeps the
// ping-pong pair in VMEM and copies each layer's output out to an HBM stash
// by async DMA; here layer l simply writes its own slot acts[l] of an
// (L, B, H, W, 64) NHWC buffer and layer l + 1 reads it, so the stash costs no
// copy at all: the slots are the chain's buffers. Any L >= 1 runs in the
// kernel (the TPU stashes an even prefix and runs an odd last layer in XLA,
// :388-393) and the batch is a grid dimension (the JAX package maps the
// per-image kernel, :262-272). It still runs the mma.sync tile of
// conv3x3.cuh.
//
// What bounds it on an H100: the same operations as the inference chain
// (87 GFLOP at 1 x 64 x 256 x 256, L = 18: 0.088 ms at the bf16 peak), and
// L slots of 8.4 MB written per image instead of one output: 161 MB in all,
// 0.048 ms at 3.35 TB/s. Still operations. The slots no longer stay in L2
// (151 MB per image), so each layer's input comes from HBM; at ~300 FLOP per
// byte that costs little beside the tile's compute.

#include "conv3x3.cuh"
#include "conv3x3_wgmma.cuh"

extern "C" {

// Runs L layers from `src` (B, H, W, 64) bf16 (read only) through the scratch
// buffers `a` and `t` (same shape): layer l writes `a` for even l and `t` for
// odd l, so the result is in `a` for odd L and in `t` for even L.
// wp: (L, 9, 64, 64) bf16 packed [l][tap][co][ci]; bias: (L, 64) f32.
// Returns the first CUDA error of the launches (0 on success).
int deepinv_conv_chain_bf16(const void* src, void* a, void* t, const void* wp,
                            const void* bias, int B, int H, int W, int L, void* stream) {
  cudaError_t err = allow_smem<C, kBiasRelu>();
  if (err != cudaSuccess) return (int)err;

  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const __nv_bfloat16* in = static_cast<const __nv_bfloat16*>(src);
  __nv_bfloat16* bufs[2] = {static_cast<__nv_bfloat16*>(a), static_cast<__nv_bfloat16*>(t)};
  const __nv_bfloat16* pw = static_cast<const __nv_bfloat16*>(wp);
  const float* pb = static_cast<const float*>(bias);
  for (int l = 0; l < L; ++l) {
    __nv_bfloat16* out = bufs[l & 1];
    err = launch_conv3x3<C, kBiasRelu>(in, pw + (size_t)l * TAP_ELEMS, pb + (size_t)l * C, out,
                                       B, H, W, s);
    if (err != cudaSuccess) return (int)err;
    in = out;
  }
  return (int)cudaGetLastError();
}

// The same chain on the wgmma tile (conv3x3_wgmma.cuh), the default: L
// launches of conv3x3_wgmma over the same buffers. strip .. grid: the launch
// plan of conv_tile_plan (ops/kernels/conv_tile.py), checked against the tile.
int deepinv_conv_chain_wgmma_bf16(const void* src, void* a, void* t, const void* wp,
                                  const void* bias, int B, int H, int W, int L, int strip,
                                  int depth, int smem_bytes, int rows_per_cta, int grid,
                                  void* stream) {
  const wg::Plan plan{strip, depth, smem_bytes, rows_per_cta, grid};
  cudaError_t err = wg::check_plan(plan, B, H, W);
  CUtensorMap in[3], out[3], map_w;   // src, a, t (src has no output map)
  const void* bufs[2] = {a, t};
  if (err == cudaSuccess) err = wg::act_map_c(&in[0], src, C, B, H, W, wg::BOX_W);
  if (err == cudaSuccess)
    err = wg::act_maps(in + 1, out + 1, bufs, 2, C, B, H, W, wg::BOX_W, wg::NPIX);
  if (err == cudaSuccess) err = wg::matrix_map(&map_w, wp, C, (long long)L * 9 * C);
  if (err == cudaSuccess) err = wg::allow_smem<wg::kBiasRelu>();
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* pb = static_cast<const float*>(bias);
  for (int l = 0; l < L && err == cudaSuccess; ++l) {
    // layer l reads src (l = 0) or the buffer layer l - 1 wrote, and writes
    // a (even l) or t (odd l)
    const CUtensorMap& src_l = l == 0 ? in[0] : in[1 + ((l - 1) & 1)];
    err = wg::launch<wg::kBiasRelu>(src_l, out[1 + (l & 1)], map_w, l, pb + (size_t)l * C, H, W,
                                    plan, s);
  }
  return (int)err;
}

// Runs L layers from `src` (B, H, W, 64) bf16 (read only): layer l writes the
// slot acts + l * B*H*W*64 of the (L, B, H, W, 64) bf16 stash and layer l + 1
// reads it; the chain's output is the last slot.
// wp: (L, 9, 64, 64) bf16 packed [l][tap][co][ci]; bias: (L, 64) f32.
// Returns the first CUDA error of the launches (0 on success).
int deepinv_conv_chain_stash_bf16(const void* src, void* acts, const void* wp, const void* bias,
                                  int B, int H, int W, int L, void* stream) {
  cudaError_t err = allow_smem<C, kBiasRelu>();
  if (err != cudaSuccess) return (int)err;

  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const size_t slot = (size_t)B * H * W * C;
  const __nv_bfloat16* in = static_cast<const __nv_bfloat16*>(src);
  __nv_bfloat16* stash = static_cast<__nv_bfloat16*>(acts);
  const __nv_bfloat16* pw = static_cast<const __nv_bfloat16*>(wp);
  const float* pb = static_cast<const float*>(bias);
  for (int l = 0; l < L; ++l) {
    __nv_bfloat16* out = stash + (size_t)l * slot;
    err = launch_conv3x3<C, kBiasRelu>(in, pw + (size_t)l * TAP_ELEMS, pb + (size_t)l * C, out,
                                       B, H, W, s);
    if (err != cudaSuccess) return (int)err;
    in = out;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
