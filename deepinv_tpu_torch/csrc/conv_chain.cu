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
// has 227 KB of shared memory, so one C entry point runs L launches of the
// tiled direct conv of conv3x3.cuh (8 x 16 pixels x 64 channels per block,
// mma.sync m16n8k16) with a bias+ReLU epilogue. Layer 0 reads the caller's
// input; the layers then alternate between two NHWC buffers `a` and `t`, which
// at 1 x 64 x 256 x 256 (8 MB each) stay in the 50 MB L2.
//
// What bounds it on an H100: as for resblock_chain.cu, ~300 FLOP per byte of
// activation traffic per layer, at the bf16 ridge, with the activations in L2:
// compute. This first version sits well below the tensor-core peak (mma.sync
// from shared memory, weights re-staged per tile, L launches); wgmma, TMA and
// a persistent launch for the whole chain are later work.
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
// per-image kernel, :262-272).
//
// What bounds it on an H100: the same operations as the inference chain
// (87 GFLOP at 1 x 64 x 256 x 256, L = 18: 0.088 ms at the bf16 peak), and
// L slots of 8.4 MB written per image instead of one output: 161 MB in all,
// 0.048 ms at 3.35 TB/s. Still operations. The slots no longer stay in L2
// (151 MB per image), so each layer's input comes from HBM; at ~300 FLOP per
// byte that costs little beside the tile's compute.

#include "conv3x3.cuh"

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
