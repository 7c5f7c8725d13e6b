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
// conv3x3_wgmma.cuh (one CTA an SM over a band or a balanced range of
// 128-pixel row-runs, the
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
// per-image kernel, :262-272). deepinv_conv_chain_stash_wgmma_bf16 (the
// default) runs it as L launches of the wgmma tile with the bias+ReLU
// epilogue. One input and one output tensor map cover the whole stash as one
// (L * B, H, W, 64) tensor: slot l, image b is batch coordinate l * B + b,
// so layer l reads batch offset (l - 1) * B and writes l * B (layer 0 reads
// the caller's input). Two maps instead of two a slot keep the maps of a
// training step within the memo of wg::encode. The earlier entry point
// deepinv_conv_chain_stash_bf16 runs the mma.sync tile of conv3x3.cuh.
//
// What bounds it on an H100: the same operations as the inference chain
// (87 GFLOP at 1 x 64 x 256 x 256, L = 18: 0.088 ms at the bf16 peak), and
// L slots of 8.4 MB written per image instead of one output: 161 MB in all,
// 0.048 ms at 3.35 TB/s. Still operations. The slots no longer stay in L2
// (151 MB per image), so each layer's input comes from HBM; at ~300 FLOP per
// byte that costs little beside the tile's compute.
//
// The stash backward's dX chain (the third group of entry points). The JAX
// package's backward of the chain, `_bwd` (conv_chain.py:405-457), is XLA,
// not Pallas: per layer l from the last, the ReLU mask of the stashed
// output, db[l] = sum of the masked cotangent d_l in f32, dW[l] (a wgrad)
// and d <- bf16(conv(d_l, flip(W[l]) with I/O swapped)). Here the dX
// convs run on the wgmma tile, with the next layer's mask and db folded into
// the epilogue: the layer that computes d_{l-1} = where(acts[l-1] > 0,
// bf16(conv(d_l; W_l^T)), 0) already writes it masked and sums it, so no
// mask pass and no reduction pass read it again.
//   - deepinv_chain_bwd_head_bf16: d_{L-1} = where(acts[L-1] > 0, g, 0) and
//     each CTA's sums of it, one per channel (elementwise, 16 bytes a thread);
//   - deepinv_chain_bwd_dx_wgmma_bf16: one dX layer l on the tile with the
//     weights packed transposed ([l][tap][ci][co], flipped taps), kMaskDb for
//     l >= 1 (the mask read through one map over the stash, batch offset
//     (l - 1) * B; each CTA's 64 sums into row l - 1 of the (L, grid, 64)
//     partials), kRound for l = 0 (dh);
//   - deepinv_chain_bwd_fold_f32: db[l][c] = the sum of the partials of
//     row l over the CTAs, in CTA order. No float atomics anywhere: db is
//     the same bits from run to run.
// dW stays a cuDNN wgrad between the dX launches, reading the masked d_l the
// previous launch wrote (the host loop: dW[l] from d_l, then the launch
// that makes d_{l-1}). Every kernel here is launched with programmatic
// dependent launch and waits (griddepcontrol.wait) before it touches an
// activation or the partials.
// What bounds it on an H100: the dX convs, L x 2 x B x H x W x 64 x 64 x 9
// operations (87 GFLOP at B = 1, L = 18: 0.088 ms at the bf16 peak); the
// head and the fold move B x H x W x 64 x 6 bytes and 4 L x grid x 64.

#include "conv3x3.cuh"
#include "conv3x3_wgmma.cuh"

namespace {

// d = where(act > 0, g, 0) over (B, H, W, 64) bf16 NHWC, and each CTA's 64
// channel sums of d in f32 into partials + 64 * blockIdx.x. The CTA takes
// one contiguous run of pixels; a thread 8 channels (16 bytes) of a pixel,
// 32 pixels a step; the sums go over the thread's pixels, the four threads
// of a warp that share its channels (shuffles), then the 8 warps in order.
constexpr int HEAD_THREADS = 256;

__global__ void __launch_bounds__(HEAD_THREADS)
chain_bwd_head(const __nv_bfloat16* __restrict__ g, const __nv_bfloat16* __restrict__ act,
               __nv_bfloat16* __restrict__ d, float* __restrict__ partials, long long npix) {
  __shared__ float red[HEAD_THREADS / 32][C];
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  asm volatile("griddepcontrol.wait;\n" ::: "memory");   // before g, act and d
  const int tid = threadIdx.x, lane = tid & 31, chunk = tid & 7;
  const long long p0 = npix * blockIdx.x / gridDim.x;
  const long long p1 = npix * (blockIdx.x + 1) / gridDim.x;
  float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (long long p = p0 + (tid >> 3); p < p1; p += HEAD_THREADS / 8) {
    const size_t off = (size_t)p * C + chunk * 8;
    const uint4 gv = *reinterpret_cast<const uint4*>(g + off);
    const uint4 av = *reinterpret_cast<const uint4*>(act + off);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&av);
    uint4 dv;
    __nv_bfloat162* d2 = reinterpret_cast<__nv_bfloat162*>(&dv);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 a = __bfloat1622float2(a2[k]), v = __bfloat1622float2(g2[k]);
      const float v0 = a.x > 0.f ? v.x : 0.f, v1 = a.y > 0.f ? v.y : 0.f;
      d2[k] = __floats2bfloat162_rn(v0, v1);   // exact: bf16 values
      s[2 * k] += v0;
      s[2 * k + 1] += v1;
    }
    *reinterpret_cast<uint4*>(d + off) = dv;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {   // lanes l, l + 8, l + 16, l + 24 share channels
    s[k] += __shfl_xor_sync(0xffffffffu, s[k], 8);
    s[k] += __shfl_xor_sync(0xffffffffu, s[k], 16);
  }
  if (lane < 8) {
#pragma unroll
    for (int k = 0; k < 8; ++k) red[tid >> 5][8 * lane + k] = s[k];
  }
  __syncthreads();
  if (tid < C) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < HEAD_THREADS / 32; ++w) t += red[w][tid];
    partials[(size_t)blockIdx.x * C + tid] = t;
  }
}

// db[l][c] = sum over the CTAs i of partials[l][i][c], in order of i: one
// block a layer, one thread a channel.
__global__ void __launch_bounds__(C) chain_bwd_fold(const float* __restrict__ partials,
                                                    float* __restrict__ db, int rows) {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  asm volatile("griddepcontrol.wait;\n" ::: "memory");   // before the partials
  const float* p = partials + (size_t)blockIdx.x * rows * C + threadIdx.x;
  float t = 0.f;
  for (int i = 0; i < rows; ++i) t += p[(size_t)i * C];
  db[blockIdx.x * C + threadIdx.x] = t;
}

}  // namespace

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
    err = wg::launch<wg::kBiasRelu>(src_l, out[1 + (l & 1)], map_w, l, pb + (size_t)l * C, B, H,
                                    W, plan, s);
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

// The same stash on the wgmma tile, the default: L launches of conv3x3_wgmma
// with the bias+ReLU epilogue, over one input and one output map of the
// whole stash (see the header). strip .. grid: the plan of conv_tile_plan.
int deepinv_conv_chain_stash_wgmma_bf16(const void* src, void* acts, const void* wp,
                                        const void* bias, int B, int H, int W, int L, int strip,
                                        int depth, int smem_bytes, int rows_per_cta, int grid,
                                        void* stream) {
  const wg::Plan plan{strip, depth, smem_bytes, rows_per_cta, grid};
  cudaError_t err = wg::check_plan(plan, B, H, W);
  CUtensorMap in0, stash_in, stash_out, map_w;
  const void* stash = acts;
  if (err == cudaSuccess) err = wg::act_map_c(&in0, src, C, B, H, W, wg::BOX_W);
  if (err == cudaSuccess)
    err = wg::act_maps(&stash_in, &stash_out, &stash, 1, C, L * B, H, W, wg::BOX_W, wg::NPIX);
  if (err == cudaSuccess) err = wg::matrix_map(&map_w, wp, C, (long long)L * 9 * C);
  if (err == cudaSuccess) err = wg::allow_smem<wg::kBiasRelu>();
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* pb = static_cast<const float*>(bias);
  for (int l = 0; l < L && err == cudaSuccess; ++l) {
    wg::Batch0 b0;
    b0.in = l == 0 ? 0 : (l - 1) * B;   // slot l - 1 (the caller's input for l = 0)
    b0.out = l * B;                      // slot l
    err = wg::launch<wg::kBiasRelu>(l == 0 ? in0 : stash_in, stash_out, map_w, l,
                                    pb + (size_t)l * C, B, H, W, plan, s, b0);
  }
  return (int)err;
}

// The head of the stash backward: g, act (the stash's last slot) and d are
// (B, H, W, 64) bf16 NHWC, 16-byte aligned; partials is the (grid, 64) f32
// row of the last layer. grid: the CTAs, the tile plan's grid (every
// partials row has as many).
int deepinv_chain_bwd_head_bf16(const void* g, const void* act, void* d, void* partials, int B,
                                int H, int W, int grid, void* stream) {
  if (B < 1 || H < 1 || W < 1 || grid < 1) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = wg::pdl_config(grid, HEAD_THREADS, 0,
                                          reinterpret_cast<cudaStream_t>(stream), attr);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, chain_bwd_head, static_cast<const __nv_bfloat16*>(g),
      static_cast<const __nv_bfloat16*>(act), static_cast<__nv_bfloat16*>(d),
      static_cast<float*>(partials), (long long)B * H * W);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// One dX layer l of the stash backward on the wgmma tile: d_out = the conv
// of d_in (B, H, W, 64) bf16 by layer l of wtp, the (L, 9, 64, 64) bf16
// weights packed transposed (pack_weights_transposed). For l >= 1 with the
// kMaskDb epilogue: the mask is slot l - 1 of the (L, B, H, W, 64) stash
// `acts` and the CTAs' sums go to row l - 1 of partials, (L, grid, 64) f32;
// for l = 0 with kRound (d_out is dh). strip .. grid: the plan of
// conv_tile_plan.
int deepinv_chain_bwd_dx_wgmma_bf16(const void* d_in, void* d_out, const void* acts,
                                    const void* wtp, void* partials, int B, int H, int W, int L,
                                    int l, int strip, int depth, int smem_bytes,
                                    int rows_per_cta, int grid, void* stream) {
  const wg::Plan plan{strip, depth, smem_bytes, rows_per_cta, grid};
  cudaError_t err = wg::check_plan(plan, B, H, W);
  if (err == cudaSuccess && (l < 0 || l >= L)) err = cudaErrorInvalidValue;
  CUtensorMap in, out, mask, map_w;
  if (err == cudaSuccess) err = wg::act_map_c(&in, d_in, C, B, H, W, wg::BOX_W);
  if (err == cudaSuccess) err = wg::act_map_c(&out, d_out, C, B, H, W, wg::NPIX);
  if (err == cudaSuccess) err = wg::matrix_map(&map_w, wtp, C, (long long)L * 9 * C);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (l == 0) {
    err = wg::allow_smem<wg::kRound>();
    if (err == cudaSuccess)
      err = wg::launch<wg::kRound>(in, out, map_w, 0, nullptr, B, H, W, plan, s);
    return (int)err;
  }
  // the stash's output map (the forward's, so the memo finds it)
  err = wg::act_map_c(&mask, acts, C, L * B, H, W, wg::NPIX);
  if (err == cudaSuccess) err = wg::allow_smem<wg::kMaskDb>();
  if (err == cudaSuccess) {
    wg::Batch0 b0;
    b0.aux = (l - 1) * B;
    err = wg::launch<wg::kMaskDb>(in, out, map_w, l, nullptr, B, H, W, plan, s, b0, &mask,
                                  static_cast<float*>(partials) + (size_t)(l - 1) * grid * C);
  }
  return (int)err;
}

// db (L, 64) f32 from the (L, grid, 64) partials, in a fixed order.
int deepinv_chain_bwd_fold_f32(const void* partials, void* db, int L, int grid, void* stream) {
  if (L < 1 || grid < 1) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = wg::pdl_config(L, C, 0, reinterpret_cast<cudaStream_t>(stream), attr);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, chain_bwd_fold,
                                             static_cast<const float*>(partials),
                                             static_cast<float*>(db), grid);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // extern "C"
