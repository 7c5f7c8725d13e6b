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
// Design. One C entry point runs 2R launches of one direct-conv kernel over two
// ping-pong buffers: `a` holds h (and receives each block's output in place),
// `t` holds relu(conv1(h)). A block computes an 8 x 16 output tile for all 64
// output channels: it stages the haloed 10 x 18 x 64 input tile and the
// layer's 9 x 64 x 64 weights (72 KB, so dynamic shared memory above 48 KB) in
// shared memory, then runs the implicit GEMM M = 128 pixels, N = 64, K = 576 on
// the tensor cores with mma.sync m16n8k16 (bf16 in, f32 accumulate in
// registers). Rows of 64 bf16 are padded to 72 in shared memory so that the
// fragment loads of a warp hit 32 distinct banks. Ragged tiles are masked: the
// halo is zero-filled outside the image and stores outside it are skipped.
// Writing conv2's output into `a` in place is safe: within one launch `a` is
// read only at the pixel each thread writes (the residual); the conv input is
// `t`.
//
// What bounds it on an H100. One conv at 1 x 64 x 256 x 256 is
// 2 * 256^2 * 64 * 64 * 9 = 4.8 GFLOP over ~16 MB of activation traffic
// (~300 FLOP/B), at the card's bf16 ridge; the 8 MB activation fits in the
// 50 MB L2, so the chain should be compute-bound. This first version uses
// mma.sync from shared memory, not wgmma/TMA, re-reads the weights per tile
// (L2-resident) and keeps two blocks of 4 warps per SM, so it will sit well
// below the tensor-core peak; wgmma, TMA, clusters and one persistent launch
// for the whole chain are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 64;            // channels in and out
constexpr int TH = 8;            // output rows per block
constexpr int TW = 16;           // output columns per block
constexpr int HALO_H = TH + 2;
constexpr int HALO_W = TW + 2;
constexpr int ROW = 72;          // shared-memory stride of one 64-channel row, in bf16
constexpr int NTHREADS = 128;    // 4 warps; warp w owns output rows 2w, 2w+1
constexpr int IN_ELEMS = HALO_H * HALO_W * ROW;
constexpr int W_ELEMS = 9 * C * ROW;
constexpr int SMEM_BYTES = (IN_ELEMS + W_ELEMS) * 2;
constexpr int TAP_ELEMS = 9 * C * C;   // one layer's packed weights

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D += A(16x16, row) * B(16x8, col), bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One 3x3 conv, 64 -> 64 channels, NHWC bf16. RESIDUAL=false: dst =
// bf16(relu(conv(src))). RESIDUAL=true: dst = bf16(dst + conv(src)).
template <bool RESIDUAL>
__global__ void __launch_bounds__(NTHREADS)
conv3x3_c64(const __nv_bfloat16* __restrict__ src,
            const __nv_bfloat16* __restrict__ wpk,
            __nv_bfloat16* dst, int H, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* s_in = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* s_w = s_in + IN_ELEMS;

  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const size_t img = (size_t)blockIdx.z * H * W;

  // Stage the weights: 9*64 rows of 64 bf16, 8 x 16 bytes per row.
  const uint4* wsrc = reinterpret_cast<const uint4*>(wpk);
  for (int i = tid; i < 9 * C * 8; i += NTHREADS) {
    *reinterpret_cast<uint4*>(s_w + (i >> 3) * ROW + (i & 7) * 8) = wsrc[i];
  }
  // Stage the haloed input tile, zero outside the image.
  for (int i = tid; i < HALO_H * HALO_W * 8; i += NTHREADS) {
    const int p = i >> 3, chunk = i & 7;
    const int y = y0 - 1 + p / HALO_W, x = x0 - 1 + p % HALO_W;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (y >= 0 && y < H && x >= 0 && x < W) {
      v = *reinterpret_cast<const uint4*>(src + (img + (size_t)y * W + x) * C + chunk * 8);
    }
    *reinterpret_cast<uint4*>(s_in + p * ROW + chunk * 8) = v;
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;   // mma fragment coordinates

  // acc[i][n]: output row 2*warp+i, columns g and g+8 of the tile,
  // output channels n*8 + 2t, +1.
  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][n][j] = 0.f;

#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap % 3;
#pragma unroll
    for (int k0 = 0; k0 < C; k0 += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const __nv_bfloat16* p0 =
            s_in + ((2 * warp + i + dy) * HALO_W + g + dx) * ROW + k0 + 2 * t;
        const __nv_bfloat16* p1 = p0 + 8 * ROW;   // tile column g + 8
        a[i][0] = ld_pair(p0);
        a[i][1] = ld_pair(p1);
        a[i][2] = ld_pair(p0 + 8);
        a[i][3] = ld_pair(p1 + 8);
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const __nv_bfloat16* q = s_w + (tap * C + n * 8 + g) * ROW + k0 + 2 * t;
        const uint32_t b0 = ld_pair(q), b1 = ld_pair(q + 8);
        mma_16816(acc[0][n], a[0], b0, b1);
        mma_16816(acc[1][n], a[1], b0, b1);
      }
    }
  }

  // Epilogue: one bf16 rounding per output value.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int y = y0 + 2 * warp + i;
    if (y >= H) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int x = x0 + g + 8 * half;
      if (x >= W) continue;
      __nv_bfloat16* o = dst + (img + (size_t)y * W + x) * C;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        __nv_bfloat162* op = reinterpret_cast<__nv_bfloat162*>(o + n * 8 + 2 * t);
        float v0 = acc[i][n][2 * half], v1 = acc[i][n][2 * half + 1];
        if (RESIDUAL) {
          const __nv_bfloat162 r = *op;
          v0 += __bfloat162float(r.x);
          v1 += __bfloat162float(r.y);
        } else {
          v0 = v0 < 0.f ? 0.f : v0;   // keeps NaN, like torch.relu
          v1 = v1 < 0.f ? 0.f : v1;
        }
        *op = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

}  // namespace

extern "C" {

// Runs R residual blocks in place on `a` (B, H, W, 64) bf16, using `t` (same
// shape) as scratch. w1p/w2p: (R, 9, 64, 64) bf16 packed [r][tap][co][ci].
// Returns the first CUDA error of the launches (0 on success).
int deepinv_resblock_chain_bf16(void* a, void* t, const void* w1p, const void* w2p,
                                int B, int H, int W, int R, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_c64<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      conv3x3_c64<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;

  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  __nv_bfloat16* pa = static_cast<__nv_bfloat16*>(a);
  __nv_bfloat16* pt = static_cast<__nv_bfloat16*>(t);
  const __nv_bfloat16* p1 = static_cast<const __nv_bfloat16*>(w1p);
  const __nv_bfloat16* p2 = static_cast<const __nv_bfloat16*>(w2p);
  for (int r = 0; r < R; ++r) {
    conv3x3_c64<false><<<grid, NTHREADS, SMEM_BYTES, s>>>(pa, p1 + (size_t)r * TAP_ELEMS, pt, H, W);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    conv3x3_c64<true><<<grid, NTHREADS, SMEM_BYTES, s>>>(pt, p2 + (size_t)r * TAP_ELEMS, pa, H, W);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

const char* deepinv_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
