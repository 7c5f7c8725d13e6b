// One 3x3 convolution at 64 channels, bf16 NHWC, for sm_90a: the mainloop
// the port's conv-chain kernels share (resblock_chain.cu, conv_chain.cu).
//
// A block computes an 8 x 16 output tile for all 64 output channels: it
// stages the haloed 10 x 18 x 64 input tile and the layer's 9 x 64 x 64
// weights (72 KB, so dynamic shared memory above 48 KB) in shared memory,
// then runs the implicit GEMM M = 128 pixels, N = 64, K = 576 on the tensor
// cores with mma.sync m16n8k16 (bf16 in, f32 accumulate in registers). Rows of
// 64 bf16 are padded to 72 in shared memory so that the fragment loads of a
// warp hit 32 distinct banks. Ragged tiles are masked: the halo is zero-filled
// outside the image and stores outside it are skipped. The grid is
// (W / 16, H / 8, B).
//
// Weights arrive pre-packed tap-major, [tap = ky*3 + kx][co][ci] in bf16. The
// epilogue (a template parameter) rounds each output value to bf16 once:
//   kRelu:      dst = bf16(relu(conv(src)))
//   kResidual:  dst = bf16(dst + conv(src))        (dst read at the same pixel)
//   kBiasRelu:  dst = bf16(relu(conv(src) + bias))  (bias in f32)
//
// Everything here has internal linkage (an unnamed namespace): each .cu file
// that includes the header gets its own kernels, so the translation units
// link into one library without sharing a kernel symbol.

#pragma once

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

enum Epilogue { kRelu = 0, kResidual = 1, kBiasRelu = 2 };

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

// `bias` (64 f32) is read only by kBiasRelu.
template <int EPI>
__global__ void __launch_bounds__(NTHREADS)
conv3x3_c64(const __nv_bfloat16* __restrict__ src,
            const __nv_bfloat16* __restrict__ wpk,
            const float* __restrict__ bias,
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
  float bv[8][2];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    bv[n][0] = EPI == kBiasRelu ? __ldg(bias + n * 8 + 2 * t) : 0.f;
    bv[n][1] = EPI == kBiasRelu ? __ldg(bias + n * 8 + 2 * t + 1) : 0.f;
  }
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
        if (EPI == kResidual) {
          const __nv_bfloat162 r = *op;
          v0 += __bfloat162float(r.x);
          v1 += __bfloat162float(r.y);
        } else {
          if (EPI == kBiasRelu) {
            v0 += bv[n][0];
            v1 += bv[n][1];
          }
          v0 = v0 < 0.f ? 0.f : v0;   // keeps NaN, like torch.relu
          v1 = v1 < 0.f ? 0.f : v1;
        }
        *op = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// Allow the kernel its dynamic shared memory (above the 48 KB default).
template <int EPI>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(conv3x3_c64<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              SMEM_BYTES);
}

}  // namespace
