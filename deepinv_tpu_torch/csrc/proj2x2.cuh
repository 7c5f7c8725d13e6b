// DRUNet's 2x2 stride-2 projections between scales, bf16 NHWC, for sm_90a:
// the transposed conv up (kernel == stride, so no two taps overlap) and the
// strided conv down, each as one implicit GEMM on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 accumulate), shared by up_resblock_chain.cu
// and up_sandwich.cu.
//
//   kUp:       dst[b, 2i+ph, 2j+pw, co] = bf16(sum_ci src[b, i, j, ci] w[ci, co, ph, pw])
//              M = B*Hm*Wm input pixels, K = Ci, N = 4*Co; the packed weight row
//              n = (ph*2 + pw)*Co + co holds w[:, co, ph, pw]. The epilogue
//              scatters each phase's columns to its pixel of the 2x output.
//   kDownAdd:  dst[b, i, j, co] = bf16(dst[b, i, j, co]
//                                      + sum_{dh,dw,ci} src[b, 2i+dh, 2j+dw, ci] w[co, ci, dh, dw])
//              M = B*Hm*Wm output pixels, K = 4*Cs, N = Co; the A row of pixel
//              (i, j) is the two 2*Cs-long runs src[b, 2i+dh, 2j:2j+2, :], so
//              the packed weight row co holds w[co, :, :, :] in the order
//              k = dh*2Cs + dw*Cs + ci. The f32 sum with dst is rounded once.
//
// A block computes 64 pixels x 64 output columns: it stages the 64 A rows and
// the 64 weight rows (K bf16 each, padded to K + 8 so that fragment loads hit
// distinct banks) in dynamic shared memory, and each of the 4 warps runs
// 16 pixels x 64 columns over K. Pixels past M are zero-filled and not stored.
// The grid is (ceil(M / 64), N / 64). Each output value is rounded to bf16
// once. The work is small beside the 3x3 chains around it (1.07 GFLOP per
// projection at the bench size, 2.7% of K2's), so this first version keeps
// the simple plan.

#pragma once

#include "conv3x3.cuh"

namespace {

enum ProjMode { kUp = 0, kDownAdd = 1 };

constexpr int PROJ_M = 64;   // pixels per block
constexpr int PROJ_N = 64;   // output columns per block

inline int proj_smem_bytes(int K) { return 2 * PROJ_M * (K + 8) * 2; }

template <int MODE>
__global__ void __launch_bounds__(NTHREADS)
proj2x2(const __nv_bfloat16* __restrict__ src, const __nv_bfloat16* __restrict__ wpk,
        __nv_bfloat16* dst, int B, int Hm, int Wm, int K, int Co) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ROW = K + 8;
  __nv_bfloat16* s_a = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* s_b = s_a + PROJ_M * ROW;

  const int tid = threadIdx.x;
  const int M = B * Hm * Wm;
  const int m0 = blockIdx.x * PROJ_M;
  const int n0 = blockIdx.y * PROJ_N;
  const int chunks = K / 8;

  // Stage the A rows (zero past M) and this block's 64 weight rows.
  for (int i = tid; i < PROJ_M * chunks; i += NTHREADS) {
    const int r = i / chunks, c = i % chunks;
    const int p = m0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (p < M) {
      const __nv_bfloat16* q;
      if (MODE == kUp) {
        q = src + (size_t)p * K + c * 8;
      } else {
        const int cs2 = K / 2;                       // 2 * Cs: one (dh) run
        const int b = p / (Hm * Wm), rem = p % (Hm * Wm);
        const int y = 2 * (rem / Wm), x = 2 * (rem % Wm);
        const int kk = c * 8, dh = kk / cs2;
        q = src + ((size_t)(b * 2 * Hm + y + dh) * (2 * Wm) + x) * (cs2 / 2) + kk % cs2;
      }
      v = *reinterpret_cast<const uint4*>(q);
    }
    *reinterpret_cast<uint4*>(s_a + r * ROW + c * 8) = v;
  }
  for (int i = tid; i < PROJ_N * chunks; i += NTHREADS) {
    const int r = i / chunks, c = i % chunks;
    *reinterpret_cast<uint4*>(s_b + r * ROW + c * 8) =
        *reinterpret_cast<const uint4*>(wpk + (size_t)(n0 + r) * K + c * 8);
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;   // mma fragment coordinates

  // acc[n]: pixels 16*warp + g (j = 0, 1) and + 8 (j = 2, 3), columns n*8 + 2t, +1.
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[n][j] = 0.f;

#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 16) {
    const __nv_bfloat16* p0 = s_a + (16 * warp + g) * ROW + k0 + 2 * t;
    const __nv_bfloat16* p1 = p0 + 8 * ROW;
    uint32_t a[4] = {ld_pair(p0), ld_pair(p1), ld_pair(p0 + 8), ld_pair(p1 + 8)};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const __nv_bfloat16* q = s_b + (n * 8 + g) * ROW + k0 + 2 * t;
      mma_16816(acc[n], a, ld_pair(q), ld_pair(q + 8));
    }
  }

  // Epilogue: one bf16 rounding per output value. A block's 64 columns lie in
  // one phase of kUp (Co is a multiple of 64).
  const int phase = n0 / Co, co0 = n0 % Co;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int p = m0 + 16 * warp + g + 8 * half;
    if (p >= M) continue;
    __nv_bfloat16* o;
    if (MODE == kUp) {
      const int b = p / (Hm * Wm), rem = p % (Hm * Wm);
      const int y = 2 * (rem / Wm) + (phase >> 1), x = 2 * (rem % Wm) + (phase & 1);
      o = dst + ((size_t)(b * 2 * Hm + y) * (2 * Wm) + x) * Co + co0;
    } else {
      o = dst + (size_t)p * Co + co0;
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      __nv_bfloat162* op = reinterpret_cast<__nv_bfloat162*>(o + n * 8 + 2 * t);
      float v0 = acc[n][2 * half], v1 = acc[n][2 * half + 1];
      if (MODE == kDownAdd) {
        const __nv_bfloat162 r = *op;
        v0 += __bfloat162float(r.x);
        v1 += __bfloat162float(r.y);
      }
      *op = __floats2bfloat162_rn(v0, v1);
    }
  }
}

// Launch one projection on `s`. kUp: src (B, Hm, Wm, K) -> dst (B, 2Hm, 2Wm,
// Co), wpk (4*Co, K). kDownAdd: src (B, 2Hm, 2Wm, K/4) -> dst (B, Hm, Wm, Co)
// in place, wpk (Co, K). K a multiple of 16, Co of 64.
template <int MODE>
cudaError_t launch_proj2x2(const __nv_bfloat16* src, const __nv_bfloat16* wpk,
                           __nv_bfloat16* dst, int B, int Hm, int Wm, int K, int Co,
                           cudaStream_t s) {
  if (K % 16 != 0 || Co % PROJ_N != 0 || (MODE == kDownAdd && K % 32 != 0)) {
    return cudaErrorInvalidValue;
  }
  const int smem = proj_smem_bytes(K);
  cudaError_t err = cudaFuncSetAttribute(proj2x2<MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int M = B * Hm * Wm;
  const dim3 grid((M + PROJ_M - 1) / PROJ_M, (MODE == kUp ? 4 * Co : Co) / PROJ_N);
  proj2x2<MODE><<<grid, NTHREADS, smem, s>>>(src, wpk, dst, B, Hm, Wm, K, Co);
  return cudaGetLastError();
}

}  // namespace
