// DRUNet's 2x2 stride-2 projections between scales on wgmma fed by TMA
// (sm_90a): the up projection (transposed conv, kernel == stride) of
// up_resblock_chain.cu (K2/K3) and of up_sandwich.cu (K4's up2 and up1), and
// K4's skip (strided conv of the scale-0 down-chain output added into the
// scale-1 activation in place). They replace the in-kernel dots of the TPU
// kernels (`_fused_up_fwd_impl` and `_sandwich_kernel`,
// deepinv_tpu/ops/pallas/resblock_chain.py:319, :442). The mma.sync GEMMs of
// proj2x2.cuh stay for the earlier entry points.
//
//   kUp:       dst[b, 2i+ph, 2j+pw, co] = bf16(sum_ci src[b, i, j, ci] w[ci, co, ph, pw])
//   kDownAdd:  dst[b, i, j, co] = bf16(dst[b, i, j, co]
//                                      + sum_{dh,dw,ci} src[b, 2i+dh, 2j+dw, ci] w[co, ci, dh, dw])
//
// Each is a GEMM a row-run: N = NPIX = 64 pixels of one row, B = their
// channels K-major, K-blocks of 64 channels (each one TMA box, 128-byte
// swizzle; channels past K read as zero), M = 64 output channels, A = a
// 64-row slice of the packed weight (one 64 x 64 TMA box a K-block). The
// CTA (2 consumer warpgroups + 1 producer warp) owns a band of rows of one
// strip and one group of output channels; the producer streams the band's
// row-runs through a ring of DEPTH slots, and both warpgroups read every
// slot with their own A. Up to KB_MAX K-blocks (K <= 256) the weight slices
// stay resident; a wider kUp input (K > 256) is cut into chunks of KB_MAX
// K-blocks, and each ring stage (SDEPTH of them, in the same shared memory)
// then carries one chunk's weight boxes beside its input boxes, the
// products of a row-run accumulating over its chunks:
//   - kUp, weight packed (4 Co, K) with row (ph 2 + pw) Co + co: group g is
//     (ph = g % 2, 64 channels co0 = 64 (g / 2)), warpgroup q is pw = q. Both
//     scatter their 64 x 64 result into one output row-run of 2 NPIX pixels:
//     input pixel n lands at pixel 2 n + pw of output row 2 i + ph (the
//     accumulator leaves by stmatrix, whose rows are addressed a pixel
//     each), and one TMA store box of 128 pixels x 64 channels writes it.
//     The output buffer is double-buffered between rows.
//   - kDownAdd, weight packed (Co, 256) with column dh 128 + dw 64 + ci: the
//     64-channel source (B, 2Hm, 2Wm, 64) is read as (B, 2Hm, Wm, 128), whose
//     pixel j holds channels dw 64 + ci of pixels 2j + dw, so output row i's K
//     = 256 is four boxes: rows 2i and 2i + 1 of that view, channels 0-63 and
//     64-127, in the weight's column order. Group g is 128 output channels,
//     warpgroup q its half 64 (2g + q); the in-place add reads the residual
//     row-run by TMA into the warpgroup's output buffer during the products,
//     as the conv tile's kResidual epilogue does, and rounds once.
//
// What bounds it. At the bench shapes a projection is 1-3 GFLOP over 17-100
// MB (at B = 8): bytes. The weights cross from L2 once a CTA; each input
// row-run is read once by the CTAs of its groups (2 for K2/K3 and up1, 4 for
// up2, 1 for the skip), which run side by side (the group is the fastest
// grid index), so the repeats hit L2. Layers chain by programmatic dependent
// launch as the conv tiles do: a projection reads and writes activations
// only after griddepcontrol.wait. The launch plan is proj_plan
// (ops/kernels/conv_tile.py), checked here by check_plan.

#pragma once

#include "conv3x3_wgmma.cuh"

namespace {
namespace wgp {

constexpr int NPIX = 64;                // pixels of a row-run: the wgmma N
constexpr int KB_MAX = 4;               // K-blocks of 64 channels a chunk (resident: K <= 256)
constexpr int DEPTH = 4;                // ring slots
constexpr int ROW_BYTES = 128;          // one K-block of a pixel (or of a weight row)
constexpr int A_BYTES = 64 * 64 * 2;    // one 64 x 64 weight box
constexpr int W_BYTES = 2 * KB_MAX * A_BYTES;      // the two warpgroups' weight slices
constexpr int BOX_BYTES = NPIX * ROW_BYTES;        // one K-block of an input row-run
constexpr int SLOT_BYTES = KB_MAX * BOX_BYTES;     // one ring slot
constexpr int OUT_BYTES = 2 * NPIX * ROW_BYTES;    // an output buffer: 2 NPIX pixels x 64 ch
constexpr int NOUT = 2;                 // output buffers
constexpr int NCONS = 2;                // consumer warpgroups
constexpr int NTHREADS = NCONS * 128 + 32;   // and one producer warp
constexpr int BAR_BYTES = 256;
constexpr int SMEM_BYTES = 1024 + W_BYTES + DEPTH * SLOT_BYTES + NOUT * OUT_BYTES + BAR_BYTES;
// K > 64 KB_MAX: a stage holds one chunk's weight slices and input boxes
constexpr int STAGE_BYTES = W_BYTES + SLOT_BYTES;
constexpr int SDEPTH = (W_BYTES + DEPTH * SLOT_BYTES) / STAGE_BYTES;   // stages
static_assert(SMEM_BYTES <= 232448, "the tile exceeds an SM's 227 KB of shared memory");
static_assert(2 * NPIX <= 256, "a TMA box dimension is at most 256");
static_assert((2 * DEPTH + 1 + NCONS) * 8 <= BAR_BYTES, "the barriers exceed their space");
static_assert(SDEPTH >= 2 && SDEPTH <= DEPTH, "the chunked stages do not fit the ring's space");

enum Mode { kUp = 0, kDownAdd = 1 };

// in_map: the source in boxes of 64 channels x NPIX pixels (kDownAdd: its
// (B, 2Hm, Wm, 128) view); out_map: the destination in boxes of 64 channels x
// 2 NPIX (kUp) or NPIX (kDownAdd) pixels; w_map: the packed weight in 64 x 64
// boxes. kb: K-blocks (kDownAdd: KB_MAX); Hm: rows of the band space (kUp:
// input rows, kDownAdd: output rows). The grid is groups * B * strips *
// ceil(Hm / rows_per_cta).
template <int MODE>
__global__ void __launch_bounds__(NTHREADS, 1)
proj2x2_wgmma(const __grid_constant__ CUtensorMap in_map,
              const __grid_constant__ CUtensorMap out_map,
              const __grid_constant__ CUtensorMap w_map, int kb, int Co, int Hm, int strips,
              int rows_per_cta, int groups) {
  using namespace wg;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t s_w = base;
  const uint32_t s_ring = base + W_BYTES;
  const uint32_t s_out = s_ring + DEPTH * SLOT_BYTES;
  const uint32_t bars = s_out + NOUT * OUT_BYTES;
  auto full = [&](int i) { return bars + 8u * i; };
  auto empty = [&](int i) { return bars + 8u * (DEPTH + i); };
  const uint32_t wbar = bars + 8u * 2 * DEPTH;
  auto rbar = [&](int q) { return bars + 8u * (2 * DEPTH + 1 + q); };

  const int g = blockIdx.x % groups;
  const int unit = blockIdx.x / groups;
  const int bands = (Hm + rows_per_cta - 1) / rows_per_cta;
  const int col = unit / bands;
  const int b = col / strips;
  const int x0 = (col % strips) * NPIX;
  const int y0 = (unit % bands) * rows_per_cta;
  const int nrows = min(rows_per_cta, Hm - y0);
  const int tid = threadIdx.x;
  // kUp: phase row ph and output channels co0 .. co0 + 63 of group g
  const int ph = g & 1, co0 = 64 * (g >> 1);
  // the first weight row of warpgroup q's slice
  auto w_row = [&](int q) { return MODE == kUp ? (ph * 2 + q) * Co + co0 : (2 * g + q) * 64; };
  // Step i of the pipeline is chunk i % chunks of row-run i / chunks, in
  // stage i % depth: the ring slot alone (resident weights), or a chunk's
  // weights followed by its input boxes (streamed)
  const int chunks = (kb + KB_MAX - 1) / KB_MAX;
  const bool streamed = chunks > 1;
  const int depth = streamed ? SDEPTH : DEPTH;
  auto a_at = [&](int st) { return streamed ? s_w + st * STAGE_BYTES : s_w; };
  auto b_at = [&](int st) {
    return streamed ? s_w + st * STAGE_BYTES + W_BYTES : s_ring + st * SLOT_BYTES;
  };
  auto kblocks = [&](int c) { return min(KB_MAX, kb - c * KB_MAX); };

  if (tid == 0) {
    for (int i = 0; i < DEPTH; ++i) {
      mbar_init(full(i), 1);
      mbar_init(empty(i), NCONS * 4);   // one arrival a consumer warp
    }
    mbar_init(wbar, 1);
    for (int q = 0; q < NCONS; ++q) mbar_init(rbar(q), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  if (tid >= NCONS * 128) {
    // producer: the two resident weight slices once, then the band's
    // row-runs (streamed: each chunk with its weights)
    if (tid == NCONS * 128) {
      if (!streamed) {
        mbar_expect_tx(wbar, 2 * kb * A_BYTES);
        for (int q = 0; q < NCONS; ++q)
          for (int k = 0; k < kb; ++k)
            tma_load_2d(s_w + (q * KB_MAX + k) * A_BYTES, &w_map, 64 * k, w_row(q), wbar);
      }
      asm volatile("griddepcontrol.wait;\n" ::: "memory");
      for (int i = 0; i < nrows * chunks; ++i) {
        const int st = i % depth, y = y0 + i / chunks, c = i % chunks, n = kblocks(c);
        if (i >= depth) mbar_wait(empty(st), (i / depth - 1) & 1);
        mbar_expect_tx(full(st), n * (BOX_BYTES + (streamed ? NCONS * A_BYTES : 0)));
        for (int k = 0; k < n; ++k) {
          const int kg = c * KB_MAX + k;   // the K-block
          if (streamed)
            for (int q = 0; q < NCONS; ++q)
              tma_load_2d(a_at(st) + (q * KB_MAX + k) * A_BYTES, &w_map, 64 * kg, w_row(q),
                          full(st));
          if (MODE == kUp)
            tma_load_4d(b_at(st) + k * BOX_BYTES, &in_map, 64 * kg, x0, y, b, full(st));
          else   // K-block k: view row 2y + k / 2, channels 64 (k % 2) ..
            tma_load_4d(b_at(st) + k * BOX_BYTES, &in_map, 64 * (k & 1), x0, 2 * y + (k >> 1),
                        b, full(st));
        }
      }
    }
    return;
  }

  // consumer warpgroup q; thread (warp, lane) holds output channels
  // 16 warp + lane / 4 (+ 8) at pixels 8 j + 2 (lane % 4) (+ 1) of a row-run
  const int q = tid >> 7, wtid = tid & 127, lane = tid & 31;
  const float no_bias[2] = {0.f, 0.f};
  const uint32_t s_res = s_out + q * OUT_BYTES;   // kDownAdd: this warpgroup's row-run
  asm volatile("griddepcontrol.wait;\n" ::: "memory");   // before the residual and the stores
  if (!streamed) mbar_wait(wbar, 0);

  float d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  for (int r = 0; r < nrows; ++r) {
    const int y = y0 + r;
    if (MODE == kDownAdd && wtid == 0) {
      tma_store_wait_read();
      mbar_expect_tx(rbar(q), BOX_BYTES);
      tma_load_4d(s_res, &out_map, 64 * (2 * g + q), x0, y, b, rbar(q));
    }
    for (int c = 0; c < chunks; ++c) {
      const int i = r * chunks + c, st = i % depth, n = kblocks(c);
      mbar_wait(full(st), (i / depth) & 1);
      fence_acc(d);
      wgmma_fence();
      for (int k = 0; k < n; ++k) {
        const uint32_t a0 = a_at(st) + (q * KB_MAX + k) * A_BYTES;
        const uint32_t b0 = b_at(st) + k * BOX_BYTES;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n64k16(d, sw128_desc(a0 + kk * 32), sw128_desc(b0 + kk * 32),
                          (c | k | kk) != 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(d);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
    }

    uint32_t s_o;
    if (MODE == kUp) {
      // buffer r % 2 is free once the store of row r - 2 has read it
      s_o = s_out + (r & 1) * OUT_BYTES;
      if (tid == 0) tma_store_wait_read<1>();
      named_bar(1, NCONS * 128);
    } else {
      s_o = s_res;
      mbar_wait(rbar(q), r & 1);   // the residual is in (and the store has read)
    }
    // one bf16 rounding a value, into the buffer by stmatrix (kUp: input
    // pixel n to row 2 n + pw of the output row-run)
    if (MODE == kUp)
      store_fragment<wg::kRound>(d, s_o, 2, q, no_bias);
    else
      store_fragment<wg::kResidual>(d, s_o, 1, 0, no_bias);
    fence_async_shared();
    if (MODE == kUp) {
      named_bar(1, NCONS * 128);
      if (tid == 0) tma_store_4d(&out_map, s_o, co0, 2 * x0, 2 * y + ph, b);
    } else {
      named_bar(1 + q, 128);
      if (wtid == 0) tma_store_4d(&out_map, s_o, 64 * (2 * g + q), x0, y, b);
    }
  }
  if (wtid == 0) tma_store_wait_all();
}

// ---------------------------------------------------------------- host side

// The launch plan the Python wrapper computes (proj_plan in
// ops/kernels/conv_tile.py): strip, depth, smem_bytes, rows_per_cta, grid,
// groups; checked against the kernel's constants and the shape.
struct Plan {
  int strip, depth, smem_bytes, rows_per_cta, grid, groups;
};

inline Plan plan_at(const int* p) { return Plan{p[0], p[1], p[2], p[3], p[4], p[5]}; }

template <int MODE>
cudaError_t check_plan(const Plan& p, int B, int Hm, int Wm, int K, int Co) {
  const bool shape_ok = MODE == kUp ? (K > 0 && K % 16 == 0 && Co % 64 == 0)
                                    : (K == 64 * KB_MAX && Co % 128 == 0);
  const int groups = MODE == kUp ? 2 * (Co / 64) : Co / 128;
  if (!shape_ok || p.strip != NPIX || p.depth != DEPTH || p.smem_bytes != SMEM_BYTES ||
      p.groups != groups || p.rows_per_cta < 1 || B < 1 || Hm < 1 || Wm < 1)
    return cudaErrorInvalidValue;
  const long long strips = (Wm + NPIX - 1) / NPIX;
  const long long bands = (Hm + p.rows_per_cta - 1) / p.rows_per_cta;
  return (long long)p.grid == groups * B * strips * bands ? cudaSuccess : cudaErrorInvalidValue;
}

// One projection on `s`, with programmatic dependent launch. kUp: src (B,
// Hm, Wm, K) -> dst (B, 2Hm, 2Wm, Co), wpk (4 Co, K). kDownAdd: src (B, 2Hm,
// 2Wm, K / 4) -> dst (B, Hm, Wm, Co) in place, wpk (Co, K), K = 256.
template <int MODE>
cudaError_t project(const void* src, const void* wpk, void* dst, int B, int Hm, int Wm, int K,
                    int Co, const Plan& p, cudaStream_t s) {
  cudaError_t err = check_plan<MODE>(p, B, Hm, Wm, K, Co);
  CUtensorMap in, out, w;
  if (err == cudaSuccess)
    err = MODE == kUp ? wg::act_map_c(&in, src, K, B, Hm, Wm, NPIX)
                      : wg::act_map_c(&in, src, 2 * (K / 4), B, 2 * Hm, Wm, NPIX);
  if (err == cudaSuccess)
    err = MODE == kUp ? wg::act_map_c(&out, dst, Co, B, 2 * Hm, 2 * Wm, 2 * NPIX)
                      : wg::act_map_c(&out, dst, Co, B, Hm, Wm, NPIX);
  if (err == cudaSuccess) err = wg::matrix_map(&w, wpk, K, MODE == kUp ? 4 * Co : Co);
  if (err == cudaSuccess) err = wg::allow_smem_once<proj2x2_wgmma<MODE>>(SMEM_BYTES);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = wg::pdl_config(p.grid, NTHREADS, SMEM_BYTES, s, attr);
  err = cudaLaunchKernelEx(&cfg, proj2x2_wgmma<MODE>, in, out, w, (K + 63) / 64, Co, Hm,
                           (Wm + NPIX - 1) / NPIX, p.rows_per_cta, p.groups);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace wgp
}  // namespace
