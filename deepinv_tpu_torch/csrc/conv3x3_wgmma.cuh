// One 3x3 convolution at 64 channels, bf16 NHWC, on Hopper's wgmma fed by
// TMA (sm_90a): the tile of the DRUNet scale-0 chains (resblock_chain.cu, K1;
// up_resblock_chain.cu, K2/K3; up_sandwich.cu, K4) and the DnCNN chain
// (conv_chain.cu: K5, the training forward K6 and the dX chain of its stash
// backward). The primitives here (barriers, TMA, wgmma descriptors,
// clusters) also serve the 128-channel tile (conv3x3_c128_wgmma.cuh) and the
// 2x2 projections (proj2x2_wgmma.cuh). The mma.sync tile of conv3x3.cuh stays
// only for the earlier entry points.
//
// The GEMM. For one output row-run of NPIX = 128 pixels along an image row:
//   M = the 64 output channels (wgmma's fixed m64), A = the tap's 64 x 64
//       weight slice [co][ci], resident in shared memory;
//   N = the 128 pixels, B = the haloed input row y + dy - 1, started dx
//       pixels in: B(ci, n) = x(y + dy - 1, x0 + n + dx - 1, ci);
//   K = 16 input channels an instruction: 9 taps x 4 = 36 wgmma.m64n128k16
//       an output row-run, summed in 64 f32 registers a thread.
// Both operands are K-major with the 128-byte swizzle: a pixel's (or an
// output channel's) 64 channels are one 128-byte row, and 8 rows one
// 1024-byte swizzle atom, as TMA writes them. Tap (dy, dx) is the same B
// descriptor started dx * 128 bytes into a ring row; the swizzle is a
// function of the shared-memory address, so the shifted start reads the
// right channels (chip_smoke.py holds every tap at a ragged shape).
//
// The schedule. The layer's output row-runs are numbered column by column,
// a column being one 128-column strip of one image, rows down it. A CTA
// (2 consumer warpgroups + 1 producer warp, one CTA per SM) computes one
// contiguous range of them, in segments of consecutive rows of one column:
//   - the banded plan (rows_per_cta > 0): a band of rows_per_cta rows of one
//     column, one segment, one CTA a band;
//   - the balanced schedule (rows_per_cta = 0): a persistent CTA, at most one
//     an SM, whose range balances the cost of the CTAs' row-runs (a full
//     one FULL_COST, a narrow one NARROW_COST) and may cross from one
//     column into the next (balanced_start). The weights stay resident
//     across its segments.
// A narrow row-run (the strip holds at most NPIX / 2 columns of the image:
// 320 = 128 + 128 + 64) issues wgmma.m64n64k16 on the first 64 pixels
// instead of computing padding: the same taps and K steps in the same order
// for each value it keeps, so the same bits. Only a launch whose last strip
// is that narrow runs the instantiation with the narrow product (RAGGED,
// narrow_strip); kMaskDb keeps the full product.
//   - the producer loads the layer's 72 KB of weights once (9 TMA boxes of
//     64 x 64), then streams each segment's input rows y0 - 1 .. y0 + rows
//     through one ring of DEPTH slots, each a TMA box of 130 pixels x 64
//     channels from the tensor map over (C, W, H, B), the barrier phases
//     running on across segments. Coordinates -1 and boxes past the image
//     fill with zeros: the conv's padding;
//   - consumer warpgroup q takes the CTA's rows q, q + 2, ... (counted over
//     its segments): for output row y it waits for ring rows y - 1, y, y + 1
//     (mbarriers), issues the 36 products, waits for them, and releases ring
//     rows y - 1 and y, which its next row in the segment does not read.
//     Each ring row is released by both warpgroups, and each warpgroup waits
//     for the loads in order: before a row it waits for and releases the
//     loads it skipped (the absent row above a segment for the warpgroup
//     that starts on its second row; the last rows of the previous segment),
//     since a parity wait two phases ahead would pass at once;
//   - the epilogue works on the f32 accumulator in registers (channel-
//     major: row = channel, column = pixel), rounds each value to bf16 once
//     and writes it with stmatrix .trans into the warpgroup's output buffer
//     in NHWC (a pixel's 64 channels one 128-byte row, 128-byte swizzle);
//     one thread then stores the row-run with one TMA store, which clips
//     the ragged right edge. kResidual (kMaskDb) first TMA-loads the
//     residual (mask) row-run into the same buffer (during the products)
//     and reads it with ldmatrix .trans into the accumulator's layout.
//     Bands past the bottom edge are shortened.
// Epilogues:
//   kRelu:      dst = bf16(relu(conv(src)))
//   kResidual:  dst = bf16(dst + conv(src))        (dst read at the same pixel)
//   kBiasRelu:  dst = bf16(relu(conv(src) + bias))  (bias in f32)
//   kRound:     dst = bf16(conv(src))
//   kMaskDb:    dst = where(aux > 0, bf16(conv(src)), 0), and the CTA's f32
//               sums of the values written, one per output channel, into its
//               row of `partials` (the stash backward's db; aux is the
//               stashed activation, whose out-of-bounds pixels read as zero)
// A launch's maps may cover several tensors stacked along the batch (the
// K6 stash, (L * B, H, W, 64)): image b reads batch coordinate b + in_b0 of
// src_map and writes b + out_b0 of out_map (and reads b + aux_b0 of aux_map).
//
// What bounds it. One wgmma.m64n128k16 reads 2 KB of A and 4 KB of B from
// shared memory for 262 kFLOP, ~44 FLOP a byte: above the ~32 the tensor
// cores need at the SM's 128 bytes a clock, so the products are bound by the
// tensor cores, not by shared memory (the mma.sync tile reaches ~21). The
// weights cross from L2 once a CTA, not once a 128-pixel tile, and the
// output (and K1's residual) moves by TMA: the consumers' only global
// access is the bias.
// What is left per launch: the weight load and the first ring rows before
// the first product, and the last row's epilogue after it (one launch a
// conv). At B = 8 (67 MB an activation, above the 50 MB L2) each layer also
// reads and writes its activation in device memory: ~40 us at 3.35 TB/s
// against ~39 us of products at the bf16 peak.
//
// Host side: the tensor maps (an input and an output map per activation
// buffer, one per packed weight stack) are encoded through
// cuTensorMapEncodeTiled, taken from the driver with cudaGetDriverEntryPoint
// (the library links no libcuda), once for each set of arguments (encode
// keeps the last maps), and passed by value as __grid_constant__
// parameters. Layers chain by programmatic dependent launch.
//
// Everything here has internal linkage (an unnamed namespace, nested
// namespace wg: conv3x3.cuh's names stay apart when a file includes both).

#pragma once

#include <cuda.h>   // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <mutex>

namespace {
namespace wg {

constexpr int CH = 64;                  // input and output channels
constexpr int NPIX = 128;               // output pixels of a row-run: the wgmma N
constexpr int NARROW = NPIX / 2;        // a strip's columns at most: the narrow product's N
// the balanced schedule's cost of a row-run and of a narrow one: the narrow
// one's products take half the time, its ring load, barriers and store as
// long (on an H100 a narrow row-run took 0.61-0.65 of a full one, and K5 at
// 16 x 64 x 320² took the same time within 1.2% costed 3/4 or 2/3, PERF.md)
constexpr int FULL_COST = 4;
constexpr int NARROW_COST = 3;
constexpr int BOX_W = NPIX + 2;         // haloed input pixels of a ring row
constexpr int DEPTH = 7;                // ring slots
constexpr int ROW_BYTES = CH * 2;       // one pixel's (or weight row's) channels
constexpr int TAP_BYTES = CH * CH * 2;  // one tap's 64 x 64 weights
constexpr int W_BYTES = 9 * TAP_BYTES;  // one layer's weights
constexpr int BOX_BYTES = BOX_W * ROW_BYTES;                    // one ring row, as loaded
constexpr int SLOT_BYTES = (BOX_BYTES + 1023) / 1024 * 1024;    // ... 1024-B aligned
constexpr int OUT_BYTES = NPIX * ROW_BYTES;  // a consumer's output row-run (and residual)
constexpr int NCONS = 2;                // consumer warpgroups
constexpr int NTHREADS = NCONS * 128 + 32;   // and one producer warp
constexpr int BAR_BYTES = 256;
// the dynamic shared memory a CTA asks for: 1024 of slack to align the base
constexpr int SMEM_BYTES = 1024 + W_BYTES + DEPTH * SLOT_BYTES + NCONS * OUT_BYTES + BAR_BYTES;
static_assert(SMEM_BYTES <= 232448, "the tile exceeds an SM's 227 KB of shared memory");
static_assert(BOX_W <= 256, "a TMA box dimension is at most 256");
static_assert((2 * DEPTH + 1 + NCONS) * 8 <= BAR_BYTES, "the barriers exceed their space");

enum Epilogue { kRelu = 0, kResidual = 1, kBiasRelu = 2, kRound = 3, kMaskDb = 4 };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`. A wait
// of more than ~2^34 clocks (seconds; a launch takes microseconds) traps: a
// lost arrival becomes a launch error, not a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (!done && clock64() - t0 > (1ll << 34)) __trap();
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(bar) : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar) : "memory");
}

// TMA store of a box from shared memory, tracked by the bulk group of the
// issuing thread.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's TMA stores have not yet read their
// shared memory.
template <int N = 0>
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Wait until this thread's TMA stores are complete.
__device__ __forceinline__ void tma_store_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Make this thread's shared-memory writes visible to TMA (the async proxy).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Four 8x8 b16 matrices between registers and shared memory, transposed:
// register m of thread l holds (row l / 4, columns 2 (l % 4), +1) of matrix
// m, whose memory row k (16 bytes) is at the address thread 8 m + k gives.
__device__ __forceinline__ void stmatrix_x4_trans(uint32_t addr, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n"
               ::"r"(addr), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3]) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// The epilogue of a warpgroup's 64-channel x 2R-pixel f32 accumulator (the
// wgmma fragment: thread (warp, lane) holds channels 16 warp + lane / 4 (+ 8)
// at pixels 8 j + 2 (lane % 4) (+ 1)), one bf16 rounding a value, written by
// stmatrix .trans into a 1024-byte-aligned buffer of 128-byte pixel rows with
// the 128-byte swizzle, as TMA stores it. Fragment pixel px lands in buffer
// row px * pstride + poff. kResidual adds the value the buffer already holds
// (ldmatrix .trans); kRelu and kBiasRelu add bv (the bias of the thread's two
// channels; zero for kRelu) and apply the ReLU; kRound only rounds; kMaskDb
// keeps the values where the buffer holds a positive value, zeros the rest,
// and adds the rounded values of each of the thread's two channels into
// sum[0], sum[1].
template <int EPI, int R>
__device__ __forceinline__ void store_fragment(const float (&d)[R], uint32_t buf, int pstride,
                                               int poff, const float (&bv)[2],
                                               float* sum = nullptr) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  // matrix m = lane / 8 of each x4 covers pixels 8 (2 jj + m / 2) .. +7 and
  // channels 16 warp + 8 (m % 2) .. +7: this thread addresses one 16-byte
  // chunk of one pixel row
  const int m_px = 8 * ((lane >> 3) >> 1) + (lane & 7), m_chunk = 2 * warp + ((lane >> 3) & 1);
#pragma unroll
  for (int jj = 0; jj < R / 8; ++jj) {
    const int row = (16 * jj + m_px) * pstride + poff;
    const uint32_t addr = buf + row * 128 + ((m_chunk ^ (row & 7)) << 4);
    uint32_t res[4] = {0u, 0u, 0u, 0u}, out[4];
    if (EPI == kResidual || EPI == kMaskDb) ldmatrix_x4_trans(res, addr);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int j = 2 * jj + (m >> 1), i = m & 1;
      float v0 = d[4 * j + 2 * i], v1 = d[4 * j + 2 * i + 1];
      if (EPI == kResidual) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&res[m]));
        v0 += f.x;
        v1 += f.y;
      } else if (EPI == kMaskDb) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&res[m]));
        v0 = f.x > 0.f ? v0 : 0.f;
        v1 = f.y > 0.f ? v1 : 0.f;
      } else if (EPI != kRound) {
        v0 += bv[i];
        v1 += bv[i];
        v0 = v0 < 0.f ? 0.f : v0;   // keeps NaN, like torch.relu
        v1 = v1 < 0.f ? 0.f : v1;
      }
      const __nv_bfloat162 h2 = __floats2bfloat162_rn(v0, v1);
      if (EPI == kMaskDb) {
        const float2 r = __bfloat1622float2(h2);
        sum[i] += r.x + r.y;
      }
      out[m] = *reinterpret_cast<const uint32_t*>(&h2);
    }
    stmatrix_x4_trans(addr, out);
  }
}

// wgmma descriptor of a K-major operand with the 128-byte swizzle: rows of
// 128 bytes, 8-row groups 1024 bytes apart (SBO); LBO is unused for this
// layout. The swizzle is applied to the address each row and 16-byte chunk
// resolves to, so a start inside an atom (dx rows, or 32-byte k-steps) reads
// the same swizzled data from there, with the base offset (bits 49-51) at 0:
// the atoms themselves are 1024-byte aligned. (Setting it to the start's
// bits 7-9 made taps dx = 1, 2 read the wrong channels on the card.)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)64 << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving accesses of the accumulator across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Wait until at most N of this warpgroup's committed wgmma groups are
// pending (they retire in order).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x 128 f32, the warpgroup's fragment) = A * B + (accumulate ? d : 0);
// A 64 x 16 and B 16 x 128 bf16 from shared memory, both K-major.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64 f32) = A * B + (accumulate ? d : 0); A 64 x 16 and B 16 x 64.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db,
                                                int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// The 36 products of one output row-run whose input rows y - 1, y, y + 1
// are ring loads i, i + 1, i + 2: D = sum over taps and 16-channel K steps,
// in that order, of W[tap] x the ring row started dx pixels in. NARROW_: the
// m64n64k16 products on the first 64 pixels, into a 32-register accumulator
// that gets what the first 32 registers of the m64n128k16 products get for
// those pixels (the same fragment positions, and the same sums). One straight
// pipeline stage, from the fence to the wait, with no branch in it.
template <bool NARROW_, int N>
__device__ __forceinline__ void row_products(float (&d)[N], uint32_t s_w, uint32_t s_ring,
                                             int i) {
  static_assert(N == (NARROW_ ? 32 : 64), "the product's accumulator");
  wgmma_fence();
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const uint32_t row = s_ring + ((i + dy) % DEPTH) * SLOT_BYTES;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const uint32_t a0 = s_w + (dy * 3 + dx) * TAP_BYTES;
      const uint32_t b0 = row + dx * ROW_BYTES;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if constexpr (NARROW_)
          wgmma_m64n64k16(d, sw128_desc(a0 + kk * 32), sw128_desc(b0 + kk * 32),
                          (dy | dx | kk) != 0);
        else
          wgmma_m64n128k16(d, sw128_desc(a0 + kk * 32), sw128_desc(b0 + kk * 32),
                           (dy | dx | kk) != 0);
      }
    }
  }
  wgmma_commit();
  wgmma_wait_all();
}

// ---------------------------------------------------------- thread-block clusters

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of the cluster that has not exited arrives, then waits for
// the others (release / acquire at cluster scope).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// Arrive on the barrier at the same shared-memory offset in CTA `rank` of
// the cluster (this CTA's own included).
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t rank) {
  asm volatile(
      "{\n .reg .b32 remote;\n mapa.shared::cluster.u32 remote, %0, %1;\n"
      " mbarrier.arrive.release.cluster.shared::cluster.b64 _, [remote];\n}\n"
      ::"r"(bar), "r"(rank) : "memory");
}

// mbar_wait for a barrier that CTAs of the cluster arrive on (acquire at
// cluster scope); traps after ~2^34 clocks like mbar_wait.
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  uint32_t done;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (!done && clock64() - t0 > (1ll << 34)) __trap();
  } while (!done);
}

// TMA load of a box into the same shared-memory offset of every CTA in
// `mask` (bit r: cluster rank r); each destination's barrier at `bar`'s
// offset receives the box's bytes.
__device__ __forceinline__ void tma_load_4d_multicast(uint32_t dst, const CUtensorMap* map, int c0,
                                                      int c1, int c2, int c3, uint32_t bar,
                                                      uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%2, %3, %4, %5}], [%6], %7;\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(bar), "h"(mask) : "memory");
}

__device__ __forceinline__ void named_bar(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The first row-run of CTA `cta` of `grid` in the balanced schedule (see
// the header): row-run u is row u % H of column u / H, column c strip
// c % strips of image c / strips. A row-run costs FULL_COST, a narrow one
// narrow_cost; CTA i starts at the first row-run whose cost before it
// reaches floor(total x i / grid), so cta = grid gives the end
// (conv_tile.py's _balanced_start).
__device__ __forceinline__ long long balanced_start(int B, int H, int W, int grid, int cta,
                                                    int narrow_cost) {
  const int strips = (W + NPIX - 1) / NPIX;
  const int last = W - (strips - 1) * NPIX <= NARROW ? narrow_cost : FULL_COST;
  const long long per_image = (long long)H * (FULL_COST * (strips - 1) + last);
  const long long t = (long long)B * per_image * cta / grid;
  const long long b = t / per_image, rem = t - b * per_image;
  const long long s = min(rem / ((long long)FULL_COST * H), (long long)strips - 1);
  const int c = s == strips - 1 ? last : FULL_COST;
  return (b * strips + s) * H + (rem - s * FULL_COST * H + c - 1) / c;
}

// The row-runs [u0, u1) of this CTA (see balanced_start): a band of the
// banded plan (rows_per_cta > 0), or a range of the balanced schedule
// whose narrow row-runs cost narrow_cost.
__device__ __forceinline__ void cta_range(int B, int H, int W, int rows_per_cta, int narrow_cost,
                                          long long& u0, long long& u1) {
  if (rows_per_cta > 0) {
    const int bands = (H + rows_per_cta - 1) / rows_per_cta;
    const int y0 = (blockIdx.x % bands) * rows_per_cta;
    u0 = (long long)(blockIdx.x / bands) * H + y0;
    u1 = u0 + min(rows_per_cta, H - y0);
  } else {
    u0 = balanced_start(B, H, W, gridDim.x, blockIdx.x, narrow_cost);
    u1 = balanced_start(B, H, W, gridDim.x, blockIdx.x + 1, narrow_cost);
  }
}

// One segment of a CTA's range: rows y0 .. y0 + n - 1 of image b, columns
// x0 .. x0 + NPIX - 1; the range's next row-run is u.
struct Segment {
  int b, x0, y0, n;
};

__device__ __forceinline__ Segment next_segment(long long& u, long long u1, int H, int strips) {
  const long long col = u / H;
  Segment g;
  g.y0 = (int)(u - col * H);
  g.n = (int)min((long long)(H - g.y0), u1 - u);
  g.b = (int)(col / strips);
  g.x0 = (int)(col % strips) * NPIX;
  u += g.n;
  return g;
}

// One conv layer over a (B, H, W, 64) bf16 NHWC tensor: src_map (boxes of
// BOX_W pixels) is the input, out_map (boxes of NPIX pixels) the output, and
// for kResidual also the residual; aux_map (boxes of NPIX pixels) the mask
// of kMaskDb. w_map covers the packed weight stack as rows [l][tap][co] of
// 64 ci; the layer's 576 rows start at w_row0. bias (64 f32) is read by
// kBiasRelu only; kMaskDb writes 64 f32 at partials + 64 * blockIdx.x. The
// grid is B * strips * ceil(H / rows_per_cta) CTAs, one band each, or, with
// rows_per_cta 0, any number of CTAs of the balanced schedule; image b is
// batch coordinate b + in_b0 (b + out_b0, b + aux_b0) of src_map (out_map,
// aux_map). RAGGED: the launch's last strip holds at most NARROW columns of
// the image (narrow_strip), which its row-runs compute with the narrow
// product and the balanced schedule charges NARROW_COST; a launch without
// one runs the instantiation that has no narrow product's code.
template <int EPI, bool RAGGED>
__global__ void __launch_bounds__(NTHREADS, 1)
conv3x3_wgmma(const __grid_constant__ CUtensorMap src_map,
              const __grid_constant__ CUtensorMap out_map,
              const __grid_constant__ CUtensorMap aux_map,
              const __grid_constant__ CUtensorMap w_map, int w_row0,
              const float* __restrict__ bias, float* __restrict__ partials, int B, int H,
              int W, int rows_per_cta, int in_b0, int out_b0, int aux_b0) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // the swizzle atoms need 1024-B alignment
  const uint32_t s_w = base;
  const uint32_t s_ring = base + W_BYTES;
  const uint32_t s_out = s_ring + DEPTH * SLOT_BYTES;
  const uint32_t bars = s_out + NCONS * OUT_BYTES;
  auto full = [&](int i) { return bars + 8u * i; };
  auto empty = [&](int i) { return bars + 8u * (DEPTH + i); };
  const uint32_t wbar = bars + 8u * 2 * DEPTH;
  auto rbar = [&](int q) { return bars + 8u * (2 * DEPTH + 1 + q); };

  const int strips = (W + NPIX - 1) / NPIX;
  long long u0, u1;
  cta_range(B, H, W, rows_per_cta, RAGGED ? NARROW_COST : FULL_COST, u0, u1);
  const int tid = threadIdx.x;

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
  // programmatic dependent launch: the next layer's CTAs may start as this
  // grid's CTAs leave their SMs and load their weights; every read of this
  // layer's input and every write of its output waits for the previous grid
  // (griddepcontrol.wait; a no-op in a launch without the attribute)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  if (tid >= NCONS * 128) {
    // producer: the weights once, then each segment's input rows y0 - 1 ..
    // y0 + n; i counts the ring's loads over the segments
    if (tid == NCONS * 128) {
      mbar_expect_tx(wbar, W_BYTES);
      for (int t = 0; t < 9; ++t) tma_load_2d(s_w + t * TAP_BYTES, &w_map, 0, w_row0 + t * CH, wbar);
      asm volatile("griddepcontrol.wait;\n" ::: "memory");
      int i = 0;
      for (long long u = u0; u < u1;) {
        const Segment g = next_segment(u, u1, H, strips);
        for (int k = 0; k < g.n + 2; ++k, ++i) {
          const int slot = i % DEPTH;
          if (i >= DEPTH) mbar_wait(empty(slot), (i / DEPTH - 1) & 1);
          mbar_expect_tx(full(slot), BOX_BYTES);
          tma_load_4d(s_ring + slot * SLOT_BYTES, &src_map, 0, g.x0 - 1, g.y0 - 1 + k,
                      g.b + in_b0, full(slot));
        }
      }
    }
    return;
  }

  // consumer warpgroup q; thread (warp, lane) holds output channels
  // 16 warp + lane / 4 (+ 8) at pixels 8 j + 2 (lane % 4) (+ 1) of a row-run
  const int q = tid >> 7, wtid = tid & 127, warp = wtid >> 5, lane = tid & 31;
  const uint32_t s_o = s_out + q * OUT_BYTES;
  float bv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    bv[i] = EPI == kBiasRelu ? __ldg(bias + 16 * warp + (lane >> 2) + 8 * i) : 0.f;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");   // before the residual and the stores
  mbar_wait(wbar, 0);

  float sum[2] = {0.f, 0.f};   // kMaskDb: the written values of the thread's two channels
  // the full and the narrow product's accumulators, apart: sharing d's first
  // 32 registers, the ragged instantiations' wgmma pipeline was serialized by
  // ptxas at some costs of the balancer (C7511, register resources)
  float d[64], dn[32];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) dn[i] = 0.f;
  // rows: the CTA's rows before this segment; loads: its ring loads before
  // this segment; next: this warpgroup's first load not yet released
  int rows = 0, loads = 0, next = 0;
  for (long long u = u0; u < u1;) {
    const Segment g = next_segment(u, u1, H, strips);
    const bool narrow = RAGGED && W - g.x0 <= NARROW;
    for (int r = (q ^ rows) & 1; r < g.n; r += NCONS) {
      const int y = g.y0 + r;
      const int i = loads + r;   // input rows y - 1, y, y + 1 are ring loads i, i + 1, i + 2
      const int k = (rows + r) >> 1;   // this warpgroup's rows before this one
      // the output buffer is free once this warpgroup's previous store has
      // read it; the residual (mask) of this row-run is loaded into it meanwhile
      if (wtid == 0) {
        tma_store_wait_read();
        if (EPI == kResidual || EPI == kMaskDb) {
          mbar_expect_tx(rbar(q), OUT_BYTES);
          if (EPI == kResidual)
            tma_load_4d(s_o, &out_map, 0, g.x0, y, g.b + out_b0, rbar(q));
          else
            tma_load_4d(s_o, &aux_map, 0, g.x0, y, g.b + aux_b0, rbar(q));
        }
      }
      // the loads this warpgroup does not read, waited for and released in
      // order: ring load DEPTH ahead of one cannot land before its release
      for (; next < i; ++next) {
        mbar_wait(full(next % DEPTH), (next / DEPTH) & 1);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(next % DEPTH));
      }
#pragma unroll
      for (int j = 0; j < 3; ++j) mbar_wait(full((i + j) % DEPTH), ((i + j) / DEPTH) & 1);
      if (narrow) {
        fence_acc(dn);
        row_products<true>(dn, s_w, s_ring, i);
        fence_acc(dn);
      } else {
        fence_acc(d);
        row_products<false>(d, s_w, s_ring, i);
        fence_acc(d);
      }
      // release ring rows y - 1 and y: this warpgroup's next row reads y + 1 on
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(empty(i % DEPTH));
        mbar_arrive(empty((i + 1) % DEPTH));
      }
      next = i + 2;
      if (EPI == kResidual || EPI == kMaskDb)
        mbar_wait(rbar(q), k & 1);   // the residual is in (and the store has read)
      else
        named_bar(1 + q, 128);       // the previous store has read the buffer

      // epilogue in registers, one bf16 rounding a value, into the buffer by
      // stmatrix (transposed: a pixel's channels contiguous)
      if (narrow)
        store_fragment<EPI>(dn, s_o, 1, 0, bv, sum);
      else
        store_fragment<EPI>(d, s_o, 1, 0, bv, sum);
      fence_async_shared();
      named_bar(1 + q, 128);
      if (wtid == 0) tma_store_4d(&out_map, s_o, 0, g.x0, y, g.b + out_b0);   // clipped at the edge
    }
    rows += g.n;
    loads += g.n + 2;
  }
  if (wtid == 0) tma_store_wait_all();
  if (EPI == kMaskDb) {
    // the CTA's sums a channel, in a fixed order (no atomics): over the
    // thread's pixels and rows (above), the 4 lanes of a channel, then the
    // two warpgroups, through their output buffers, which the completed
    // stores have freed
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
    }
    named_bar(1 + q, 128);
    auto red = [&](int k) {   // warpgroup k's 64 sums, in its output buffer
      return reinterpret_cast<float*>(smem_raw + (s_out + k * OUT_BYTES - raw));
    };
    if ((lane & 3) == 0) {
      red(q)[16 * warp + (lane >> 2)] = sum[0];
      red(q)[16 * warp + (lane >> 2) + 8] = sum[1];
    }
    named_bar(1 + NCONS, NCONS * 128);
    if (q == 0 && wtid < CH) {
      float t = 0.f;
#pragma unroll
      for (int k = 0; k < NCONS; ++k) t += red(k)[wtid];
      partials[blockIdx.x * CH + wtid] = t;
    }
  }
}

// ---------------------------------------------------------------- host side

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The arguments a map is encoded from; the map is a function of them alone.
struct MapKey {
  const void* ptr;
  int rank;
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4];
};

// Maps encoded before, by their arguments: an encode costs host time a map,
// and most maps come back call after call (the packed weights DRUNet keeps,
// the activation buffers the caching allocator hands out again). A map that
// comes back serves as it was encoded; the table keeps the last MEMO maps.
constexpr int MEMO = 64;
struct MapMemo {
  std::mutex mu;
  MapKey keys[MEMO];
  CUtensorMap maps[MEMO];
  int size = 0, next = 0;
};

inline MapMemo& map_memo() {
  static MapMemo memo;
  return memo;
}

inline cudaError_t encode(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
                          const cuuint64_t* strides, const cuuint32_t* box) {
  MapKey key;
  memset(&key, 0, sizeof key);   // padding too: keys compare as bytes
  key.ptr = ptr;
  key.rank = rank;
  for (int i = 0; i < rank; ++i) {
    key.dims[i] = dims[i];
    key.box[i] = box[i];
    if (i + 1 < rank) key.strides[i] = strides[i];
  }
  MapMemo& memo = map_memo();
  {
    std::lock_guard<std::mutex> lock(memo.mu);
    for (int i = 0; i < memo.size; ++i)
      if (memcmp(&memo.keys[i], &key, sizeof key) == 0) {
        *map = memo.maps[i];
        return cudaSuccess;
      }
  }
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims,
                        strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);   // out of bounds reads as zero
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  std::lock_guard<std::mutex> lock(memo.mu);
  memo.keys[memo.next] = key;
  memo.maps[memo.next] = *map;
  memo.next = (memo.next + 1) % MEMO;
  if (memo.size < MEMO) ++memo.size;
  return cudaSuccess;
}

// The map of a (B, H, W, C) bf16 NHWC activation: boxes of box_w pixels x 64
// channels (one 128-byte swizzle row a pixel; a box at channel c0 reads
// channels c0 .. c0 + 63, zero past C).
inline cudaError_t act_map_c(CUtensorMap* map, const void* ptr, int C, int B, int H, int W,
                             int box_w) {
  const cuuint64_t row = 2ull * C;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {row, (cuuint64_t)W * row, (cuuint64_t)H * W * row};
  const cuuint32_t box[4] = {CH, (cuuint32_t)box_w, 1, 1};
  return encode(map, ptr, 4, dims, strides, box);
}

// The input and the output map of each of n (B, H, W, C) activation
// buffers: boxes of box_in pixels (a layer's haloed input rows) and box_out
// (its output and residual row-runs).
inline cudaError_t act_maps(CUtensorMap* in, CUtensorMap* out, const void* const* ptrs, int n,
                            int C, int B, int H, int W, int box_in, int box_out) {
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < n && err == cudaSuccess; ++i) {
    err = act_map_c(&in[i], ptrs[i], C, B, H, W, box_in);
    if (err == cudaSuccess) err = act_map_c(&out[i], ptrs[i], C, B, H, W, box_out);
  }
  return err;
}

// The map of a (rows, cols) bf16 row-major matrix of packed weights: boxes
// of 64 rows x 64 columns (a box at column c0 reads columns c0 .. c0 + 63,
// zero past cols).
inline cudaError_t matrix_map(CUtensorMap* map, const void* ptr, int cols, long long rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {2ull * cols};
  const cuuint32_t box[2] = {CH, CH};
  return encode(map, ptr, 2, dims, strides, box);
}

// The launch plan the Python wrapper computes (conv_tile_plan in
// ops/kernels/conv_tile.py): checked here against the tile's constants and
// the shape, so that the two cannot drift apart. rows_per_cta 0: the
// balanced schedule (the 64-channel tile only).
struct Plan {
  int strip, depth, smem_bytes, rows_per_cta, grid;
};

// A conv tile's plan against its constants: strips of npix columns, depth
// ring slots, smem bytes, a band of rows to each cluster of `cluster` CTAs;
// or, where the tile has it (`balanced`), the balanced schedule
// (rows_per_cta 0) over 1 to B * strips * H CTAs.
inline cudaError_t check_tile_plan(const Plan& p, int npix, int depth, int smem, int cluster,
                                   int B, int H, int W, bool balanced = false) {
  if (p.strip != npix || p.depth != depth || p.smem_bytes != smem || B < 1 || H < 1 || W < 1)
    return cudaErrorInvalidValue;
  const long long strips = (W + npix - 1) / npix;
  if (balanced && p.rows_per_cta == 0)
    return p.grid >= 1 && p.grid <= B * strips * H ? cudaSuccess : cudaErrorInvalidValue;
  if (p.rows_per_cta < 1) return cudaErrorInvalidValue;
  const long long bands = (H + p.rows_per_cta - 1) / p.rows_per_cta;
  return (long long)p.grid == cluster * B * strips * bands ? cudaSuccess : cudaErrorInvalidValue;
}

inline cudaError_t check_plan(const Plan& p, int B, int H, int W) {
  return check_tile_plan(p, NPIX, DEPTH, SMEM_BYTES, 1, B, H, W, true);
}

// Allow `Kernel` `bytes` of dynamic shared memory (above the 48 KB default),
// once a device: the attribute stays set, and the call costs host time at
// B = 1. Every wgmma kernel here goes through it.
template <auto Kernel>
cudaError_t allow_smem_once(int bytes) {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

// Whether a launch over width W takes the narrow product on its last strip
// (conv3x3_wgmma's RAGGED): a strip of at most NARROW columns, and not under
// kMaskDb, which keeps the full product (with both products in its function
// ptxas serializes the wgmma pipeline: C7511, register resources).
template <int EPI>
inline bool narrow_strip(int W) {
  return EPI != kMaskDb && W % NPIX != 0 && W % NPIX <= NARROW;
}

template <int EPI>
cudaError_t allow_smem() {
  cudaError_t err = allow_smem_once<conv3x3_wgmma<EPI, false>>(SMEM_BYTES);
  if constexpr (EPI != kMaskDb)
    if (err == cudaSuccess) err = allow_smem_once<conv3x3_wgmma<EPI, true>>(SMEM_BYTES);
  return err;
}

// The configuration of a launch of `grid` CTAs on `s` with programmatic
// dependent launch (attr[0]): it may start while the previous kernel on `s`
// finishes. Every wgmma kernel here reads and writes activations only after
// griddepcontrol.wait.
inline cudaLaunchConfig_t pdl_config(int grid, int threads, int smem, cudaStream_t s,
                                     cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The batch offsets of a launch's maps (see conv3x3_wgmma): image b is batch
// coordinate b + in of the input map, b + out of the output map, b + aux of
// the mask map.
struct Batch0 {
  int in = 0, out = 0, aux = 0;
};

// Launch one layer, with programmatic dependent launch (see conv3x3_wgmma).
// kMaskDb reads its mask through *aux and writes its sums to partials.
template <int EPI>
cudaError_t launch(const CUtensorMap& src, const CUtensorMap& out, const CUtensorMap& w,
                   int layer, const float* bias, int B, int H, int W, const Plan& p, cudaStream_t s,
                   const Batch0& b0 = Batch0{}, const CUtensorMap* aux = nullptr,
                   float* partials = nullptr) {
  if (EPI == kMaskDb && (aux == nullptr || partials == nullptr)) return cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = pdl_config(p.grid, NTHREADS, SMEM_BYTES, s, attr);
  auto kernel = conv3x3_wgmma<EPI, false>;
  if constexpr (EPI != kMaskDb)
    if (narrow_strip<EPI>(W)) kernel = conv3x3_wgmma<EPI, true>;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, src, out, aux != nullptr ? *aux : out, w, layer * 9 * CH, bias, partials, B,
      H, W, p.rows_per_cta, b0.in, b0.out, b0.aux);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// A conv tile as the chain's host loop drives it (this one, or wg128::Tile
// for the 128-channel cluster tile): its channels, the box widths of a
// layer's input and output maps, a layer's rows in the packed weight stack,
// its plan check, its shared-memory opt-in and its launch of one layer (of a
// (B, H, W, channels) activation).
struct Tile64 {
  static constexpr int channels = CH;
  static constexpr int box_in = BOX_W;
  static constexpr int box_out = NPIX;
  static constexpr int layer_rows = 9 * CH;   // [tap][co][ci]
  static cudaError_t check(const Plan& p, int B, int H, int W) { return check_plan(p, B, H, W); }
  template <int EPI>
  static cudaError_t allow() {
    return allow_smem<EPI>();
  }
  template <int EPI>
  static cudaError_t launch(const CUtensorMap& src, const CUtensorMap& out, const CUtensorMap& w,
                            int layer, int B, int H, int W, const Plan& p, cudaStream_t s) {
    return wg::launch<EPI>(src, out, w, layer, nullptr, B, H, W, p, s);
  }
};

// R residual blocks h <- h + conv2(relu(conv1(h))) in place on `a` (B, H, W,
// C) bf16 on the tile `Tile`, with `t` (same shape) as scratch: 2R launches
// on `s`, conv1 reading `a` into `t`, conv2 reading `t` and adding into `a`
// in place. Writing into `a` in place is safe: within one launch `a` is read
// only as the residual of the row-runs a CTA writes, before it writes them.
// w1p/w2p: (R, layer_rows, C) bf16 packed by pack_weights. The plan is
// checked against the tile and the shape first. The chains of K1, K2/K3 and
// K4 (both scales) run through here.
template <class Tile>
cudaError_t resblocks(void* a, void* t, const void* w1p, const void* w2p, int B, int H, int W,
                      int R, const Plan& plan, cudaStream_t s) {
  cudaError_t err = Tile::check(plan, B, H, W);
  CUtensorMap in[2], out[2], map_w1, map_w2;   // a, t
  const void* bufs[2] = {a, t};
  const int C = Tile::channels;
  const long long rows = (long long)R * Tile::layer_rows;
  if (err == cudaSuccess)
    err = act_maps(in, out, bufs, 2, C, B, H, W, Tile::box_in, Tile::box_out);
  if (err == cudaSuccess) err = matrix_map(&map_w1, w1p, C, rows);
  if (err == cudaSuccess) err = matrix_map(&map_w2, w2p, C, rows);
  if (err == cudaSuccess) err = Tile::template allow<kRelu>();
  if (err == cudaSuccess) err = Tile::template allow<kResidual>();
  for (int r = 0; r < R && err == cudaSuccess; ++r) {
    err = Tile::template launch<kRelu>(in[0], out[1], map_w1, r, B, H, W, plan, s);
    if (err == cudaSuccess)   // conv2 reads t, and a as its residual and output
      err = Tile::template launch<kResidual>(in[1], out[0], map_w2, r, B, H, W, plan, s);
  }
  return err;
}

// A plan passed from Python as an int array: strip, depth, smem_bytes,
// rows_per_cta, grid.
inline Plan plan_at(const int* p) { return Plan{p[0], p[1], p[2], p[3], p[4]}; }

}  // namespace wg
}  // namespace
