// One 3x3 convolution at 128 channels, bf16 NHWC, on wgmma fed by TMA, in a
// thread-block cluster of two CTAs (sm_90a): the tile of DRUNet's scale-1
// chain inside the up tail (up_sandwich.cu, K4; the TPU kernel's
// `_layer_nhwc`, deepinv_tpu/ops/pallas/resblock_chain.py:425).
//
// The constraint. One layer's weights, 128 x 128 x 9 bf16, are 288 KB: more
// than the 227 KB of shared memory a CTA may have, so the 64-channel tile's
// design (conv3x3_wgmma.cuh: the layer's weights resident, one CTA all
// output channels) does not carry over. Here the two CTAs of a cluster split
// the 128 output channels: CTA rank r computes channels 64 r .. 64 r + 63 and
// keeps their 144 KB of weights resident (18 TMA boxes of 64 co x 64 ci, the
// packing of pack_weights at Co = 128: [(co / 64) 9 + tap][co % 64][ci]).
//
// The GEMM. For one output row-run of NPIX = 64 pixels:
//   M = the CTA's 64 output channels, A = W[rank, tap][:, 64 kb .. 64 kb + 63];
//   N = the 64 pixels, B = the haloed input row y + dy - 1 started dx pixels in;
//   K = the 128 input channels as two K-blocks of 64 (kb), each its own TMA
//       box and 128-byte swizzle atoms, 16 channels an instruction:
//       9 taps x 2 K-blocks x 4 = 72 wgmma.m64n64k16 an output row-run.
// A ring row is the two K-block boxes of 66 pixels x 64 channels, 8448
// bytes each, back to back; tap (dy, dx) of K-block kb is the B descriptor
// started dx * 128 bytes into that box, as in the 64-channel tile. TMA and
// wgmma both take the 128-byte swizzle from the shared-memory address bits,
// so a box need not start at a 1024-byte boundary (the descriptors' base
// offset stays 0): on the card, boxes packed this way gave the same values
// as 1024-aligned ones (chip_smoke.py holds each tap and K-block alone).
//
// The cluster shares the input. Both CTAs need the same ring rows; CTA r's
// producer loads K-block r of each row once and multicasts it into the same
// slot of both CTAs, so each row crosses from L2 once. Each CTA's full
// barrier expects the whole row (both halves); a slot is free again only
// when the consumers of both CTAs have released it, so each consumer warp
// arrives on the empty barrier of its own CTA and of its peer, which
// therefore counts CLUSTER * NCONS * 4 arrivals. The cluster synchronises
// after the barriers are initialised and before the CTAs exit (no remote
// arrival may reach a CTA that has left).
//
// The ring has 4 slots: 144 KB of weights + 4 x 16.5 KB of ring + 2 x 8 KB of
// output row-runs + barriers = 231,680 of the 232,448 bytes (with each box
// 1024-aligned, or an alignment slack, only 3 slots fit, and the card ran
// the scale-1 chain ~1.4x slower at B = 8). Two consumer warpgroups take
// alternate output rows (q, q + 2, ...), which need four ring rows between
// them, so a warpgroup commits its 72 products as three wgmma groups by dy
// and releases ring row y - 1 (read by no later row) as soon as the dy = 0
// group has retired; the producer fetches the next row meanwhile. Row y
// is released after the whole row-run (the warpgroup's next row starts at
// y + 1). Each warpgroup waits for the loads of a slot in order: a parity
// wait two phases ahead passes at once (on the card, with 3 slots, the
// second warpgroup's first row read slot 0 as load 3 while load 0 was still
// in flight). So that warpgroup first waits for ring row y0 - 1 (load 0)
// and releases it, standing for the absent row above the band; the next
// load of slot 0 cannot land before. tests/test_torch_conv_tile128.py
// replays the protocol with the barriers' parity waits.
//
// Epilogues (as the 64-channel tile; each CTA writes its 64 channels of a
// pixel as one TMA store box at channel offset 64 r, and kResidual first
// loads the residual box at the same place):
//   kRelu:      dst = bf16(relu(conv(src)))
//   kResidual:  dst = bf16(dst + conv(src))
//
// What bounds it. One wgmma.m64n64k16 reads 2 KB of A and 2 KB of B for 131
// kFLOP, 32 FLOP a byte of shared memory: at the ~32 the tensor cores need,
// so the products run near the shared-memory rate. At the bench size (128²
// at 128 channels, 4.8 GFLOP a layer) the activations (4 MB) stay in L2 at
// B = 1; at B = 8 (33.5 MB each) a layer reads and writes ~67 MB of device
// memory, ~20 us at 3.35 TB/s against ~39 us of products at the bf16 peak.
// The launch plan is conv128_tile_plan (ops/kernels/conv_tile.py), checked
// here by Tile::check.

#pragma once

#include "conv3x3_wgmma.cuh"

namespace {
namespace wg128 {

constexpr int CI = 128;                 // input and output channels of a layer
constexpr int NPIX = 64;                // output pixels of a row-run: the wgmma N
constexpr int BOX_W = NPIX + 2;         // haloed input pixels of a ring row
constexpr int KB = 2;                   // K-blocks: the 64-channel halves of a pixel
constexpr int CLUSTER = 2;              // CTAs of a cluster: the output-channel halves
constexpr int DEPTH = 4;                // ring slots
constexpr int ROW_BYTES = 128;          // one K-block of a pixel (or of a weight row)
constexpr int TAP_BYTES = 64 * 64 * 2;  // one tap's weights of one K-block
constexpr int W_BYTES = 9 * KB * TAP_BYTES;                  // a CTA's weights of a layer
constexpr int BOX_BYTES = BOX_W * ROW_BYTES;                 // one K-block of a ring row
constexpr int HALF_BYTES = BOX_BYTES;                        // (not 1024-B aligned)
constexpr int SLOT_BYTES = KB * HALF_BYTES;                  // one ring row
constexpr int OUT_BYTES = NPIX * ROW_BYTES;                  // a consumer's output row-run
constexpr int NCONS = 2;                // consumer warpgroups
constexpr int NTHREADS = NCONS * 128 + 32;   // and one producer warp
constexpr int BAR_BYTES = 256;
constexpr int SMEM_BYTES = W_BYTES + DEPTH * SLOT_BYTES + NCONS * OUT_BYTES + BAR_BYTES;
static_assert(SMEM_BYTES <= 232448, "the tile exceeds an SM's 227 KB of shared memory");
static_assert(BOX_W <= 256, "a TMA box dimension is at most 256");
static_assert((2 * DEPTH + 1 + NCONS) * 8 <= BAR_BYTES, "the barriers exceed their space");

// One layer over (B, H, W, 128) bf16 NHWC: src_map (boxes of 64 channels x
// BOX_W pixels) is the input, out_map (64 x NPIX) the output and, for
// kResidual, the residual. w_map covers the packed weight stack as rows
// [l][co / 64][tap][co % 64] of 128 ci; the layer's rows start at w_row0.
// The grid is CLUSTER * B * strips * ceil(H / rows_per_cta) CTAs, clusters
// of CLUSTER along x, one band a cluster.
template <int EPI>
__global__ void __launch_bounds__(NTHREADS, 1)
conv3x3_c128_wgmma(const __grid_constant__ CUtensorMap src_map,
                   const __grid_constant__ CUtensorMap out_map,
                   const __grid_constant__ CUtensorMap w_map, int w_row0, int H, int strips,
                   int rows_per_cta) {
  using namespace wg;   // the primitives (the enum is named wg:: where a file has two)
  extern __shared__ unsigned char smem_raw[];
  // the same offset in both CTAs: multicast loads and remote arrivals address
  // the peer's buffers and barriers by this CTA's offsets. No alignment
  // slack fits beside four ring slots: the base (the start of the CTA's
  // dynamic shared memory, the kernel having no static shared memory) must
  // be 1024-byte aligned for the weights' swizzle atoms; a launch where it
  // is not fails here rather than computing wrong values
  const uint32_t base = smem_u32(smem_raw);
  if (base & 1023u) __trap();
  const uint32_t s_w = base;
  const uint32_t s_ring = base + W_BYTES;
  const uint32_t s_out = s_ring + DEPTH * SLOT_BYTES;
  const uint32_t bars = s_out + NCONS * OUT_BYTES;
  auto full = [&](int i) { return bars + 8u * i; };
  auto empty = [&](int i) { return bars + 8u * (DEPTH + i); };
  const uint32_t wbar = bars + 8u * 2 * DEPTH;
  auto rbar = [&](int q) { return bars + 8u * (2 * DEPTH + 1 + q); };

  const uint32_t rank = cluster_ctarank();
  const int unit = blockIdx.x / CLUSTER;
  const int bands = (H + rows_per_cta - 1) / rows_per_cta;
  const int col = unit / bands;
  const int b = col / strips;
  const int x0 = (col % strips) * NPIX;
  const int y0 = (unit % bands) * rows_per_cta;
  const int nrows = min(rows_per_cta, H - y0);
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int i = 0; i < DEPTH; ++i) {
      mbar_init(full(i), 1);
      mbar_init(empty(i), CLUSTER * NCONS * 4);   // each consumer warp of both CTAs
    }
    mbar_init(wbar, 1);
    for (int q = 0; q < NCONS; ++q) mbar_init(rbar(q), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();   // the peer's barriers exist before any multicast or remote arrival
  // programmatic dependent launch, as in conv3x3_wgmma
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  if (tid >= NCONS * 128) {
    // producer: this CTA's weights once, then K-block `rank` of input rows
    // y0 - 1 .. y0 + nrows into both CTAs
    if (tid == NCONS * 128) {
      mbar_expect_tx(wbar, W_BYTES);
      for (int t = 0; t < 9; ++t)
        for (int kb = 0; kb < KB; ++kb)
          tma_load_2d(s_w + (t * KB + kb) * TAP_BYTES, &w_map, 64 * kb,
                      w_row0 + ((int)rank * 9 + t) * 64, wbar);
      asm volatile("griddepcontrol.wait;\n" ::: "memory");
      for (int i = 0; i < nrows + 2; ++i) {
        const int slot = i % DEPTH;
        // free in both CTAs: the peer's consumers arrive here too
        if (i >= DEPTH) mbar_wait_cluster(empty(slot), (i / DEPTH - 1) & 1);
        mbar_expect_tx(full(slot), KB * BOX_BYTES);   // both halves: ours and the peer's
        tma_load_4d_multicast(s_ring + slot * SLOT_BYTES + rank * HALF_BYTES, &src_map,
                              64 * (int)rank, x0 - 1, y0 - 1 + i, b, full(slot),
                              (uint16_t)((1u << CLUSTER) - 1));
      }
    }
  } else {
    // consumer warpgroup q; thread (warp, lane) holds output channels
    // 16 warp + lane / 4 (+ 8) at pixels 8 j + 2 (lane % 4) (+ 1) of a row-run
    const int q = tid >> 7, wtid = tid & 127, lane = tid & 31;
    const uint32_t s_o = s_out + q * OUT_BYTES;
    const float no_bias[2] = {0.f, 0.f};
    // a ring slot is released in both CTAs, by each consumer warp
    auto release = [&](int slot) {
      for (uint32_t c = 0; c < CLUSTER; ++c) mbar_arrive_cluster(empty(slot), c);
    };
    asm volatile("griddepcontrol.wait;\n" ::: "memory");   // before the residual and the stores
    mbar_wait(wbar, 0);

    float d[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) d[i] = 0.f;
    for (int r = q; r < nrows; r += NCONS) {
      const int y = y0 + r;
      if (wtid == 0) {
        tma_store_wait_read();
        if (EPI == wg::kResidual) {
          mbar_expect_tx(rbar(q), OUT_BYTES);
          tma_load_4d(s_o, &out_map, 64 * (int)rank, x0, y, b, rbar(q));
        }
      }
      // input rows y - 1, y, y + 1 are ring loads r, r + 1, r + 2. A parity
      // wait cannot tell a phase from the one two ahead of it, so each
      // warpgroup waits for the loads of a slot in order: warpgroup 1 never
      // reads load 0, so before its first row it waits for it and releases
      // it (for the absent row above the band); load DEPTH, the next in slot
      // 0, which it reads, cannot land before
      if (r == 1) {
        mbar_wait(full(0), 0);
        __syncwarp();
        if (lane == 0) release(0);
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) mbar_wait(full((r + k) % DEPTH), ((r + k) / DEPTH) & 1);
      fence_acc(d);
      wgmma_fence();
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const uint32_t row = s_ring + ((r + dy) % DEPTH) * SLOT_BYTES;
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
#pragma unroll
          for (int kb = 0; kb < KB; ++kb) {
            const uint32_t a0 = s_w + ((dy * 3 + dx) * KB + kb) * TAP_BYTES;
            const uint32_t b0 = row + kb * HALF_BYTES + dx * ROW_BYTES;
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_m64n64k16(d, sw128_desc(a0 + kk * 32), sw128_desc(b0 + kk * 32),
                              (dy | dx | kb | kk) != 0);
          }
        wgmma_commit();   // one group a dy
      }
      // the dy = 0 group has retired: ring row y - 1 is read by no later row
      wgmma_wait<2>();
      __syncwarp();
      if (lane == 0) release(r % DEPTH);
      wgmma_wait<0>();
      fence_acc(d);
      // ring row y: this warpgroup's next row starts at y + 1
      __syncwarp();
      if (lane == 0) release((r + 1) % DEPTH);
      if (EPI == wg::kResidual)
        mbar_wait(rbar(q), (r >> 1) & 1);   // the residual is in (and the store has read)
      else
        named_bar(1 + q, 128);              // the previous store has read the buffer

      // epilogue in registers, one bf16 rounding a value, into the buffer by
      // stmatrix (transposed: a pixel's channels contiguous)
      store_fragment<EPI>(d, s_o, 1, 0, no_bias);
      fence_async_shared();
      named_bar(1 + q, 128);
      if (wtid == 0) tma_store_4d(&out_map, s_o, 64 * (int)rank, x0, y, b);   // clipped at the edge
    }
    if (wtid == 0) tma_store_wait_all();
  }
  // no CTA leaves while its peer may still arrive on its barriers
  cluster_sync();
}

// ---------------------------------------------------------------- host side

template <int EPI>
cudaError_t allow_smem() {
  return wg::allow_smem_once<conv3x3_c128_wgmma<EPI>>(SMEM_BYTES);
}

// A launch of `grid` CTAs on `s` with programmatic dependent launch
// (attr[0]) in clusters of CLUSTER (attr[1]).
inline cudaLaunchConfig_t config(int grid, cudaStream_t s, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = wg::pdl_config(grid, NTHREADS, SMEM_BYTES, s, attr);
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = CLUSTER;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = 1;
  cfg.numAttrs = 2;
  return cfg;
}

// How many clusters of the tile the device holds at once
// (cudaOccupancyMaxActiveClusters): the plan keeps its grid within them.
inline cudaError_t max_clusters(int* count) {
  cudaError_t err = allow_smem<wg::kRelu>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg = config(CLUSTER, 0, attr);
  return cudaOccupancyMaxActiveClusters(count, (const void*)conv3x3_c128_wgmma<wg::kRelu>, &cfg);
}

template <int EPI>
cudaError_t launch(const CUtensorMap& src, const CUtensorMap& out, const CUtensorMap& w, int layer,
                   int H, int W, const wg::Plan& p, cudaStream_t s) {
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg = config(p.grid, s, attr);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, conv3x3_c128_wgmma<EPI>, src, out, w,
                                             layer * 18 * 64, H, (W + NPIX - 1) / NPIX,
                                             p.rows_per_cta);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The tile as wg::resblocks drives it (wg::resblocks<wg128::Tile>: R
// residual blocks in place on (B, H, W, 128) bf16, 2R cluster launches).
// The plan is conv128_tile_plan's: a band a cluster of CLUSTER CTAs. Packed
// weights: (R, 18, 64, 128) bf16 [r][(co / 64) 9 + tap][co % 64][ci].
struct Tile {
  static constexpr int channels = CI;
  static constexpr int box_in = BOX_W;
  static constexpr int box_out = NPIX;
  static constexpr int layer_rows = 18 * 64;
  static cudaError_t check(const wg::Plan& p, int B, int H, int W) {
    return wg::check_tile_plan(p, NPIX, DEPTH, SMEM_BYTES, CLUSTER, B, H, W);
  }
  template <int EPI>
  static cudaError_t allow() {
    return allow_smem<EPI>();
  }
  template <int EPI>
  static cudaError_t launch(const CUtensorMap& src, const CUtensorMap& out, const CUtensorMap& w,
                            int layer, int H, int W, const wg::Plan& p, cudaStream_t s) {
    return wg128::launch<EPI>(src, out, w, layer, H, W, p, s);
  }
};

}  // namespace wg128
}  // namespace
