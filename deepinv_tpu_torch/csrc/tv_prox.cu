// Chambolle total-variation prox, float32, for sm_90a: two hand-written
// kernels, a resident one (one launch per prox) and a global one.
//
// Replaces the Pallas TPU kernel `_kernel` (deepinv_tpu/ops/pallas/tv.py:53,
// launched by `_pallas_impl` :70). Per (H, W) plane it computes
//
//     xg = x / gamma                                        (once, tv.py:55-56)
//     n_iter times, Jacobi (every update from the old p), tau = 0.25:
//         u  = div p - xg
//         p <- (p + tau grad u) / (1 + tau |grad u|)
//     out = x - gamma div p
//
// with the TPU kernel's boundary conventions: grad is the forward difference,
// zero at the last row / column (tv.py:33-40), and div p = p[i] (i < H-1) -
// p[i-1] (i > 0) along each axis (tv.py:43-50). gamma is read per plane from
// device memory, gamma[plane * gamma_stride] (stride 0: one gamma for all), so
// a per-sample gamma runs here too (the TPU kernel takes one scalar and the
// JAX package sends a batch of gammas to the XLA loop, tv.py:104-113). IEEE
// division and sqrtf throughout (no fast math).
//
// What bounds it on an H100. The work is one read of x, one write of the
// output and ~17 float32 operations plus a sqrt per pixel per iteration: at
// 1 x 3 x 256^2 and n_iter = 100, 0.35 GFLOP, ~5 us at the 67 TFLOP/s float32
// (non-tensor) peak, against 1.6 MB of traffic, 0.5 us: operations bound it.
// The steps depend on each other, so a second floor sits under any design:
// n_iter barriers between the CTAs that share a plane.
//
// Resident variant (`tv_resident`). The TPU kernel keeps a plane's x and both
// dual components in VMEM for the whole loop (12 bytes a pixel: 768 KB for a
// 256^2 plane), more than the 227 KB of shared memory of one SM. Here one
// thread-block cluster holds one plane: CTA k of the cluster owns the band of
// rows [k band, (k+1) band) and keeps xg, ph and pw of its band in shared
// memory for all n_iter steps (a 256^2 plane in a cluster of 16: 55 KB a CTA;
// of 8: 103 KB). Global memory is touched twice, x in and out out: no state
// buffer, one launch a prox. Each step is
//   1. every lane computes the new (ph, pw) of its pixels into registers,
//      reading only its own CTA's shared memory;
//   2. __syncthreads (every read of the old p in this CTA is done), then the
//      lanes write the new p to shared memory and push the band's edge rows
//      into the neighbouring CTAs' halo rows through distributed shared
//      memory: the first row's ph and pw up (the CTA above needs them for u
//      one row below its band), the last row's ph down (div p of the CTA
//      below needs ph one row above its band);
//   3. a cluster barrier (release / acquire): the pushes and the local writes
//      are visible to the next step.
// The halo rows are double-buffered by the parity of the step: a CTA reads
// slot t & 1 in step t while its neighbours push slot (t + 1) & 1, and they
// push slot t & 1 again only after the barrier that ends step t, which it
// reaches after its reads. So one cluster barrier and one block barrier a
// step keep the Jacobi semantics. After the last barrier no CTA touches
// another's shared memory, so each may write its output and exit; a
// cluster.sync before the loop makes sure every CTA runs before the first
// push. A warp owns 31 columns x SEG rows of the band (its lane 31 computes u
// of the next column, so that u one column right comes from the next lane by
// __shfl_down_sync and no lane diverges); a lane walks its column down,
// computing u once a row and holding the new p of its SEG rows in registers
// across the block barrier (SEG 16 or 32 takes fewer threads, so more
// registers a thread). Full walks run without per-row branches; the halo row
// below the band sits in memory right after the band, so the walk's last row
// only changes its offset.
//
// What bounds the resident variant (measured by chip_smoke.py on an H100
// 80GB HBM3 at 700 W, PERF.md): instruction issue, not memory. A pixel-step
// is ~17 float operations, two IEEE divisions and a sqrt, each of the last
// three with a range check and a slow-path branch (a zero dividend, frequent
// in flat regions, is divided as 1 to stay off the slow path): ~3 us a step
// at 4096 pixels a CTA (1 x 3 x 256^2 in clusters of 16), of which the
// cluster barrier takes ~0.8 us (its release is a GPU-scope memory fence):
// 81 us of a 100-step prox, against the 5.3 us operations bound. The cluster
// size comes from the plan in ops/kernels/tv.py (`tv_plan`), which also
// checks that the band fits; the wrapper raises if the card cannot hold such
// a cluster.
//
// Global variant (`tv_step`, `tv_out`), for planes no cluster holds (the plan
// picks it by shape, e.g. 1024^2): the host loop of one C call issues n_iter
// launches of one fused stencil kernel over every pixel of every plane, then
// one output launch. The dual field ping-pongs between two global buffers the
// wrapper allocates (16 bytes a pixel with both buffers). Each block owns a
// 16 x 32 tile, computes u once per pixel of the tile plus one row and one
// column of halo into shared memory, then updates its pixels. Its launches
// (n_iter + 1 a prox) and the dual fields' round trips through L2 or HBM set
// its time.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int TH = 16;          // tile rows
constexpr int TW = 32;          // tile columns
constexpr int NT = 256;         // threads per block
constexpr int kMaxPlanes = 65535;  // planes per launch; more run in chunks
constexpr float kTau = 0.25f;

// The resident variant: the most threads a CTA may have for the rows SEG a
// lane walks and holds in registers (16 or 32 take more registers; the plan
// in ops/kernels/tv.py reads the same limits from its `_SEG_THREADS`, and
// resident_args_ok checks what the wrapper passes against these), cluster
// sizes.
constexpr int max_threads(int seg) { return seg <= 8 ? 1024 : (seg == 16 ? 640 : 576); }
constexpr int kMaxCluster = 16;
constexpr int kSmemMax = 232448;   // the 227 KB one block may use on an H100
constexpr float kTiny = 1e-30f;

// One Chambolle step for a 16 x 32 tile of plane blockIdx.z + plane0:
// reads (ph, pw), writes (ph_new, pw_new).
__global__ void __launch_bounds__(NT)
tv_step(const float* __restrict__ x, const float* __restrict__ gamma, int gstride,
        const float* __restrict__ ph, const float* __restrict__ pw,
        float* __restrict__ ph_new, float* __restrict__ pw_new, int H, int W, int plane0) {
  __shared__ float u[TH + 1][TW + 1];
  const int n = plane0 + blockIdx.z;
  const size_t off = (size_t)n * H * W;
  x += off;
  ph += off;
  pw += off;
  ph_new += off;
  pw_new += off;
  const float g = gamma[(size_t)n * gstride];
  const int i0 = blockIdx.y * TH, j0 = blockIdx.x * TW;

  // u on the tile and its bottom / right halo (u outside the plane is never read)
  for (int k = threadIdx.x; k < (TH + 1) * (TW + 1); k += NT) {
    const int r = k / (TW + 1), c = k - r * (TW + 1);
    const int i = i0 + r, j = j0 + c;
    float v = 0.f;
    if (i < H && j < W) {
      const size_t q = (size_t)i * W + j;
      const float dh = (i < H - 1 ? ph[q] : 0.f) - (i > 0 ? ph[q - W] : 0.f);
      const float dw = (j < W - 1 ? pw[q] : 0.f) - (j > 0 ? pw[q - 1] : 0.f);
      v = (dh + dw) - x[q] / g;
    }
    u[r][c] = v;
  }
  __syncthreads();

  for (int k = threadIdx.x; k < TH * TW; k += NT) {
    const int r = k / TW, c = k - r * TW;
    const int i = i0 + r, j = j0 + c;
    if (i < H && j < W) {
      const size_t q = (size_t)i * W + j;
      const float uc = u[r][c];
      const float eh = i < H - 1 ? u[r + 1][c] - uc : 0.f;
      const float ew = j < W - 1 ? u[r][c + 1] - uc : 0.f;
      const float denom = 1.f + kTau * sqrtf(eh * eh + ew * ew);
      ph_new[q] = (ph[q] + kTau * eh) / denom;
      pw_new[q] = (pw[q] + kTau * ew) / denom;
    }
  }
}

// out = x - gamma * div p for plane blockIdx.z + plane0.
__global__ void __launch_bounds__(NT)
tv_out(const float* __restrict__ x, const float* __restrict__ gamma, int gstride,
       const float* __restrict__ ph, const float* __restrict__ pw,
       float* __restrict__ out, int H, int W, int plane0) {
  const long long p = (long long)blockIdx.x * NT + threadIdx.x;
  if (p >= (long long)H * W) return;
  const int n = plane0 + blockIdx.z;
  const size_t q = (size_t)n * H * W + p;
  const int i = (int)(p / W), j = (int)(p - (long long)i * W);
  const float dh = (i < H - 1 ? ph[q] : 0.f) - (i > 0 ? ph[q - W] : 0.f);
  const float dw = (j < W - 1 ? pw[q] : 0.f) - (j > 0 ? pw[q - 1] : 0.f);
  out[q] = x[q] - gamma[(size_t)n * gstride] * (dh + dw);
}

// q / d for d >= 1, rounded as IEEE division. The division's range check
// sends a zero dividend to its slow path; flat regions and the first steps
// have many, so a zero q divides 1 instead (hidden from the compiler, which
// would fold the substitution away) and gives q itself.
__device__ __forceinline__ float div_pos(float q, float d) {
  float one_or_q = q == 0.f ? 1.f : q;
  asm("mov.b32 %0, %0;" : "+f"(one_or_q));
  const float r = one_or_q / d;
  return q == 0.f ? q : r;
}

// One lane's walk down its column for one step: the new (ph, pw) of the rows
// [s0, s0 + rows) (rows = SEG when FULL) into nph, npw. `at` points at the
// lane's pixel of row s0 in the xg array; ph and pw are `oh` and `ow` floats
// further (csrc layout in tv_resident). `last_off` is the offset of the row
// below the warp's last row from that row (W, or below the band the parity's
// halo row), `last_eh` false where that last row is the plane's last row.
// ph of row H - 1 and pw of column W - 1 stay 0 (their gradient is 0), and a
// lane past the last column computes the last column again, so the masks of
// tv_step's sums are needed only for the first row (taken by the caller,
// which passes u there as uc).
template <int SEG, bool FULL>
__device__ __forceinline__ void walk(float (&nph)[SEG], float (&npw)[SEG], const float* at,
                                     int oh, int ow, int W, int rows, int last_off,
                                     bool last_eh, float uc) {
  float phc = at[oh], pwc = at[ow];
#pragma unroll
  for (int s = 0; s < SEG; ++s) {
    if (FULL || s < rows) {  // warp-uniform
      const bool last = FULL ? s == SEG - 1 : s == rows - 1;
      const int off = last ? last_off : W;
      const float phn = at[oh + off], pwn = at[ow + off];
      // Column -1 reads the previous row's last element, pw of column W - 1:
      // 0. Below the band at an odd step that is column W - 1 of halo slot 0,
      // which the CTA below may be pushing in this same step; it pushes pw of
      // its column W - 1, which never moves from 0, so the read sees 0
      // whether it lands before or after the push.
      const float pwl = at[ow + off - 1];
      const float ud = ((phn - phc) + (pwn - pwl)) - at[W];
      const float ur = __shfl_down_sync(0xffffffffu, uc, 1);  // u at (i, j + 1)
      const float eh = (!last || last_eh) ? ud - uc : 0.f;
      const float ew = ur - uc;
      // sqrt of at least kTiny: the same denominator (1 + tau sqrt(s) rounds
      // to 1 below s ~ 1e-15) without sqrtf's slow path at 0
      const float denom = 1.f + kTau * sqrtf(fmaxf(eh * eh + ew * ew, kTiny));
      nph[s] = div_pos(phc + kTau * eh, denom);
      npw[s] = div_pos(pwc + kTau * ew, denom);
      phc = phn;
      pwc = pwn;
      uc = ud;
      at += W;
    }
  }
}

// The whole prox of plane blockIdx.x / cluster + plane0, resident in one
// cluster: CTA `rank` owns rows [r0, r1) = [rank band, min(H, (rank + 1)
// band)). Warp w owns the columns [31 c, 31 c + 31) (c = w mod chunks) of the
// rows [s0, s0 + SEG) of the band; its lane 31 computes u of the chunk's next
// column, for lane 30's gradient, and owns no pixel. Dynamic shared memory,
// 4 (3 band + 7) W bytes, row-major [row][W]:
//   xg  band + 1 rows: x / gamma of the band's rows, then of row r1;
//   ph  band + 2 rows: the band's rows, then ph of row r1 by step parity
//       (rows `rows` and `rows` + 1: the CTA below pushes them);
//   pw  band + 2 rows: likewise;
//   top 2 rows: ph of row r0 - 1 by step parity (the CTA above pushes them).
// So row i + 1 of a walk down the band is the next row in memory, or, below
// the band's last row, the parity's halo row.
template <int SEG>
__global__ void __launch_bounds__(max_threads(SEG), 1)
tv_resident(const float* __restrict__ x, const float* __restrict__ gamma, int gstride,
            float* __restrict__ out, int H, int W, int band, int n_iter, int plane0) {
  extern __shared__ float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int n = plane0 + (int)blockIdx.x / cs;
  const int oh = (band + 1) * W, ow = oh + (band + 2) * W, otop = ow + (band + 2) * W;
  float* const xg = sm;
  float* const ph = sm + oh;
  float* const pw = sm + ow;
  float* const top = sm + otop;
  const int r0 = rank * band, r1 = min(H, r0 + band);
  const int rows = r1 - r0;  // >= 1: the plan leaves no band empty
  const float g = gamma[(size_t)n * gstride];
  const float* xp = x + (size_t)n * H * W;
  float* op = out + (size_t)n * H * W;

  // xg of the band and of row r1 (0 below the plane), p = 0, halo slots 0
  for (int k = threadIdx.x; k < (rows + 1) * W; k += blockDim.x) {
    xg[k] = r0 * W + k < H * W ? xp[(size_t)r0 * W + k] / g : 0.f;
  }
  for (int k = threadIdx.x; k < (rows + 2) * W; k += blockDim.x) {
    ph[k] = 0.f;
    pw[k] = 0.f;
  }
  for (int k = threadIdx.x; k < 2 * W; k += blockDim.x) top[k] = 0.f;
  cluster.sync();  // every CTA runs and has zeroed its slots before the first push

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunks = (W + 30) / 31;
  const int j = (warp % chunks) * 31 + lane;
  const int jj = min(j, W - 1);  // lanes past the last column compute on it
  const bool owner = lane < 31 && j < W;
  const int s0 = r0 + (warp / chunks) * SEG;   // this warp's rows [s0, s1)
  const int s1 = min(r1, s0 + SEG);
  const bool full = s1 - s0 == SEG;
  const int base = (s0 - r0) * W + jj;
  float nph[SEG], npw[SEG];

  for (int t = 0; t < n_iter; ++t) {
    const int slot = t & 1, next = slot ^ 1;
    if (s0 < s1) {  // warp-uniform
      // u at (s0, jj), with tv_step's masks
      float uc;
      {
        const float phc = ph[base], pwc = pw[base];
        const float ph_u = s0 == 0 ? 0.f : (s0 > r0 ? ph[base - W] : top[slot * W + jj]);
        const float dh = (s0 < H - 1 ? phc : 0.f) - (s0 > 0 ? ph_u : 0.f);
        const float dw = (jj < W - 1 ? pwc : 0.f) - (jj > 0 ? pw[base - 1] : 0.f);
        uc = (dh + dw) - xg[base];
      }
      const int last_off = W + (s1 == r1 ? slot * W : 0);
      if (full) {
        walk<SEG, true>(nph, npw, xg + base, oh, ow, W, SEG, last_off, s1 < H, uc);
      } else {
        walk<SEG, false>(nph, npw, xg + base, oh, ow, W, s1 - s0, last_off, s1 < H, uc);
      }
    }
    __syncthreads();  // every read of the old p in this CTA is done
    if (s0 < s1 && owner) {
      float* hq = ph + (s0 - r0) * W + j;
      float* wq = pw + (s0 - r0) * W + j;
#pragma unroll
      for (int s = 0; s < SEG; ++s) {
        if (s0 + s < s1) {
          hq[s * W] = nph[s];
          wq[s * W] = npw[s];
          if (s0 + s == r1 - 1 && r1 < H) {  // the band's last row, to the top slot below
            cluster.map_shared_rank(top, rank + 1)[next * W + j] = nph[s];
          }
        }
      }
      if (s0 == r0 && rank > 0) {  // the band's first row, to the halo rows above
        const int q = (band + next) * W + j;  // the CTA above holds `band` rows
        cluster.map_shared_rank(ph, rank - 1)[q] = nph[0];
        cluster.map_shared_rank(pw, rank - 1)[q] = npw[0];
      }
    }
    cluster.sync();  // release / acquire: the new p, local and pushed, is visible
  }

  // out = x - gamma div p; no shared memory of another CTA is touched from here on
  const int slot = n_iter & 1;
  for (int k = threadIdx.x; k < rows * W; k += blockDim.x) {
    const int a = k / W, c = k - a * W, i = r0 + a;
    const float ph_u = i == 0 ? 0.f : (a > 0 ? ph[k - W] : top[slot * W + c]);
    const float dh = (i < H - 1 ? ph[k] : 0.f) - (i > 0 ? ph_u : 0.f);
    const float dw = (c < W - 1 ? pw[k] : 0.f) - (c > 0 ? pw[k - 1] : 0.f);
    const size_t q = (size_t)r0 * W + k;
    op[q] = xp[q] - g * (dh + dw);
  }
}

cudaLaunchConfig_t resident_config(int grid, int cluster, int threads, int smem,
                                   cudaStream_t s, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int SEG>
cudaError_t resident_attributes(int smem) {
  cudaError_t err = cudaFuncSetAttribute(tv_resident<SEG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(tv_resident<SEG>, cudaFuncAttributeNonPortableClusterSizeAllowed,
                              1);
}

template <int SEG>
int max_clusters(int cluster, int threads, int smem) {
  cudaError_t err = resident_attributes<SEG>(smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = resident_config(cluster, cluster, threads, smem, 0, &attr);
  int count = 0;
  err = cudaOccupancyMaxActiveClusters(&count, (const void*)tv_resident<SEG>, &cfg);
  return err != cudaSuccess ? -(int)err : count;
}

template <int SEG>
cudaError_t launch_resident(const float* x, const float* gamma, int gstride, float* out, int N,
                            int H, int W, int n_iter, int cluster, int band, int threads,
                            int smem, cudaStream_t s) {
  cudaError_t err = resident_attributes<SEG>(smem);
  if (err != cudaSuccess) return err;
  for (int n0 = 0; n0 < N; n0 += kMaxPlanes) {
    const int nb = N - n0 < kMaxPlanes ? N - n0 : kMaxPlanes;
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = resident_config(nb * cluster, cluster, threads, smem, s, &attr);
    err = cudaLaunchKernelEx(&cfg, tv_resident<SEG>, x, gamma, gstride, out, H, W, band, n_iter,
                             n0);
    if (err != cudaSuccess) return err;
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

bool resident_args_ok(int cluster, int seg, int threads, int smem) {
  return cluster >= 1 && cluster <= kMaxCluster &&
         (seg == 2 || seg == 4 || seg == 8 || seg == 16 || seg == 32) && threads >= 32 &&
         threads <= max_threads(seg) && threads % 32 == 0 && smem > 0 && smem <= kSmemMax;
}

}  // namespace

extern "C" {

// Global variant. x, out: (N, H, W) float32; gamma: per-plane float32,
// gamma[n * gstride]; state: (2, 2, N, H, W) float32 scratch,
// [buffer][component (h, w)], whose buffer 0 holds the initial dual field
// (zeros). Issues n_iter step launches and one output launch on `stream`.
// Returns the first CUDA error (0 on success).
int deepinv_tv_prox_f32(const void* x, const void* gamma, int gstride, void* state, void* out,
                        int N, int H, int W, int n_iter, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* gf = static_cast<const float*>(gamma);
  float* st = static_cast<float*>(state);
  const size_t field = (size_t)N * H * W;
  const dim3 step_grid_xy((W + TW - 1) / TW, (H + TH - 1) / TH);
  const unsigned out_blocks = (unsigned)(((long long)H * W + NT - 1) / NT);
  cudaError_t err;
  for (int it = 0; it < n_iter; ++it) {
    const float* ph = st + (size_t)(2 * (it & 1)) * field;
    const float* pw = ph + field;
    float* ph_new = st + (size_t)(2 * ((it + 1) & 1)) * field;
    float* pw_new = ph_new + field;
    for (int n0 = 0; n0 < N; n0 += kMaxPlanes) {
      const int nb = N - n0 < kMaxPlanes ? N - n0 : kMaxPlanes;
      const dim3 grid(step_grid_xy.x, step_grid_xy.y, nb);
      tv_step<<<grid, NT, 0, s>>>(xf, gf, gstride, ph, pw, ph_new, pw_new, H, W, n0);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  const float* ph = st + (size_t)(2 * (n_iter & 1)) * field;
  const float* pw = ph + field;
  for (int n0 = 0; n0 < N; n0 += kMaxPlanes) {
    const int nb = N - n0 < kMaxPlanes ? N - n0 : kMaxPlanes;
    tv_out<<<dim3(out_blocks, 1, nb), NT, 0, s>>>(xf, gf, gstride, ph, pw,
                                                  static_cast<float*>(out), H, W, n0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// How many clusters of the resident variant with this cluster size, rows a
// warp (2, 4, 8, 16 or 32), block size and dynamic shared memory can be
// resident on the device at once (cudaOccupancyMaxActiveClusters); a negative
// CUDA error on failure.
int deepinv_tv_resident_max_clusters(int cluster, int seg, int threads, int smem) {
  if (!resident_args_ok(cluster, seg, threads, smem)) return -(int)cudaErrorInvalidValue;
  switch (seg) {
    case 2: return max_clusters<2>(cluster, threads, smem);
    case 4: return max_clusters<4>(cluster, threads, smem);
    case 8: return max_clusters<8>(cluster, threads, smem);
    case 16: return max_clusters<16>(cluster, threads, smem);
    default: return max_clusters<32>(cluster, threads, smem);
  }
}

// Resident variant: the whole prox of every plane in one launch (one per
// kMaxPlanes planes), one cluster of `cluster` CTAs of `threads` threads a
// plane, CTA k owning rows [k band, (k+1) band), a warp `seg` rows, `smem`
// bytes of dynamic shared memory a CTA (the plan's numbers, ops/kernels/tv.py).
// x, out: (N, H, W) float32; gamma[n * gstride]. Returns the first CUDA error.
int deepinv_tv_prox_resident_f32(const void* x, const void* gamma, int gstride, void* out,
                                 int N, int H, int W, int n_iter, int cluster, int band,
                                 int seg, int threads, int smem, void* stream) {
  const int chunks = (W + 30) / 31;
  if (!resident_args_ok(cluster, seg, threads, smem) || band < 1 ||
      (cluster - 1) * band >= H || cluster * band < H ||
      chunks * ((band + seg - 1) / seg) * 32 > threads ||
      (long long)4 * (3 * band + 7) * W > smem) {
    return (int)cudaErrorInvalidValue;
  }
  const float* xf = static_cast<const float*>(x);
  const float* gf = static_cast<const float*>(gamma);
  float* of = static_cast<float*>(out);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (seg) {
    case 2:
      err = launch_resident<2>(xf, gf, gstride, of, N, H, W, n_iter, cluster, band, threads,
                               smem, s);
      break;
    case 4:
      err = launch_resident<4>(xf, gf, gstride, of, N, H, W, n_iter, cluster, band, threads,
                               smem, s);
      break;
    case 8:
      err = launch_resident<8>(xf, gf, gstride, of, N, H, W, n_iter, cluster, band, threads,
                               smem, s);
      break;
    case 16:
      err = launch_resident<16>(xf, gf, gstride, of, N, H, W, n_iter, cluster, band, threads,
                                smem, s);
      break;
    default:
      err = launch_resident<32>(xf, gf, gstride, of, N, H, W, n_iter, cluster, band, threads,
                                smem, s);
  }
  return (int)err;
}

}  // extern "C"
