// Chambolle total-variation prox, float32, for sm_90a.
//
// Replaces the Pallas TPU kernel `_kernel` (deepinv_tpu/ops/pallas/tv.py:53,
// launched by `_pallas_impl` :70). Per (H, W) plane it computes n_iter steps
// of Chambolle's dual projection, tau = 0.25,
//
//     u  = div p - x / gamma
//     p <- (p + tau grad u) / (1 + tau |grad u|)          (Jacobi: all from the old p)
//
// and then out = x - gamma div p, with the TPU kernel's boundary conventions:
// grad is the forward difference, zero at the last row / column (tv.py:33-40),
// and div p = p[i] (i < H-1) - p[i-1] (i > 0) along each axis (tv.py:43-50).
// gamma is read per plane from device memory, so a per-sample gamma runs here
// too (the TPU kernel takes one scalar and the JAX package sends a batch of
// gammas to the XLA loop, tv.py:104-113).
//
// What bounds it on an H100. The same work as the TPU kernel is one read of x,
// one write of the output and ~17 float32 operations plus a sqrt per pixel per
// iteration: at 1 x 3 x 256^2 and n_iter = 100, 0.35 GFLOP, ~5 us at the
// 67 TFLOP/s float32 (non-tensor) peak, against 1.6 MB of traffic, 0.5 us:
// operations bound it.
//
// Design. The TPU kernel keeps a plane's x and both dual components in VMEM
// for the whole loop (12 bytes a pixel: 768 KB for a 256^2 plane), more than
// the 227 KB of shared memory one SM gives a block. Here the host loop of one
// C call issues n_iter launches of one fused stencil kernel over every pixel of
// every plane, then one output launch. The dual field ping-pongs between two
// global buffers the wrapper allocates (16 bytes a pixel with both buffers:
// 3 MB at 1 x 3 x 256^2, inside the 50 MB L2). Each block owns a 16 x 32 tile,
// computes u once per pixel of the tile plus one row and one column of halo
// into shared memory, then updates its pixels. At the bench sizes the launches
// (~101 per prox) and not the arithmetic set the time; a resident version
// (one thread-block cluster per plane, halos through distributed shared
// memory) is later speed work.

#include <cuda_runtime.h>

namespace {

constexpr int TH = 16;          // tile rows
constexpr int TW = 32;          // tile columns
constexpr int NT = 256;         // threads per block
constexpr int kMaxPlanes = 65535;  // grid.z limit; more planes run in chunks
constexpr float kTau = 0.25f;

// One Chambolle step for a 16 x 32 tile of plane blockIdx.z + plane0:
// reads (ph, pw), writes (ph_new, pw_new).
__global__ void __launch_bounds__(NT)
tv_step(const float* __restrict__ x, const float* __restrict__ gamma,
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
  const float g = gamma[n];
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
tv_out(const float* __restrict__ x, const float* __restrict__ gamma,
       const float* __restrict__ ph, const float* __restrict__ pw,
       float* __restrict__ out, int H, int W, int plane0) {
  const long long p = (long long)blockIdx.x * NT + threadIdx.x;
  if (p >= (long long)H * W) return;
  const int n = plane0 + blockIdx.z;
  const size_t q = (size_t)n * H * W + p;
  const int i = (int)(p / W), j = (int)(p - (long long)i * W);
  const float dh = (i < H - 1 ? ph[q] : 0.f) - (i > 0 ? ph[q - W] : 0.f);
  const float dw = (j < W - 1 ? pw[q] : 0.f) - (j > 0 ? pw[q - 1] : 0.f);
  out[q] = x[q] - gamma[n] * (dh + dw);
}

}  // namespace

extern "C" {

// x, out: (N, H, W) float32; gamma: (N,) float32, one per plane; state:
// (2, 2, N, H, W) float32 scratch, [buffer][component (h, w)], whose buffer 0
// holds the initial dual field (zeros). Issues n_iter step launches and one
// output launch on `stream`. Returns the first CUDA error (0 on success).
int deepinv_tv_prox_f32(const void* x, const void* gamma, void* state, void* out, int N, int H,
                        int W, int n_iter, void* stream) {
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
      tv_step<<<grid, NT, 0, s>>>(xf, gf, ph, pw, ph_new, pw_new, H, W, n0);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  const float* ph = st + (size_t)(2 * (n_iter & 1)) * field;
  const float* pw = ph + field;
  for (int n0 = 0; n0 < N; n0 += kMaxPlanes) {
    const int nb = N - n0 < kMaxPlanes ? N - n0 : kMaxPlanes;
    tv_out<<<dim3(out_blocks, 1, nb), NT, 0, s>>>(xf, gf, ph, pw, static_cast<float*>(out), H,
                                                  W, n0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
