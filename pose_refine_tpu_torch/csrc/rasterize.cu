// Batch depth rasterizer for Hopper (sm_90a): one thread per (pose, triangle).
//
// Replaces the Pallas TPU kernel pose_refine_tpu/ops/rasterize_pallas.py::
// rasterize_pallas (kernel body _make_kernel). The TPU has no atomics, so the
// Pallas kernel inverts the loop into a gather over framebuffer tiles with
// block/superblock culling. Hopper has atomics, so this kernel takes the
// reference renderer's own form (renderer.cu:152-187): each thread walks the
// clamped bbox of one (pose, triangle) pair and atomicMin's the rounded depth
// into an int32 framebuffer initialised to INT_MAX; a second pass maps
// INT_MAX to 0. trunc(d + 0.5) is monotone in d, so the minimum of the
// rounded depths equals the rounded minimum the Pallas kernel stores
// (rasterize_pallas.py:266): the result is exact, not approximate.
//
// Input: the per-(pose, triangle) coefficient table of
// ops/rasterize_cuda.py::triangle_setup, coef (N, 16, T) float32:
//   0..2  beta  = kbx*px + kby*py + kb0
//   3..5  gamma = kgx*px + kgy*py + kg0
//   6..8  denom = ddx*px + ddy*py + dd0   (interpolated 1/z)
//   9..12 x_start, y_start, x_max, y_max (clamped bbox; x_start =
//         trunc(bbmin + 0.5), renderer.cu:124-125; degenerate triangles
//         carry an empty box)
// Reading the table makes per-pose (N, T, 3, 3) triangle tables free.
//
// Arithmetic: every product and sum of the coverage and depth terms is
// written with __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn, so nvcc cannot
// contract them into FMAs. The plain PyTorch version (rasterize_cuda.py::
// raster_coef_plain) evaluates the same expressions one rounded op at a
// time, and the two agree bit for bit on triangle-edge pixels.
//
// What bounds it on the H100: atomics into a small framebuffer (one 32-bit
// atomicMin per covered pixel, mostly hitting L2) and the per-thread loop,
// whose length is the triangle's screen bbox area; threads of one warp walk
// boxes of different sizes, so a few large triangles leave most lanes idle.
// The design answers with tiny per-thread state (no shared memory, so many
// resident warps hide the atomic latency), coalesced coefficient reads (the
// triangle index is the fastest axis of the table), and a bbox clamped to
// the ROI before the loop. Binning triangles to tiles is later work.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr float kBig = 3.0e38f;             // "no depth" sentinel, as the Pallas kernel's BIG
constexpr float kIntLim = 2147483520.0f;    // largest float below 2^31

__global__ void fill_kernel(int* __restrict__ fb, long long n, int value) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    fb[i] = value;
  }
}

__global__ void finalize_kernel(int* __restrict__ fb, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    if (fb[i] == INT_MAX) fb[i] = 0;
  }
}

__global__ void raster_kernel(const float* __restrict__ coef, int n_pose, int n_tri,
                              int* __restrict__ fb, int out_h, int out_w, int height,
                              int rx, int ry) {
  const long long total = (long long)n_pose * n_tri;
  // ROI in the flipped-y P space: px in [rx, rx+out_w-1],
  // py in [height-ry-out_h, height-1-ry]
  const float px_lo = (float)rx;
  const float px_hi = (float)(rx + out_w - 1);
  const float py_hi = (float)(height - 1 - ry);
  const float py_lo = (float)(height - ry - out_h);
  for (long long gid = blockIdx.x * (long long)blockDim.x + threadIdx.x; gid < total;
       gid += (long long)gridDim.x * blockDim.x) {
    const int pose = (int)(gid / n_tri);
    const int tri = (int)(gid - (long long)pose * n_tri);
    const float* c = coef + (size_t)pose * 16 * n_tri + tri;
    const float xs = c[9 * (size_t)n_tri], ys = c[10 * (size_t)n_tri];
    const float xm = c[11 * (size_t)n_tri], ym = c[12 * (size_t)n_tri];
    if (!(xs <= xm && ys <= ym)) continue;  // empty, degenerate or NaN box
    const float x0 = fmaxf(xs, px_lo), x1 = fminf(xm, px_hi);
    const float y0 = fmaxf(ys, py_lo), y1 = fminf(ym, py_hi);
    if (!(x0 <= x1 && y0 <= y1)) continue;
    // integer pixels p with x0 <= p <= x1 (the Pallas test px >= xs, px <= xm)
    const int ix0 = (int)ceilf(x0), ix1 = (int)floorf(x1);
    const int iy0 = (int)ceilf(y0), iy1 = (int)floorf(y1);

    const float kbx = c[0], kby = c[(size_t)n_tri], kb0 = c[2 * (size_t)n_tri];
    const float kgx = c[3 * (size_t)n_tri], kgy = c[4 * (size_t)n_tri];
    const float kg0 = c[5 * (size_t)n_tri];
    const float ddx = c[6 * (size_t)n_tri], ddy = c[7 * (size_t)n_tri];
    const float dd0 = c[8 * (size_t)n_tri];
    int* img = fb + (size_t)pose * out_h * out_w;

    for (int iy = iy0; iy <= iy1; ++iy) {
      const float py = (float)iy;
      const float by = __fmul_rn(kby, py), gy = __fmul_rn(kgy, py), dy = __fmul_rn(ddy, py);
      int* row = img + (size_t)(height - 1 - ry - iy) * out_w;
      for (int ix = ix0; ix <= ix1; ++ix) {
        const float px = (float)ix;
        const float beta = __fadd_rn(__fadd_rn(__fmul_rn(kbx, px), by), kb0);
        const float gamma = __fadd_rn(__fadd_rn(__fmul_rn(kgx, px), gy), kg0);
        const float alpha = __fsub_rn(__fsub_rn(1.0f, beta), gamma);
        if (!(beta >= 0.0f && gamma >= 0.0f && alpha >= 0.0f)) continue;
        const float denom = __fadd_rn(__fadd_rn(__fmul_rn(ddx, px), dy), dd0);
        float d = __fdiv_rn(1.0f, denom);
        if (!(d < kBig)) continue;  // +inf / NaN never wins, as in the Pallas kernel
        d = fminf(fmaxf(d, -kIntLim), kIntLim);
        atomicMin(row + (ix - rx), (int)truncf(__fadd_rn(d, 0.5f)));
      }
    }
  }
}

int grid_for(long long n, int block) {
  long long g = (n + block - 1) / block;
  if (g < 1) g = 1;
  // grid-stride loops cover the rest; 132 SMs x 16 resident blocks is plenty
  if (g > 132LL * 64) g = 132LL * 64;
  return (int)g;
}

}  // namespace

// Render N poses from their coefficient table into fb (N, out_h, out_w) int32
// mm, 0 = empty, on `stream`. Returns the cudaError_t of the launches (0 = ok).
extern "C" int prt_rasterize(const float* coef, int n_pose, int n_tri, int* fb,
                             int out_h, int out_w, int height, int rx, int ry,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_px = (long long)n_pose * out_h * out_w;
  const int block = 256;
  fill_kernel<<<grid_for(n_px, block), block, 0, s>>>(fb, n_px, INT_MAX);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n_work = (long long)n_pose * n_tri;
  if (n_work > 0) {
    raster_kernel<<<grid_for(n_work, block), block, 0, s>>>(coef, n_pose, n_tri, fb, out_h,
                                                            out_w, height, rx, ry);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  finalize_kernel<<<grid_for(n_px, block), block, 0, s>>>(fb, n_px);
  return (int)cudaGetLastError();
}

extern "C" const char* prt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
