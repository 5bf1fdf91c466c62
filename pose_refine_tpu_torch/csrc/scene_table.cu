// The projective scene table of an (H, W) int32 depth frame, or of a
// (K, H, W) stack of them, for Hopper (sm_90a), in one launch.
//
// Replaces no Pallas kernel: the JAX package builds this table as XLA code
// (pose_refine_tpu/scene/projective.py::_build_projective_table (:26), over
// ops/depth_to_cloud.py::depth_image_to_points and
// ops/normals.py::estimate_normals), which the port's plain version,
// pose_refine_tpu_torch/scene/projective.py::_build_projective_table_plain,
// computes in eager PyTorch as ~200 small kernels. This kernel equals it bit
// for bit.
//
// What it computes, for each pixel (u, v) of depth d (mm), one packed row
// of 8 floats, [x y z | nx ny nz | 0 0], at row k * H * W + v * W + u:
//   1. dep2pcd in the plain version's rounded operations on the card:
//      z = d * fl(1 / 1000) (a CUDA tensor divided by a host scalar is
//      multiplied by the scalar's float reciprocal), x = ((u - cx) / fx) * z,
//      y = ((v - cy) / fy) * z, each operation rounded alone; a pixel with
//      d <= 0 is all zeros.
//   2. the LINEMOD normal (get_normal, scene/common.cpp:17-107): the 8
//      neighbours at (+-5, +-5) pixels, zero outside the frame; a neighbour
//      counts where |d_n - d| < 50; five exact int32 sums, the 2 x 2
//      determinant and the solve's numerators; n = (fx * ddx, fy * ddy,
//      -det * d) in float32, |n| by the IEEE square root, scaled by the
//      correctly rounded reciprocal of |n| where d < 2000, |n| > 0 and the
//      pixel lies in the interior (rows and columns [5, dim - 7]), else by
//      0 (so a zero keeps n's sign, as the plain version's product does).
// fx, fy, cx and cy are read from the 3 x 3 K on the card: a build from
// device tensors never synchronises.
//
// Bound: the frame read once and 32 bytes written a pixel (9.8 MB at
// 640 x 480: ~3 us at 3.35 TB/s); the ~70 operations a pixel are far below
// the FP32 rate. Design: a memory-bound stencil. A CTA takes a 32 x 16 tile
// of one frame and stages the tile with its 5-pixel halo (42 x 26 int32) in
// shared memory, so each depth is read from device memory about 1.7 times
// (the halo from L2) instead of 9; a thread computes two pixels, a column
// apart by 8 rows, and writes each row as two 16-byte stores (a warp's
// stores cover 1 KB of consecutive rows). The grid is (tiles across, tiles
// down, frames).

#include <cuda_runtime.h>

namespace {

constexpr int kR = 5;                    // the stencil's radius
constexpr int kDiff = 50;                // a neighbour counts where |d_n - d| < kDiff
constexpr int kFar = 2000;               // the centre gate: d < kFar
constexpr int kTileW = 32;               // tile columns: a warp's row
constexpr int kTileH = 16;               // tile rows
constexpr int kThreadRows = 8;           // a CTA is kTileW x kThreadRows threads
constexpr int kHaloW = kTileW + 2 * kR;  // 42
constexpr int kHaloH = kTileH + 2 * kR;  // 26
constexpr int kThreads = kTileW * kThreadRows;

// PyTorch's float reciprocal of the host scalar 1000, rounded once
constexpr float kInvMm = 1.0f / 1000.0f;

struct Intrinsics {
  float fx, fy, cx, cy;
};

// the row of pixel (x, y): its point and its normal
__device__ __forceinline__ void pixel_row(const int (*s)[kHaloW], int lx, int ly, int x, int y,
                                          int h, int w, const Intrinsics& k, float4* row) {
  const int d = s[ly][lx];
  int a0 = 0, a1 = 0, a3 = 0, b0 = 0, b1 = 0;
#pragma unroll
  for (int oy = -1; oy <= 1; ++oy) {
#pragma unroll
    for (int ox = -1; ox <= 1; ++ox) {
      if (ox == 0 && oy == 0) continue;
      const int dx = ox * kR, dy = oy * kR;
      const int delta = s[ly + dy][lx + dx] - d;
      const int f = abs(delta) < kDiff ? 1 : 0;
      a0 += f * (dx * dx);
      a1 += f * (dx * dy);
      a3 += f * (dy * dy);
      b0 += f * dx * delta;
      b1 += f * dy * delta;
    }
  }
  const int det = a0 * a3 - a1 * a1;
  const int ddx = a3 * b0 - a1 * b1;
  const int ddy = -a1 * b0 + a0 * b1;
  const float df = __int2float_rn(d);
  const float nx = __fmul_rn(k.fx, __int2float_rn(ddx));
  const float ny = __fmul_rn(k.fy, __int2float_rn(ddy));
  const float nz = __fmul_rn(-__int2float_rn(det), df);
  const float norm = __fsqrt_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(nx, nx), __fmul_rn(ny, ny)), __fmul_rn(nz, nz)));
  const bool interior = y >= kR && y < h - kR - 1 && x >= kR && x < w - kR - 1;
  const float inv = (d < kFar && norm > 0.0f && interior) ? __frcp_rn(norm) : 0.0f;

  float px = 0.0f, py = 0.0f, pz = 0.0f;
  if (d > 0) {
    pz = __fmul_rn(df, kInvMm);
    px = __fmul_rn(__fdiv_rn(__fsub_rn(__int2float_rn(x), k.cx), k.fx), pz);
    py = __fmul_rn(__fdiv_rn(__fsub_rn(__int2float_rn(y), k.cy), k.fy), pz);
  }
  row[0] = make_float4(px, py, pz, __fmul_rn(nx, inv));
  row[1] = make_float4(__fmul_rn(ny, inv), __fmul_rn(nz, inv), 0.0f, 0.0f);
}

__global__ void __launch_bounds__(kThreads)
scene_table_kernel(const int* __restrict__ depth, int h, int w, const float* __restrict__ K,
                   float4* __restrict__ table) {
  __shared__ int s[kHaloH][kHaloW];
  const long long frame = (long long)blockIdx.z * h * w;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  const int* src = depth + frame;
  for (int i = tid; i < kHaloH * kHaloW; i += kThreads) {
    const int r = i / kHaloW, c = i - r * kHaloW;
    const int gy = y0 - kR + r, gx = x0 - kR + c;
    s[r][c] = (gy >= 0 && gy < h && gx >= 0 && gx < w) ? __ldg(src + (long long)gy * w + gx) : 0;
  }
  const Intrinsics k = {__ldg(K + 0), __ldg(K + 4), __ldg(K + 2), __ldg(K + 5)};
  __syncthreads();

  const int x = x0 + threadIdx.x;
  if (x >= w) return;
#pragma unroll
  for (int j = 0; j < kTileH / kThreadRows; ++j) {
    const int ly = threadIdx.y + j * kThreadRows;
    const int y = y0 + ly;
    if (y < h) {
      pixel_row(s, threadIdx.x + kR, ly + kR, x, y, h, w, k,
                table + 2 * (frame + (long long)y * w + x));
    }
  }
}

}  // namespace

// depth: (k, h, w) int32, contiguous; K: 3 x 3 float32, row-major; table:
// (k * h * w, 8) float32, 16-byte aligned. Launches on ``stream`` and
// returns the launch's CUDA error (0 on success).
extern "C" int prt_scene_table(const int* depth, int k, int h, int w, const float* K,
                               float* table, void* stream) {
  if (k <= 0 || h <= 0 || w <= 0) return 0;
  if (k > 65535 || (long long)h * w >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, k);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  scene_table_kernel<<<grid, dim3(kTileW, kThreadRows), 0, static_cast<cudaStream_t>(stream)>>>(
      depth, h, w, K, reinterpret_cast<float4*>(table));
  return (int)cudaGetLastError();
}
