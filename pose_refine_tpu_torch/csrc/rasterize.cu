// Batch depth rasterizer for Hopper (sm_90a): mesh and poses in, the
// finished int32 framebuffer out, in two launches.
//
// Replaces the Pallas TPU kernel pose_refine_tpu/ops/rasterize_pallas.py::
// rasterize_pallas (kernel body _make_kernel) together with the setup XLA
// ran before it (_triangle_setup). Output semantics are the Pallas
// kernel's: int32 mm, trunc(d + 0.5) of the least perspective depth, 0
// where the pixel is empty, y flipped, the ROI cropped while rendering,
// degenerate and non-finite triangles covering nothing, +inf / NaN depths
// never winning, depths clamped to +-2147483520.
//
// What bounds it: the framebuffer written once (N x out_h x out_w x 4
// bytes) is the only large traffic; the mesh (M, T, 3, 3) is read from L2.
// The work is the triangle setup per (pose, triangle) - 136 FP32 ops, ten
// of them divisions or reciprocals - and ~8 per pixel of each clamped
// triangle box; this kernel repeats the setup for every tile a triangle's
// block meets. The design:
//
//   bin_kernel     one thread per (pose, triangle): projects the triangle
//                  (one reciprocal of z a vertex, not two divisions) and
//                  writes the union boxes of 32 consecutive triangles (a
//                  block) and of 256 (a superblock), each widened so that it
//                  holds every pixel the exact setup lets the triangles
//                  cover (cover_box) - N x T / 32 x 16 bytes, no
//                  per-triangle table. Triangles come in Morton order
//                  (mesh.morton_order), so the unions are tight.
//   raster_kernel  one CTA of 256 threads per screen tile of one pose:
//                  256x32 when the batch fills the card four times over,
//                  else 32x32 (wide tiles set a triangle up in fewer tiles,
//                  narrow ones keep a small batch's SMs busy). It culls
//                  superblocks, then blocks, against the tile (ballot
//                  compaction into shared lists); a warp takes a surviving
//                  block, each lane one triangle, recomputes that
//                  triangle's setup in registers (recompute costs
//                  instructions, a per-tile list would cost bytes and a
//                  third launch) and keeps it if its box meets the tile.
//                  The warp then walks the kept boxes together: a prefix
//                  sum over the lanes cuts them into chunks of 4
//                  consecutive box pixels, and a lane takes a chunk at a
//                  time - so a large triangle is spread over the warp
//                  instead of holding 31 lanes idle while one lane walks
//                  it. A lane steps through its chunk in float coordinates
//                  (no int <-> float conversion a pixel) and evaluates its
//                  pixels without a branch, so their chains overlap; each
//                  covered pixel's depth + 0.5, as an order-preserving int
//                  key, is min-reduced into the tile in shared memory
//                  (shared atomicMin; a tile has one owner, so no global
//                  atomics). The tile is written once, truncated there,
//                  16-byte stores, 0 where empty: no fill pass, no
//                  finalize pass.
//
// Arithmetic: each operation of the plain version (ops/rasterize.py::
// screen_fields, ops/rasterize_cuda.py::triangle_setup and
// raster_coef_plain) is one operation here, written as an _rn intrinsic so
// nvcc contracts nothing: torch.addcmul is one fused multiply-add on the
// card (checked on the H100 with torch 2.11: equal to float32(a + b*c) in
// float64 on 4M inputs), so it is __fmaf_rn; every other product, sum and
// division rounds alone (a reciprocal as __frcp_rn, which equals
// __fdiv_rn(1, x): both are correctly rounded). nan_to_num and the `bad`
// mask are mirrored field by field. trunc(d + 0.5) is monotone in d, so the
// truncated minimum of d + 0.5 is the rounded minimum the plain version
// stores: the kernel equals its plain version bit for bit. prt_raster_setup writes the setup
// this kernel computes, for tests that compare it field by field.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr float kBig = 3.0e38f;             // "no depth" sentinel, as the Pallas kernel's BIG
constexpr float kIntLim = 2147483520.0f;    // largest float below 2^31
// The screen tile one CTA owns: wide tiles set a triangle up in fewer
// tiles; narrow ones give small batches enough CTAs (prt_rasterize picks).
constexpr int kTileW = 32, kTileH = 32;     // narrow
constexpr int kWideW = 256, kWideH = 32;    // wide
constexpr int kWideCtas = 4;                // wide when the grid fills the SMs this many times
constexpr int kThreads = 256;               // 8 warps
constexpr int kBlock = 32;                  // triangles a block: one warp, a lane each
constexpr int kSuper = 8;                   // blocks a superblock (one bin_kernel CTA)
constexpr int kChunk = 4;                   // box pixels a lane evaluates in one visit
constexpr unsigned kFull = 0xffffffffu;

static_assert(kBlock * kSuper == kThreads, "a bin_kernel CTA is one superblock");

struct Frame {
  float hw, hh;                        // width / 2, height / 2
  float cmin_x, cmin_y, cmax_x, cmax_y;  // the setup's clamp window (the ROI, y flipped)
  int n_tri, n_mesh, nb, nsb;          // triangles a mesh, meshes, blocks, superblocks
};

// One triangle's setup: the 13 fields of triangle_setup, after nan_to_num.
struct Setup {
  float kbx, kby, kb0, kgx, kgy, kg0, ddx, ddy, dd0;
  float xs, ys, xm, ym;
};

// A triangle of a warp's block as its lanes walk it: coefficients, its
// pixel box (left column, top row, width, pixels, 1 / width, the left
// column as a float, the top row's offset in the tile) and where its chunks
// of kChunk pixels start in the warp's running count.
struct __align__(16) WarpTri {
  float kbx, kby, kb0, kgx, kgy, kg0, ddx, ddy, dd0;
  int iy1, w, area;
  float inv_w, x0;
  int at0;    // tile_fb index of the box's top-left pixel
  int start;  // first chunk
};

__device__ __forceinline__ float nan_to_num(float v) {
  if (isnan(v)) return 0.0f;
  if (isinf(v)) return v > 0.0f ? kBig : -kBig;
  return v;
}

// torch.addcmul(acc, a, b): one fused multiply-add on the card
__device__ __forceinline__ float addcmul(float acc, float a, float b) {
  return __fmaf_rn(a, b, acc);
}

// The camera-space point and its projection's x and y rows, as
// screen_fields computes them: dot3 chains (a0*x0, then addcmul a1*x1 and
// a2*x2) + translation. M is the pose (row-major 4x4), P the projection.
__device__ __forceinline__ void project(const float* __restrict__ M,
                                        const float* __restrict__ P, float X, float Y, float Z,
                                        float& px, float& py, float& z) {
  float cam[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    cam[i] = __fadd_rn(
        addcmul(addcmul(__fmul_rn(M[4 * i], X), M[4 * i + 1], Y), M[4 * i + 2], Z),
        M[4 * i + 3]);
  }
  px = __fadd_rn(addcmul(addcmul(__fmul_rn(P[0], cam[0]), P[1], cam[1]), P[2], cam[2]), P[3]);
  py = __fadd_rn(addcmul(addcmul(__fmul_rn(P[4], cam[0]), P[5], cam[1]), P[6], cam[2]), P[7]);
  z = cam[2];
}

// screen_fields for one vertex: x / z * hw + hw.
__device__ __forceinline__ void screen_vertex(const float* __restrict__ M,
                                              const float* __restrict__ P, const Frame& f,
                                              float X, float Y, float Z, float& sx, float& sy,
                                              float& z) {
  float px, py;
  project(M, P, X, Y, Z, px, py, z);
  sx = __fadd_rn(__fmul_rn(__fdiv_rn(px, z), f.hw), f.hw);
  sy = __fadd_rn(__fmul_rn(__fdiv_rn(py, z), f.hh), f.hh);
}

// The triangle's three vertices in screen space.
struct Screen {
  float ax, ay, bx, by, cx, cy, z0, z1, z2;
};

__device__ __forceinline__ Screen screen_triangle(const float* v, const float* __restrict__ M,
                                                  const float* __restrict__ P, const Frame& f) {
  Screen s;
  screen_vertex(M, P, f, v[0], v[1], v[2], s.ax, s.ay, s.z0);
  screen_vertex(M, P, f, v[3], v[4], v[5], s.bx, s.by, s.z1);
  screen_vertex(M, P, f, v[6], v[7], v[8], s.cx, s.cy, s.z2);
  return s;
}

// Triangle `tri` of `mesh` into v (nothing past the mesh's end).
__device__ __forceinline__ void load_triangle(const float* __restrict__ mesh, int tri, int n_tri,
                                              float* v) {
  if (tri >= n_tri) return;
  const float* src = mesh + (size_t)tri * 9;
#pragma unroll
  for (int i = 0; i < 9; ++i) v[i] = __ldg(src + i);
}

// The clamped box fields 9..12 of triangle_setup (after the bad mask and
// nan_to_num); also returns inv = 1 / area2 for the coefficients. A NaN
// vertex coordinate makes area2 NaN and the triangle bad, so fminf / fmaxf
// (which drop a NaN where torch.minimum keeps it) only see finite or
// infinite values where the result is used.
__device__ __forceinline__ void triangle_box(const Screen& s, const Frame& f, float& xs,
                                             float& ys, float& xm, float& ym, float& inv) {
  const float area2 = __fsub_rn(__fmul_rn(__fsub_rn(s.cx, s.ax), __fsub_rn(s.by, s.ay)),
                                __fmul_rn(__fsub_rn(s.bx, s.ax), __fsub_rn(s.cy, s.ay)));
  inv = __frcp_rn(area2);
  const bool bad = !isfinite(inv) || area2 == 0.0f;
  if (bad) {
    xs = kBig;
    ys = kBig;
    xm = -kBig;
    ym = -kBig;
    return;
  }
  const float bbmin_x = fmaxf(fminf(fminf(s.ax, s.bx), s.cx), f.cmin_x);
  const float bbmin_y = fmaxf(fminf(fminf(s.ay, s.by), s.cy), f.cmin_y);
  xm = nan_to_num(fminf(fmaxf(fmaxf(s.ax, s.bx), s.cx), f.cmax_x));
  ym = nan_to_num(fminf(fmaxf(fmaxf(s.ay, s.by), s.cy), f.cmax_y));
  xs = nan_to_num(truncf(__fadd_rn(bbmin_x, 0.5f)));
  ys = nan_to_num(truncf(__fadd_rn(bbmin_y, 0.5f)));
}

// Fields 0..8 of triangle_setup (after nan_to_num).
__device__ __forceinline__ void triangle_coef(const Screen& s, float inv, Setup& c) {
  const float cy_ay = __fsub_rn(s.cy, s.ay), cx_ax = __fsub_rn(s.cx, s.ax);
  const float by_ay = __fsub_rn(s.by, s.ay), bx_ax = __fsub_rn(s.bx, s.ax);
  const float kbx = __fmul_rn(-cy_ay, inv);
  const float kby = __fmul_rn(cx_ax, inv);
  const float kb0 = __fmul_rn(__fsub_rn(__fmul_rn(s.ax, cy_ay), __fmul_rn(s.ay, cx_ax)), inv);
  const float kgx = __fmul_rn(by_ay, inv);
  const float kgy = __fmul_rn(-bx_ax, inv);
  const float kg0 = __fmul_rn(__fsub_rn(__fmul_rn(s.ay, bx_ax), __fmul_rn(s.ax, by_ay)), inv);
  const float iz0 = __frcp_rn(s.z0), iz1 = __frcp_rn(s.z1), iz2 = __frcp_rn(s.z2);
  const float diz1 = __fsub_rn(iz1, iz0), diz2 = __fsub_rn(iz2, iz0);
  c.kbx = nan_to_num(kbx);
  c.kby = nan_to_num(kby);
  c.kb0 = nan_to_num(kb0);
  c.kgx = nan_to_num(kgx);
  c.kgy = nan_to_num(kgy);
  c.kg0 = nan_to_num(kg0);
  c.ddx = nan_to_num(__fadd_rn(__fmul_rn(kbx, diz1), __fmul_rn(kgx, diz2)));
  c.ddy = nan_to_num(__fadd_rn(__fmul_rn(kby, diz1), __fmul_rn(kgy, diz2)));
  c.dd0 = nan_to_num(
      __fadd_rn(__fadd_rn(__fmul_rn(kb0, diz1), __fmul_rn(kg0, diz2)), iz0));
}

// A finite float as an int32 of the same order (and back): min-reducing
// the keys min-reduces the floats. INT_MAX, a NaN's bits, is no float's key.
__device__ __forceinline__ int order_key(float v) {
  const int b = __float_as_int(v);
  return b >= 0 ? b : b ^ INT_MAX;
}
__device__ __forceinline__ float key_value(int k) { return __int_as_float(k >= 0 ? k : k ^ INT_MAX); }

// One pixel (px, py) of a triangle: the order_key of its clamped depth +
// 0.5, whose truncation is the pixel's value, INT_MAX where the triangle
// does not cover it: raster_coef_plain's arithmetic (1 / denom correctly
// rounded: __frcp_rn is __fdiv_rn(1, denom) bit for bit), computed whether
// or not the pixel is covered (no branch). trunc is monotone, so the least
// key's truncation is the least rounded depth; the truncation is left to
// the tile's write, once a pixel.
__device__ __forceinline__ int pixel_key(const WarpTri& c, float px, float py) {
  const float beta = __fadd_rn(__fadd_rn(__fmul_rn(c.kbx, px), __fmul_rn(c.kby, py)), c.kb0);
  const float gamma = __fadd_rn(__fadd_rn(__fmul_rn(c.kgx, px), __fmul_rn(c.kgy, py)), c.kg0);
  const float alpha = __fsub_rn(__fsub_rn(1.0f, beta), gamma);
  const bool in = beta >= 0.0f && gamma >= 0.0f && alpha >= 0.0f;
  const float denom = __fadd_rn(__fadd_rn(__fmul_rn(c.ddx, px), __fmul_rn(c.ddy, py)), c.dd0);
  float d = __frcp_rn(denom);
  const bool ok = in && d < kBig;
  d = fminf(fmaxf(d, -kIntLim), kIntLim);
  const int k = order_key(__fadd_rn(d, 0.5f));
  return ok ? k : INT_MAX;
}

// pose (16 floats) and proj (16 floats) of this CTA into shared memory
__device__ __forceinline__ void load_pose(float* sm, const float* __restrict__ poses,
                                          const float* __restrict__ proj, int pose) {
  if (threadIdx.x < 16) sm[threadIdx.x] = poses[(size_t)pose * 16 + threadIdx.x];
  else if (threadIdx.x < 32) sm[threadIdx.x] = proj[threadIdx.x - 16];
}

__device__ __forceinline__ const float* mesh_of(const float* __restrict__ table,
                                                const int* __restrict__ ids, const Frame& f,
                                                int pose) {
  // ids == nullptr: one shared mesh (M = 1) or one mesh per pose (M = N);
  // ids clamp into the table, so a stray id renders a real mesh
  int row = f.n_mesh == 1 ? 0 : pose;
  if (ids != nullptr) row = min(max(__ldg(ids + pose), 0), f.n_mesh - 1);
  return table + (size_t)row * f.n_tri * 9;
}

// A box that holds the triangle's clamped pixel box (triangle_box) whenever
// that box is not empty, for culling: each vertex is projected with one
// correctly rounded reciprocal of z in place of two divisions (px * (1/z)
// lies within 2^-22 |px / z| of px / z before the screen scaling), and the
// box is widened by 1 + |x| 2^-18 pixels on each side, far above that
// error, and by half a pixel more below for the start's rounding
// (trunc(b + 0.5) >= b - 0.5). No degenerate mask: a degenerate triangle
// only widens its block's union. Infinite coordinates clamp to the window;
// fminf / fmaxf drop a NaN, whose triangle is degenerate anyway.
__device__ __forceinline__ void cover_box(const float* v, const float* __restrict__ M,
                                          const float* __restrict__ P, const Frame& f,
                                          float& xs, float& ys, float& xm, float& ym) {
  float sx[3], sy[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float px, py, z;
    project(M, P, v[3 * i], v[3 * i + 1], v[3 * i + 2], px, py, z);
    const float rz = __frcp_rn(z);
    sx[i] = __fadd_rn(__fmul_rn(__fmul_rn(px, rz), f.hw), f.hw);
    sy[i] = __fadd_rn(__fmul_rn(__fmul_rn(py, rz), f.hh), f.hh);
  }
  const float lo_x = fminf(fminf(sx[0], sx[1]), sx[2]), hi_x = fmaxf(fmaxf(sx[0], sx[1]), sx[2]);
  const float lo_y = fminf(fminf(sy[0], sy[1]), sy[2]), hi_y = fmaxf(fmaxf(sy[0], sy[1]), sy[2]);
  const float mx = 1.0f + fmaxf(fabsf(lo_x), fabsf(hi_x)) * 0x1p-18f;
  const float my = 1.0f + fmaxf(fabsf(lo_y), fabsf(hi_y)) * 0x1p-18f;
  xs = fmaxf(lo_x - mx, f.cmin_x) - 0.5f;
  ys = fmaxf(lo_y - my, f.cmin_y) - 0.5f;
  xm = fminf(hi_x + mx, f.cmax_x);
  ym = fminf(hi_y + my, f.cmax_y);
}

// Block and superblock union boxes of one pose's triangles (cover_box).
// grid: n_pose * nsb CTAs, one superblock each.
__global__ void __launch_bounds__(kThreads)
bin_kernel(const float* __restrict__ table, const int* __restrict__ ids,
           const float* __restrict__ poses, const float* __restrict__ proj, Frame f,
           float4* __restrict__ blocks, float4* __restrict__ supers) {
  __shared__ float sm[32];
  __shared__ float4 warp_box[kThreads / 32];
  const int pose = blockIdx.x / f.nsb, sb = blockIdx.x - pose * f.nsb;
  const int tri = sb * kThreads + threadIdx.x;
  float v[9];  // the vertices, loaded before the pose is waited for
  load_triangle(mesh_of(table, ids, f, pose), tri, f.n_tri, v);
  load_pose(sm, poses, proj, pose);
  __syncthreads();
  float xs = kBig, ys = kBig, xm = -kBig, ym = -kBig;
  if (tri < f.n_tri) cover_box(v, sm, sm + 16, f, xs, ys, xm, ym);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    xs = fminf(xs, __shfl_xor_sync(kFull, xs, o));
    ys = fminf(ys, __shfl_xor_sync(kFull, ys, o));
    xm = fmaxf(xm, __shfl_xor_sync(kFull, xm, o));
    ym = fmaxf(ym, __shfl_xor_sync(kFull, ym, o));
  }
  const int warp = threadIdx.x >> 5, blk = sb * kSuper + warp;
  if ((threadIdx.x & 31) == 0) {
    const float4 box = make_float4(xs, ys, xm, ym);
    if (blk < f.nb) blocks[(size_t)pose * f.nb + blk] = box;
    warp_box[warp] = box;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float4 u = warp_box[0];
    for (int w = 1; w < kThreads / 32; ++w) {
      const float4 b = warp_box[w];
      u = make_float4(fminf(u.x, b.x), fminf(u.y, b.y), fmaxf(u.z, b.z), fmaxf(u.w, b.w));
    }
    supers[(size_t)pose * f.nsb + sb] = u;
  }
}

__device__ __forceinline__ bool box_meets(float4 b, float x_lo, float x_hi, float y_lo,
                                          float y_hi) {
  return b.x <= x_hi && b.z >= x_lo && b.y <= y_hi && b.w >= y_lo;
}

// Append `value` to a shared list when `keep`, one shared atomic a warp.
__device__ __forceinline__ void append(bool keep, int value, int* list, int* count) {
  const unsigned mask = __ballot_sync(kFull, keep);
  const int lane = threadIdx.x & 31;
  int base = 0;
  if (lane == 0 && mask) base = atomicAdd(count, __popc(mask));
  base = __shfl_sync(kFull, base, 0);
  if (keep) list[base + __popc(mask & ((1u << lane) - 1u))] = value;
}

// One CTA per (pose, TW x TH screen tile of the ROI). grid: n_pose * tiles
// CTAs; dynamic shared memory: the tile's TW * TH int32 keys. At most 64
// registers, so that 4 CTAs (32 warps) share an SM in place of 3: the walk
// waits on latency more than on issue (faster at the large shapes).
template <int TW, int TH>
__global__ void __launch_bounds__(kThreads, 4)
raster_kernel(const float* __restrict__ table, const int* __restrict__ ids,
              const float* __restrict__ poses, const float* __restrict__ proj, Frame f,
              const float4* __restrict__ blocks, const float4* __restrict__ supers,
              int* __restrict__ fb, int out_h, int out_w, int height, int rx, int ry,
              int tiles_x, int tiles) {
  extern __shared__ int4 dyn[];  // the tile's least order_key a pixel; INT_MAX = none
  int* tile_fb = reinterpret_cast<int*>(dyn);
  __shared__ float sm[32];
  __shared__ int sb_list[kThreads];
  __shared__ int blk_list[kThreads];
  __shared__ WarpTri wtri[kThreads / 32][32];
  __shared__ int n_sb, n_blk;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pose = blockIdx.x / tiles, tile = blockIdx.x - pose * tiles;
  constexpr int kPix = TW * TH / kThreads;  // pixels a thread writes, 4 at a time
  static_assert(kPix % 4 == 0 && TW % 4 == 0, "a thread writes whole 16-byte groups");
  const int col0 = (tile % tiles_x) * TW, row0 = (tile / tiles_x) * TH;
  // the tile in the flipped-y P space, clipped to the ROI
  const int ix_lo = rx + col0, ix_hi = rx + min(col0 + TW, out_w) - 1;
  const int iy_hi = height - 1 - ry - row0;
  const int iy_lo = height - ry - min(row0 + TH, out_h);
  const float x_lo = (float)ix_lo, x_hi = (float)ix_hi;
  const float y_lo = (float)iy_lo, y_hi = (float)iy_hi;

  load_pose(sm, poses, proj, pose);
  for (int i = tid * 4; i < TH * TW; i += kThreads * 4) {
    *reinterpret_cast<int4*>(tile_fb + i) = make_int4(INT_MAX, INT_MAX, INT_MAX, INT_MAX);
  }
  const float* mesh = mesh_of(table, ids, f, pose);
  const float4* pose_blocks = blocks + (size_t)pose * f.nb;
  const float4* pose_supers = supers + (size_t)pose * f.nsb;
  WarpTri* mine = wtri[warp];

  for (int s0 = 0; s0 < f.nsb; s0 += kThreads) {
    if (s0 > 0) __syncthreads();  // every thread has read the previous round's n_sb
    if (tid == 0) n_sb = 0;
    __syncthreads();
    const int s = s0 + tid;
    append(s < f.nsb && box_meets(__ldg(pose_supers + s), x_lo, x_hi, y_lo, y_hi), s, sb_list,
           &n_sb);
    __syncthreads();
    const int ns = n_sb;
    for (int k0 = 0; k0 < ns; k0 += kThreads / kSuper) {
      if (tid == 0) n_blk = 0;
      __syncthreads();
      const int k = k0 + tid / kSuper;
      const int b = k < ns ? sb_list[k] * kSuper + tid % kSuper : f.nb;
      append(b < f.nb && box_meets(__ldg(pose_blocks + b), x_lo, x_hi, y_lo, y_hi), b,
             blk_list, &n_blk);
      __syncthreads();
      const int nbk = n_blk;
      // a warp a block: each lane sets up one triangle and keeps it if its
      // box meets the tile; then the warp walks the kept boxes together,
      // cut into chunks of kChunk consecutive pixels, a chunk a lane at a
      // time, so a lane's share does not depend on its triangle's size
      for (int j = warp; j < nbk; j += kThreads / 32) {
        const int tri = blk_list[j] * kBlock + lane;
        int area = 0;
        WarpTri w;
        if (tri < f.n_tri) {
          float v[9];
          load_triangle(mesh, tri, f.n_tri, v);
          const Screen sc = screen_triangle(v, sm, sm + 16, f);
          Setup t;
          float inv;
          triangle_box(sc, f, t.xs, t.ys, t.xm, t.ym, inv);
          const float x0 = fmaxf(t.xs, x_lo), x1 = fminf(t.xm, x_hi);
          const float y0 = fmaxf(t.ys, y_lo), y1 = fminf(t.ym, y_hi);
          if (t.xs <= t.xm && t.ys <= t.ym && x0 <= x1 && y0 <= y1) {
            // integer pixels p with xs <= p <= xm inside the tile
            const int ix0 = (int)ceilf(x0), ix1 = (int)floorf(x1);
            const int iy0 = (int)ceilf(y0), iy1 = (int)floorf(y1);
            if (ix0 <= ix1 && iy0 <= iy1) {
              triangle_coef(sc, inv, t);
              area = (ix1 - ix0 + 1) * (iy1 - iy0 + 1);
              w = WarpTri{t.kbx, t.kby, t.kb0, t.kgx, t.kgy, t.kg0, t.ddx, t.ddy, t.dd0,
                          iy1, ix1 - ix0 + 1, area, __frcp_rn((float)(ix1 - ix0 + 1)),
                          (float)ix0, (iy_hi - iy1) * TW + (ix0 - ix_lo), 0};
            }
          }
        }
        const int chunks = (area + kChunk - 1) / kChunk;
        int incl = chunks;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int up = __shfl_up_sync(kFull, incl, o);
          if (lane >= o) incl += up;
        }
        const int total = __shfl_sync(kFull, incl, 31);
        const int first = incl - chunks;  // this lane's first chunk
        // the kept triangles, compacted in lane order: their first chunks rise
        const unsigned kept = __ballot_sync(kFull, chunks > 0);
        if (chunks > 0) {
          w.start = first;
          mine[__popc(kept & ((1u << lane) - 1u))] = w;
        }
        __syncwarp();
        for (int c0 = 0; c0 < total; c0 += 32) {
          // chunk c0 + lane belongs to the last kept triangle whose first
          // chunk is <= it: those that start before c0, plus those that
          // start in [c0, c0 + lane] (one bit each in `starts`)
          const int before = __reduce_add_sync(kFull, chunks > 0 && first < c0 ? 1 : 0);
          const int rel = first - c0;
          const unsigned starts =
              __reduce_or_sync(kFull, chunks > 0 && rel >= 0 && rel < 32 ? 1u << rel : 0u);
          if (c0 + lane < total) {
            const unsigned upto = lane == 31 ? starts : starts & ((2u << lane) - 1u);
            const WarpTri c = mine[before + __popc(upto) - 1];
            const int px0 = (c0 + lane - c.start) * kChunk;
            // the chunk's first pixel (its row exact: px0 < 2^13, w <= 256),
            // then a step along the row, wrapping to the next: pixel
            // coordinates stay floats (integers, exact), so no pixel pays an
            // int <-> float conversion
            const int r = (int)(((float)px0 + 0.5f) * c.inv_w);
            int col = px0 - r * c.w;
            int at = c.at0 + r * TW + col;
            float px = __fadd_rn(c.x0, (float)col), py = (float)(c.iy1 - r);
            const int n = min(kChunk, c.area - px0);
#pragma unroll
            for (int e = 0; e < kChunk; ++e) {
              const int key = pixel_key(c, px, py);
              if (e < n && key != INT_MAX) atomicMin(tile_fb + at, key);
              ++col;
              ++at;
              px = __fadd_rn(px, 1.0f);
              if (col == c.w) {
                col = 0;
                at += TW - c.w;
                px = c.x0;
                py = __fsub_rn(py, 1.0f);
              }
            }
          }
        }
        __syncwarp();  // the block's entries are read before the next overwrites them
      }
      __syncthreads();  // blk_list is consumed
    }
  }
  __syncthreads();

  // write the tile once, 16 bytes at a time: 0 where no triangle won
#pragma unroll
  for (int q = 0; q < kPix / 4; ++q) {
    const int i = (q * kThreads + tid) * 4, r = i / TW, c = i % TW;
    const int row = row0 + r, col = col0 + c;
    if (row >= out_h || col >= out_w) continue;
    int4 v = *reinterpret_cast<const int4*>(tile_fb + i);
    v.x = v.x == INT_MAX ? 0 : (int)truncf(key_value(v.x));
    v.y = v.y == INT_MAX ? 0 : (int)truncf(key_value(v.y));
    v.z = v.z == INT_MAX ? 0 : (int)truncf(key_value(v.z));
    v.w = v.w == INT_MAX ? 0 : (int)truncf(key_value(v.w));
    const size_t at = ((size_t)pose * out_h + row) * out_w + col;
    if (col + 3 < out_w && (at & 3) == 0) {
      *reinterpret_cast<int4*>(fb + at) = v;
    } else {
      const int vals[4] = {v.x, v.y, v.z, v.w};
      for (int e = 0; e < 4 && col + e < out_w; ++e) fb[at + e] = vals[e];
    }
  }
}

// The setup of every (pose, triangle) into coef (N, 16, T), as
// triangle_setup lays it out: the tests' per-field check of the kernel's
// arithmetic. One thread a pair.
__global__ void setup_kernel(const float* __restrict__ table, const int* __restrict__ ids,
                             const float* __restrict__ poses, const float* __restrict__ proj,
                             Frame f, int n_pose, float* __restrict__ coef) {
  const long long gid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (gid >= (long long)n_pose * f.n_tri) return;
  const int pose = (int)(gid / f.n_tri), tri = (int)(gid - (long long)pose * f.n_tri);
  float M[16], P[16];
  for (int i = 0; i < 16; ++i) {
    M[i] = poses[(size_t)pose * 16 + i];
    P[i] = proj[i];
  }
  float v[9];
  load_triangle(mesh_of(table, ids, f, pose), tri, f.n_tri, v);
  const Screen s = screen_triangle(v, M, P, f);
  Setup t;
  float inv;
  triangle_box(s, f, t.xs, t.ys, t.xm, t.ym, inv);
  triangle_coef(s, inv, t);
  const float fields[16] = {t.kbx, t.kby, t.kb0, t.kgx, t.kgy, t.kg0, t.ddx, t.ddy, t.dd0,
                            t.xs, t.ys, t.xm, t.ym, 0.0f, 0.0f, 0.0f};
  float* out = coef + (size_t)pose * 16 * f.n_tri + tri;
  for (int i = 0; i < 16; ++i) out[(size_t)i * f.n_tri] = fields[i];
}

Frame make_frame(int n_mesh, int n_tri, int width, int height, int rx, int ry, int out_w,
                 int out_h) {
  Frame f;
  f.hw = 0.5f * (float)width;
  f.hh = 0.5f * (float)height;
  // ops/rasterize.py::_clamp_bounds: the ROI in flipped-y P space (the
  // whole frame is the ROI (0, 0, width, height))
  f.cmin_x = (float)rx;
  f.cmin_y = (float)(height - ry - out_h);
  f.cmax_x = (float)(rx + out_w - 1);
  f.cmax_y = (float)(height - 1 - ry);
  f.n_tri = n_tri;
  f.n_mesh = n_mesh;
  f.nb = (n_tri + kBlock - 1) / kBlock;
  f.nsb = (n_tri + kThreads - 1) / kThreads;
  return f;
}

template <int TW, int TH>
cudaError_t launch_raster(const float* table, const int* ids, const float* poses,
                          const float* proj, const Frame& f, const float4* blocks,
                          const float4* supers, int* fb, int n_pose, int out_h, int out_w,
                          int height, int rx, int ry, cudaStream_t s) {
  const int tiles_x = (out_w + TW - 1) / TW, tiles_y = (out_h + TH - 1) / TH;
  const long long tiles = (long long)tiles_x * tiles_y;
  const int fb_bytes = TW * TH * (int)sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(raster_kernel<TW, TH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, fb_bytes);
  if (err != cudaSuccess) return err;
  raster_kernel<TW, TH><<<(unsigned)(n_pose * tiles), kThreads, fb_bytes, s>>>(
      table, ids, poses, proj, f, blocks, supers, fb, out_h, out_w, height, rx, ry, tiles_x,
      (int)tiles);
  return cudaGetLastError();
}

}  // namespace

// Render n_pose poses of the mesh table (n_mesh, n_tri, 3, 3) into fb
// (n_pose, out_h, out_w) int32 mm, 0 = empty, on `stream`. Pose i renders
// table[ids[i]] (ids clamped into the table); ids == nullptr renders the
// one mesh (n_mesh == 1) or mesh i (n_mesh == n_pose). The ROI is (rx, ry,
// out_w, out_h) of the width x height frame. scratch holds 4 floats a 32
// triangles and a 256 of every pose (the block and superblock boxes),
// 16-byte aligned. Returns the
// cudaError_t of the launches (0 = ok).
extern "C" int prt_rasterize(const float* table, const int* ids, int n_mesh, int n_tri,
                             const float* poses, int n_pose, const float* proj, int width,
                             int height, int rx, int ry, int out_w, int out_h, int* fb,
                             float* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_pose <= 0 || out_w <= 0 || out_h <= 0) return 0;
  const Frame f = make_frame(n_mesh, n_tri, width, height, rx, ry, out_w, out_h);
  float4* blocks = reinterpret_cast<float4*>(scratch);
  float4* supers = blocks + (size_t)n_pose * f.nb;
  if (n_tri > 0) {
    bin_kernel<<<(unsigned)((long long)n_pose * f.nsb), kThreads, 0, s>>>(table, ids, poses, proj,
                                                                          f, blocks, supers);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long wide = (long long)((out_w + kWideW - 1) / kWideW) *
                         ((out_h + kWideH - 1) / kWideH);
  cudaError_t err;
  if (n_pose * wide >= (long long)kWideCtas * sms) {
    err = launch_raster<kWideW, kWideH>(table, ids, poses, proj, f, blocks, supers, fb, n_pose,
                                        out_h, out_w, height, rx, ry, s);
  } else {
    err = launch_raster<kTileW, kTileH>(table, ids, poses, proj, f, blocks, supers, fb, n_pose,
                                        out_h, out_w, height, rx, ry, s);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The kernel's triangle setup of every (pose, triangle) into coef
// (n_pose, 16, n_tri) float32, laid out as ops/rasterize_cuda.py::
// triangle_setup. For tests.
extern "C" int prt_raster_setup(const float* table, const int* ids, int n_mesh, int n_tri,
                                const float* poses, int n_pose, const float* proj, int width,
                                int height, int rx, int ry, int out_w, int out_h, float* coef,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = (long long)n_pose * n_tri;
  if (n <= 0) return 0;
  const Frame f = make_frame(n_mesh, n_tri, width, height, rx, ry, out_w, out_h);
  setup_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(table, ids, poses, proj, f, n_pose,
                                                          coef);
  return (int)cudaGetLastError();
}

extern "C" const char* prt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
