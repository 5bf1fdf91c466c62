// Exact nearest neighbour by the stackless kd traversal for Hopper (sm_90a):
// idx (Q,) int32 and dist^2 (Q,) float32 of every query, and optionally its
// step count.
//
// What it replaces: pose_refine_tpu/scene/nn.py::_nn_kdtree (:638-725), the
// JAX package's kd search - XLA code (a vmapped lax.while_loop), not a Pallas
// kernel - which is itself the reference's device search
// (cuda_icp/scene/pcd_scene/pcd_scene.h:61-136): descend, scan a leaf,
// backtrack by parent pointers, with no recursion and no stack.
//
// The walk of one query (JAX prune="far"), one thread a query, state (cur,
// last, back, best index, best dist^2, steps) from (0, -1, false, 0, FLT_MAX,
// 0); a step reads node `cur` and does one of three things:
//  * descending at an interior node: go to the near child, the one on the
//    query's side of the split (p[split_dim] - split_v < 0: child 0);
//  * descending at a leaf: scan its points in order and keep the first that
//    is strictly nearer than the best so far; then back up to the parent;
//  * backing up into a node from its near child: enter the far child iff the
//    far child's own box lies no farther than the best dist^2; else, and
//    from the far child, back up on.
// The walk ends at the root's parent (-1) or at max_steps = 3 M + 2, which it
// cannot reach. Ties go to the point scanned first, as JAX's argmin gives.
//
// The design, for the H100:
//  * One table of 16-byte rows (scene/kdtree.py::KDTreeDevice): a node is
//    one row - [parent, child0, split_v, split_dim] or, for a leaf,
//    [parent, -1, left, right]; siblings are consecutive - so a step is one
//    load; a box is two rows, a point one.
//  * A tree whose table fits a CTA's shared memory (227 KB on the H100; the
//    2 mm bench cloud's table is 111,776 bytes) is walked by persistent
//    CTAs of 1,024 threads, one an SM: each stages the whole table once,
//    then its warps take 32-query tiles from a global counter until none is
//    left, so every read of a walk is a shared-memory load. The last warp
//    to finish resets the counter.
//  * A larger tree (the raw cloud's 8,369 nodes, 0.87 MB) is walked by a
//    grid of 128-thread CTAs through the read-only L1 path. Staging a
//    prefix of it (rows below a count from shared memory, the rest from
//    global memory) measured slower at every budget, as the staged bytes
//    come out of the L1 that holds the rest (PERF.md), so the launcher
//    (scene/nn_kdtree.py::KDLaunch) picks the kernel by the tree's size
//    alone.
//  * The far-box test first asks the split plane: the far child's box face
//    on the split axis lies at or beyond split_v (the builder's split_v is
//    the midpoint of the gap between the two sides, and
//    KDTreeDevice.from_tree refuses a tree where it is not), so its dist^2 is at
//    least the rounded square of p[split_dim] - split_v (each term of
//    fma(dz, dz, fma(dy, dy, dx * dx)) only adds, rounding is monotone).
//    When that square exceeds the best the far child is not entered, as the
//    box would decide, and the box is not read.
//
// Rounding: dist^2 = fma(dz, dz, fma(dy, dy, dx * dx)) with d = point -
// query, and the box distance in the same form over max(lo - p, 0) +
// max(p - hi, 0), NaN propagating as in jnp.maximum (PTX max.NaN): the order
// XLA's CPU backend gives the JAX function. Every operation is an _rn
// intrinsic, so nvcc contracts nothing else, and the kernel equals the plain
// PyTorch version (scene/nn_kdtree.py::nn_kdtree_plain) bit for bit in idx,
// dist^2 and steps; that version equals JAX on the CPU.

#include <cuda_runtime.h>

#include <algorithm>
#include <cfloat>

namespace {

constexpr int kThreads = 1024;  // a persistent CTA
constexpr int kCtasPerSm = 1;
constexpr int kWarps = kThreads / 32;
constexpr int kGridThreads = 128;  // a CTA of the grid kernel
constexpr int kTile = 32;
constexpr unsigned kFull = 0xffffffffu;

// jnp.maximum(x, 0.f): NaN propagates (fmaxf would return 0)
__device__ __forceinline__ float max0(float x) {
  float r;
  asm("max.NaN.f32 %0, %1, 0f00000000;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float sq3(float a, float b, float c) {
  return __fmaf_rn(c, c, __fmaf_rn(b, b, __fmul_rn(a, a)));
}

// max(lo - p, 0) + max(p - hi, 0), JAX's per-axis box distance
__device__ __forceinline__ float gap(float lo, float p, float hi) {
  return __fadd_rn(max0(__fsub_rn(lo, p)), max0(__fsub_rn(p, hi)));
}

// Where a walk reads the table's three parts (records, boxes, points):
// shared memory, the whole table staged, or global memory through the
// read-only path.
template <bool kShared>
struct Rows {
  const float4* p[3];

  __device__ __forceinline__ float4 get(int part, int i) const {
    return kShared ? p[part][i] : __ldg(p[part] + i);
  }
};

// The walk of query q; writes its idx, dist^2 and steps.
template <bool kShared>
__device__ __forceinline__ void walk(const Rows<kShared>& t, const float* __restrict__ queries,
                                     int q, int max_steps, int* __restrict__ idx_out,
                                     float* __restrict__ dist_out, int* __restrict__ steps_out) {
  const float p0 = __ldg(queries + 3 * q), p1 = __ldg(queries + 3 * q + 1),
              p2 = __ldg(queries + 3 * q + 2);
  int cur = 0, last = -1, bi = 0, steps = 0;
  bool back = false;
  float bd = FLT_MAX;
  while (cur >= 0 && steps < max_steps) {
    const float4 a = t.get(0, cur);
    const int par = __float_as_int(a.x), c0 = __float_as_int(a.y);
    const int sd = __float_as_int(a.w);
    const float pc = sd == 0 ? p0 : (sd == 1 ? p1 : p2);
    const float off = __fsub_rn(pc, a.z);  // p[split_dim] - split_v
    const bool near0 = off < 0.f;
    const int best = near0 ? c0 : c0 + 1;
    const int other = near0 ? c0 + 1 : c0;
    int next;
    if (back) {
      // back into an interior node; from its near child, the far child is
      // entered iff its box lies no farther than the best (the split plane
      // first: see the top of the file)
      bool go_far = false;
      if (last == best && !(__fmul_rn(off, off) > bd)) {
        const float4 lo = t.get(1, 2 * other), hi = t.get(1, 2 * other + 1);
        go_far = sq3(gap(lo.x, p0, hi.x), gap(lo.y, p1, hi.y), gap(lo.z, p2, hi.z)) <= bd;
      }
      next = go_far ? other : par;
      back = !go_far;
    } else if (c0 < 0) {
      // a leaf, entered descending: its points in order, each taken iff
      // strictly nearer than the best so far; then back up
      const int left = __float_as_int(a.z), right = __float_as_int(a.w);
      for (int i = left; i < right; ++i) {
        const float4 s = t.get(2, i);
        const float d2 = sq3(__fsub_rn(s.x, p0), __fsub_rn(s.y, p1), __fsub_rn(s.z, p2));
        if (d2 < bd) {
          bd = d2;
          bi = i;
        }
      }
      next = par;
      back = true;
    } else {
      next = best;
    }
    last = cur;
    cur = next;
    ++steps;
  }
  idx_out[q] = bi;
  dist_out[q] = bd;
  if (steps_out != nullptr) steps_out[q] = steps;
}

// One query a thread, the table through L1.
__global__ void __launch_bounds__(kGridThreads)
    nn_kdtree_grid(const float* __restrict__ queries, int nq, const float4* __restrict__ table,
                   int m, int max_steps, int* __restrict__ idx_out, float* __restrict__ dist_out,
                   int* __restrict__ steps_out) {
  const int q = blockIdx.x * kGridThreads + threadIdx.x;
  if (q >= nq) return;
  const Rows<false> t{{table, table + m, table + 3 * m}};
  walk(t, queries, q, max_steps, idx_out, dist_out, steps_out);
}

// Persistent CTAs: stage the whole table (rows of 16 bytes, m nodes), then
// each warp walks 32-query tiles, one query a lane, taken from counters[0];
// the last warp resets the counters.
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
    nn_kdtree_staged(const float* __restrict__ queries, int nq, const float4* __restrict__ table,
                     int rows, int m, int max_steps, int* __restrict__ counters,
                     int* __restrict__ idx_out, float* __restrict__ dist_out,
                     int* __restrict__ steps_out) {
  extern __shared__ float4 smem[];
  for (int i = threadIdx.x; i < rows; i += kThreads) smem[i] = __ldg(table + i);
  __syncthreads();
  const Rows<true> t{{smem, smem + m, smem + 3 * m}};
  const int lane = threadIdx.x & 31;
  while (true) {
    int tile = 0;
    if (lane == 0) tile = atomicAdd(counters, kTile);
    tile = __shfl_sync(kFull, tile, 0);
    if (tile >= nq) break;
    if (tile + lane < nq) walk(t, queries, tile + lane, max_steps, idx_out, dist_out, steps_out);
  }
  if (lane == 0) {
    __threadfence();
    if (atomicAdd(counters + 1, 1) == (int)gridDim.x * kWarps - 1) {
      counters[0] = 0;
      counters[1] = 0;
    }
  }
}

int launch_staged(const float* queries, int nq, const float4* table, int rows, int m,
                  int max_steps, int* counters, int* idx, float* dist_sq, int* steps,
                  cudaStream_t stream) {
  // the dynamic shared memory allowed so far, per device
  static int allowed[64] = {0};
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int smem = 16 * rows;
  if (dev >= 64 || smem > allowed[dev]) {
    err = cudaFuncSetAttribute(nn_kdtree_staged, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) allowed[dev] = smem;
  }
  const long long tiles = ((long long)nq + kTile - 1) / kTile;
  const int ctas = (int)std::max(1LL, std::min((long long)sms * kCtasPerSm,
                                               (tiles + kWarps - 1) / kWarps));
  nn_kdtree_staged<<<ctas, kThreads, smem, stream>>>(queries, nq, table, rows, m, max_steps,
                                                     counters, idx, dist_sq, steps);
  return (int)cudaGetLastError();
}

}  // namespace

// idx (nq,) int32 and dist_sq (nq,) float32 of nq queries (nq, 3) float32
// on `stream`; steps (nq,) int32 or null. table: the (3 m + p, 4) float32
// rows of scene/kdtree.py::KDTreeDevice, contiguous and 16-byte aligned;
// counters: two int32, 0 before the first launch (each launch leaves them
// 0). whole: 1 stages the whole table in shared memory and walks it with
// the persistent kernel (a table larger than a CTA's shared memory fails
// with the runtime's error), 0 walks it with the grid kernel; the caller
// picks by the table's size (scene/nn_kdtree.py::STAGE_CAP_BYTES). Returns
// the cudaError_t of the launch (0 = ok).
extern "C" int prt_nn_kdtree(const float* queries, int nq, const void* table, int m, int p,
                             int max_steps, int whole, int* counters, int* idx, float* dist_sq,
                             int* steps, void* stream) {
  if (nq <= 0) return 0;
  if (queries == nullptr || table == nullptr || counters == nullptr || idx == nullptr ||
      dist_sq == nullptr || m < 1 || p < 1 || max_steps < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const float4* t = static_cast<const float4*>(table);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (whole) {
    return launch_staged(queries, nq, t, 3 * m + p, m, max_steps, counters, idx, dist_sq, steps,
                         s);
  }
  const int ctas = (int)(((long long)nq + kGridThreads - 1) / kGridThreads);
  nn_kdtree_grid<<<ctas, kGridThreads, 0, s>>>(queries, nq, t, m, max_steps, idx, dist_sq, steps);
  return (int)cudaGetLastError();
}
