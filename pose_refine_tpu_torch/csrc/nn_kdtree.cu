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
// One thread a query, its whole state in registers: cur, last, back, the
// best index and dist^2, and the step count, from (0, -1, false, 0, FLT_MAX,
// 0). A step reads node `cur` (two 16-byte loads of the packed record, see
// scene/kdtree.py::KDTreeDevice) and then does one of three things:
//  * descending at an interior node: go to the near child, the one on the
//    query's side of the split (p[split_dim] - split_v < 0: child 0);
//  * descending at a leaf: scan its points in order (one 16-byte load each)
//    and keep the first that is strictly nearer than the best so far; then
//    back up to the parent;
//  * backing up into a node from its near child: enter the far child iff the
//    far child's own box (two more loads) lies no farther than the best
//    dist^2 (JAX prune="far"); else, and from the far child, back up on.
// The walk ends at the root's parent (-1) or at max_steps = 3 M + 2, which it
// cannot reach. Ties go to the point scanned first, as JAX's argmin gives.
//
// Rounding: dist^2 = fma(dz, dz, fma(dy, dy, dx * dx)) with d = point -
// query, and the box distance in the same form over
// max(lo - p, 0) + max(p - hi, 0), NaN propagating as in jnp.maximum: the
// order XLA's CPU backend gives the JAX function. Every operation is an _rn
// intrinsic, so nvcc contracts nothing else, and the kernel equals the plain
// PyTorch version (scene/nn_kdtree.py::nn_kdtree_plain) bit for bit in idx,
// dist^2 and steps; that version equals JAX on the CPU.
//
// What bounds it on the H100: latency, not bytes or arithmetic. Each step's
// loads depend on the step before (the next node's index comes out of this
// node's record), so a warp waits one L2 round trip (~0.3-0.6 us) a step,
// and lanes of a warp that backtrack to different nodes diverge. The tree
// arrays of the bench's raw cloud (29,440 points: ~6,000 nodes, 0.4 MB of
// nodes and boxes, 0.5 MB of points) sit in L2 and are read through the
// read-only cache. The queries come Morton-ordered from the lift, so the
// lanes of a warp mostly walk the same path. The bound chip_smoke.py
// reports takes the operations a walk of this run's queries needs (its step
// and leaf-point counts, from the plain version) at the card's FP32 rate;
// the dependent chain, which no such bound counts, is what the kernel
// waits on. Keeping the top of the tree in shared memory is left for later.

#include <cuda_runtime.h>

#include <cfloat>

namespace {

constexpr int kThreads = 128;

// jnp.maximum(x, 0.f): NaN propagates (fmaxf would return 0)
__device__ __forceinline__ float max0(float x) { return (x != x) ? x : fmaxf(x, 0.f); }

__device__ __forceinline__ float sq3(float a, float b, float c) {
  return __fmaf_rn(c, c, __fmaf_rn(b, b, __fmul_rn(a, a)));
}

__global__ void __launch_bounds__(kThreads)
    nn_kdtree_kernel(const float* __restrict__ queries, int nq, const int4* __restrict__ nodes,
                     const float4* __restrict__ boxes, const float4* __restrict__ points,
                     int max_steps, int* __restrict__ idx_out, float* __restrict__ dist_out,
                     int* __restrict__ steps_out) {
  const int q = blockIdx.x * kThreads + threadIdx.x;
  if (q >= nq) return;
  const float p[3] = {__ldg(queries + 3 * q), __ldg(queries + 3 * q + 1),
                      __ldg(queries + 3 * q + 2)};
  int cur = 0, last = -1, bi = 0, steps = 0;
  bool back = false;
  float bd = FLT_MAX;
  while (cur >= 0 && steps < max_steps) {
    const int4 a = __ldg(nodes + 2 * cur);      // child0, child1, parent, split_dim
    const int4 b = __ldg(nodes + 2 * cur + 1);  // split_v bits, left, right, 0
    const float pc = a.w == 0 ? p[0] : (a.w == 1 ? p[1] : p[2]);
    const bool near0 = __fsub_rn(pc, __int_as_float(b.x)) < 0.f;
    const int best = near0 ? a.x : a.y;
    const int other = near0 ? a.y : a.x;
    const bool leaf = a.x < 0 || a.y < 0;
    int next;
    if (back) {
      bool go_far = false;
      if (last == best) {
        const float4 lo = __ldg(boxes + 2 * other);
        const float4 hi = __ldg(boxes + 2 * other + 1);
        const float dx = __fadd_rn(max0(__fsub_rn(lo.x, p[0])), max0(__fsub_rn(p[0], hi.x)));
        const float dy = __fadd_rn(max0(__fsub_rn(lo.y, p[1])), max0(__fsub_rn(p[1], hi.y)));
        const float dz = __fadd_rn(max0(__fsub_rn(lo.z, p[2])), max0(__fsub_rn(p[2], hi.z)));
        go_far = sq3(dx, dy, dz) <= bd;
      }
      next = go_far ? other : a.z;
      back = !go_far;
    } else if (leaf) {
      for (int i = b.y; i < b.z; ++i) {
        const float4 s = __ldg(points + i);
        const float d2 =
            sq3(__fsub_rn(s.x, p[0]), __fsub_rn(s.y, p[1]), __fsub_rn(s.z, p[2]));
        if (d2 < bd) {
          bd = d2;
          bi = i;
        }
      }
      next = a.z;
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

}  // namespace

// idx (nq,) int32 and dist_sq (nq,) float32 of nq queries (nq, 3) float32
// on `stream`; steps (nq,) int32 or null. nodes (M, 8) int32 and boxes (M, 8)
// float32 as scene/kdtree.py::KDTreeDevice packs them, points (P, 4)
// float32, all contiguous and 16-byte aligned. Returns the cudaError_t of
// the launch (0 = ok).
extern "C" int prt_nn_kdtree(const float* queries, int nq, const void* nodes, const float* boxes,
                             const float* points, int max_steps, int* idx, float* dist_sq,
                             int* steps, void* stream) {
  if (nq <= 0) return 0;
  if (queries == nullptr || nodes == nullptr || boxes == nullptr || points == nullptr ||
      idx == nullptr || dist_sq == nullptr || max_steps < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned grid = (unsigned)((nq + kThreads - 1) / kThreads);
  nn_kdtree_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      queries, nq, static_cast<const int4*>(nodes), reinterpret_cast<const float4*>(boxes),
      reinterpret_cast<const float4*>(points), max_steps, idx, dist_sq, steps);
  return (int)cudaGetLastError();
}
