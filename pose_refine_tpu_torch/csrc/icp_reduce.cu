// One ICP iteration of every pose in one launch, for Hopper (sm_90a):
// icp_iterate_kernel, behind the C entry prt_icp_iterate. Per pose, the
// association of its P points and the sum of the packed vector [21
// upper-triangular AtA | 6 Atb | point-to-point mse | count] (slab_sums),
// then the pose's tail - the scores, the done latch, the damped 6x6 solve,
// the twist, the cloud's move and T <- upd @ T - the body of the JAX
// package's icp._icp_run step (pose_refine_tpu/icp.py:398-428).
//
// The port's own kernel. Its pass is the reference's single transform_reduce
// over thrust__pcd2Ab (icp.h:125-209, icp.cu:170-172), in which each point
// looks its neighbour up and maps to 29 floats, and the function of the JAX
// package's _normal_equations_packed (pose_refine_tpu/icp.py:215-238) with
// the scene query inlined. On the TPU the query's row gather cannot live in
// a Pallas body (scripts/probe_pallas_gather.py::gather_pallas is the probe
// that tried), so there the rows go through device memory between the
// association and the reduction; csrc/gather.cu ported that step alone.
// Here the thread that fetches a row consumes it in registers: the (N, P, 8)
// row block is never written, and the dozen elementwise launches between the
// gather and the sums of a pass collapse into the kernel.
//
// Two front ends, one reduction body (template parameter kProj):
//  * projective (scene/projective.py::_project_gate, depth_scene.h:29-48):
//    the point projects to a pixel with pcd2dep's trunc(v + 0.5) rounding and
//    int32 saturation, the pixel is bounds-checked, the row is read at the
//    clipped pixel plus the pose's row offset (stacked frames), and the gate
//    is scene z > 0 and |p.z - dst.z| <= max_dist_diff. Every quotient,
//    product and sum of the projection is an _rn intrinsic, so nvcc cannot
//    contract them: the pixel and the valid bit equal the plain PyTorch
//    version's exactly, and so does the count.
//  * indexed (scene/nn.py): the row index and dist^2 come from the NN
//    kernels (flash-NN or the kd traversal); the index is clamped into the
//    table and the gate is dist^2 < max_dist^2.
//
// Two modes of the terms, one body (JAX icp.py:102-213): robust_delta > 0
// weights a point by w = v * sqrt(min(1, delta / max(|r|, 1e-12))), Huber's
// IRLS weight on the plane residual b (or on |diff|), in place of the mask v;
// point-to-point (template parameter kP2P) replaces the plane row
// [p x n, n] w and b w by the three rows J = [-[p]x | I] w and e = diff w,
// whose J^T J (21, six of them 0 for every point) and J^T e (6: (p x diff)
// w^2, each cross entry a Kahan difference of products, and diff w^2) fill
// the same 29-float layout. mse and count keep v in every mode, and robust_delta = 0
// in plane mode is the body of before the modes, bit for bit.
//
// The 28 float sums are taken in float32 (no TF32, no half), in a fixed
// order: a thread adds its points in rising order, a warp merges by the tree
// of an xor butterfly (steps 16, 8, 4, 2, 1, each halving the sums a lane
// holds, so lane l ends with sum l), the CTA's warps are added in warp
// order, and the CTAs of one pose - a thread block cluster, one CTA per slab
// of points - are added in rank order through distributed shared memory.
// The slabs a pose and the threads a CTA - 256 while two CTAs an SM hold the
// grid, else 128, four an SM - are chosen by the caller from the batch's
// shape (ops/icp_reduce.py::geometry), and with them the order. No float atomics:
// two launches on equal inputs give equal bits. Every term is rounded one
// operation at a time (no fused multiply-add), and the plain PyTorch version
// (ops/icp_reduce.py::assoc_reduce_plain) takes the same terms in the same
// order, so the kernel's sums equal it bit for bit; a matrix product or
// torch.sum orders the adds otherwise and differs in the last bits (the
// count never).
//
// A masked point contributes its terms multiplied by 0, as the plain version
// does, so a non-finite coordinate of a masked point poisons the sums in
// both; the ICP anchors padded rows to a real point for that reason.
//
// The tail: after the pose's sums are merged, warp 0 of each of the pose's
// CTAs runs it - the scores, the done latch, the damped 6x6 Cholesky solve
// with one refinement step, the twist Rz Ry Rx with sinf / cosf, T <- upd @
// T - on its own copy of the pose's state, publishes the update in its
// shared memory, and the CTA moves its own slab. Every operation is one _rn
// intrinsic, in the order of ops/icp_reduce.py::icp_iterate_plain, so
// kernel and plain version agree bit for bit in T, fitness, rmse, done and
// the cloud. Against a projective scene the table, K and the gate do not
// change between iterations, so one launch runs a refine's whole loop: a
// pose's CTAs loop until it is done, its slab kept in shared memory (2,048
// points are 24 KB), its state read and written once; no grid-wide sync is
// needed, poses are independent. Against an NN scene the NN kernel must run
// on the moved cloud between iterations, so a launch is one iteration and
// the state stays in device memory from launch to launch.
//
// What bounds it on the H100: the pass's bytes and latency, not arithmetic,
// plus the tail. A point costs 13 bytes of cloud and valid mask, one 32-byte
// row that mostly hits L2 (a 640x480 table is 9.8 MB of the 50 MB), and
// about 90 FP32 instructions (a product and its add are two); 256 poses x
// 2,048 points are 6.8 MB and 2 us at the card's rates. What the design
// does about it: each thread issues the loads of kBatch points before it
// consumes any (two dependent memory latencies a batch, not a point), the
// grid is sized to the card (a pose is split over up to 8 slabs when the
// poses alone leave SMs idle: 16 tracked hypotheses give 128 CTAs; beyond
// two CTAs an SM they are of 128 threads, so 512 poses are resident at once
// at the kernel's 128 registers a thread), and the cluster merge keeps an
// iteration at one launch. The tail overlaps nothing: the pose's CTAs wait
// for it, and the CTAs an SM holds run in step. It is one chain of ~40
// dependent correctly rounded divisions and roots (the factor's columns,
// then four substitutions), the sines and ~300 other operations: 2.0 us a
// pose on the H100 by a warp, 2.6 by one thread (compare_icp.py). What the
// design does about it: the warp takes the Cholesky factor's rows, the
// residual's rows, the three sines and the 12 entries of T on lanes, and
// every lane the diagonal's roots and the substitutions, so no shuffle sits
// between a root and its divisions; in a cluster every CTA merges the ranks'
// sums itself (their loads at once) and runs the tail, so an iteration has
// one cluster barrier, not two; the butterfly above takes 31 shuffles a
// warp, not 145; and 512 poses run in one wave. It replaces ~75 small
// PyTorch launches of the solve and update a pass, which the host, not the
// card, paid for.
//
// The coarse-to-fine point schedule (JAX icp.py:443-489) is a mode of the
// same kernel: the first coarse iterations run on a strided copy of each
// cloud (rows 0, cs, 2cs, ...), whose tail solves and moves without scores
// or latch and holds a pose with no inlier; the launch that ends the coarse
// phase then moves each pose's full cloud by its final T (the hand-off), and
// the ordinary launches run the remaining iterations from zero scores. The
// copy is contiguous, so the pass body, the slabs and the shared-memory slab
// are the ordinary ones at the copy's size: a projective refine is two
// launches, an NN refine one NN launch and one iteration launch a pass.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>

namespace cg = cooperative_groups;

namespace {

// threads a CTA: kWide while the grid's CTAs fit two an SM, kNarrow (four
// an SM) beyond that; the caller chooses (ops/icp_reduce.py::geometry)
constexpr int kWide = 256;
constexpr int kNarrow = 128;
constexpr int kSums = 29;     // 21 AtA + 6 Atb + mse + count
constexpr int kBatch = 4;     // points a thread loads before it accumulates
constexpr int kMaxSlabs = 8;  // the portable cluster size
// the largest slab (bytes of its points) the iteration kernel keeps in
// shared memory (the H100 gives a CTA up to 227 KB)
constexpr long long kSmemCloudMax = 200 * 1024;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const float* cloud;          // (N, P, 3)
  const unsigned char* valid;  // (N, P) bool
  const float4* table;         // (R, 8) as two float4 a row
  long long rows;
  int points;  // P
  int slabs;   // CTAs a pose = cluster size
  // projective front end
  const float* K;         // (3, 3) row-major intrinsics, on the device
  const float* gate;      // () max_dist_diff, on the device
  const long long* base;  // (N,) row offset of each pose's frame, or null
  int height, width;
  // indexed front end
  const void* idx;       // (N, P) int32 or int64
  const float* dist_sq;  // (N, P)
  float gate_sq;
  // the terms: Huber width (<= 0: none), point-to-point rows (template)
  float delta;
};

// geometry._trunc_int: truncation toward zero, NaN -> 0, saturating
__device__ __forceinline__ int trunc_int(float v) {
  const float t = truncf(v);
  if (t != t) return 0;
  if (t >= 2147483648.0f) return INT_MAX;
  if (t < -2147483648.0f) return INT_MIN;
  return (int)t;
}

// geometry.pcd2dep's pixel coordinate: trunc(p / z * f + c + 0.5), one
// rounded operation at a time
__device__ __forceinline__ int pixel(float p, float z, float f, float c) {
  return trunc_int(__fadd_rn(__fadd_rn(__fmul_rn(__fdiv_rn(p, z), f), c), 0.5f));
}

// min / max that carry a NaN through, as torch.clamp does (fminf / fmaxf
// return the other operand)
__device__ __forceinline__ float nan_max(float x, float lo) { return x != x ? x : fmaxf(x, lo); }
__device__ __forceinline__ float nan_min(float x, float hi) { return x != x ? x : fminf(x, hi); }

// a*b - c*d to about one rounding of the result: Kahan's difference of
// products, the error of c*d carried exactly by a fused multiply-add
// (ops/icp_reduce.py::_cross_term)
__device__ __forceinline__ float cross_term(float a, float b, float c, float d) {
  const float w = __fmul_rn(c, d);
  return __fadd_rn(__fmaf_rn(a, b, -w), __fmaf_rn(-c, d, w));
}

// sqrt of the Huber IRLS weight on the residual r (JAX icp.py:102):
// sqrt(min(1, delta / max(|r|, 1e-12)))
__device__ __forceinline__ float huber(float r, float delta) {
  return __fsqrt_rn(nan_min(__fdiv_rn(delta, nan_max(fabsf(r), 1e-12f)), 1.f));
}

// The CTA's 29 sums over points [begin, end) of pose `pose` (the pass's
// body): thread t < kSums (lane t of warp 0) returns sum t, merged over the
// CTA's warps in warp order, after a CTA barrier. Point p's coordinates are
// read at cl + 3 * (p - cl_first): the pose's cloud in device memory
// (cl_first = 0) or its slab in shared memory (cl_first = begin), by plain
// loads, since the kernel moves the cloud in place. Thread t takes points
// begin + t, begin + t + kThreads, ... in rising order.
template <int kThreads, bool kProj, bool kP2P, typename Idx>
__device__ __forceinline__ float slab_sums(const Args& a, const float* cl, int cl_first,
                                           long long pose, int begin, int end,
                                           float (*warp_sums)[kSums]) {
  constexpr int kWarps = kThreads / 32;
  const int tid = threadIdx.x;
  const long long first = pose * a.points;

  float fx = 0.f, cx = 0.f, fy = 0.f, cy = 0.f, gate = 0.f;
  long long offset = 0;
  if (kProj) {
    fx = __ldg(a.K + 0);
    cx = __ldg(a.K + 2);
    fy = __ldg(a.K + 4);
    cy = __ldg(a.K + 5);
    gate = __ldg(a.gate);
    if (a.base != nullptr) offset = __ldg(a.base + pose);
  }

  float acc[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) acc[k] = 0.f;

  for (int p0 = begin + tid; p0 < end; p0 += kThreads * kBatch) {
    float px[kBatch], py[kBatch], pz[kBatch];
    float4 ra[kBatch], rb[kBatch];
    bool ok[kBatch];
    // the loads of the whole batch, then its arithmetic
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int p = p0 + j * kThreads;
      ok[j] = false;
      if (p < end) {
        const long long i = first + p;
        const float* c = cl + 3 * (p - cl_first);
        px[j] = c[0];
        py[j] = c[1];
        pz[j] = c[2];
        ok[j] = __ldg(a.valid + i) != 0;
        long long row;
        if (kProj) {
          const int x = pixel(px[j], pz[j], fx, cx);
          const int y = pixel(py[j], pz[j], fy, cy);
          ok[j] = ok[j] && x >= 0 && x < a.width && y >= 0 && y < a.height;
          const int xc = min(max(x, 0), a.width - 1);
          const int yc = min(max(y, 0), a.height - 1);
          row = offset + (long long)yc * a.width + xc;
        } else {
          row = (long long)__ldg(static_cast<const Idx*>(a.idx) + i);
          ok[j] = ok[j] && __ldg(a.dist_sq + i) < a.gate_sq;
        }
        row = row < 0 ? 0 : (row >= a.rows ? a.rows - 1 : row);
        ra[j] = __ldg(a.table + 2 * row);
        rb[j] = __ldg(a.table + 2 * row + 1);
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (p0 + j * kThreads >= end) continue;  // past the slab: no point, no term
      const float sx = ra[j].x, sy = ra[j].y, sz = ra[j].z;  // scene point
      const float nx = ra[j].w, ny = rb[j].x, nz = rb[j].y;  // scene normal
      bool in = ok[j];
      if (kProj) in = in && sz > 0.f && fabsf(__fsub_rn(pz[j], sz)) <= gate;
      // a masked point is multiplied by 0, not skipped (see the header)
      const float v = in ? 1.f : 0.f;
      // one rounded operation an intrinsic, in the plain version's order
      // (ops/icp_reduce.py::packed_terms): nvcc contracts none of them into
      // a fused multiply-add, so every term equals the plain version's
      const float x = px[j], y = py[j], z = pz[j];
      const float dx = __fsub_rn(sx, x), dy = __fsub_rn(sy, y), dz = __fsub_rn(sz, z);
      const float sq =
          __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      if (kP2P) {
        // J = [-[p]x | I] * w, three rows; e = diff * w
        const float w = a.delta > 0.f ? __fmul_rn(v, huber(__fsqrt_rn(sq), a.delta)) : v;
        const float wx = __fmul_rn(x, w), wy = __fmul_rn(y, w), wz = __fmul_rn(z, w);
        const float ex = __fmul_rn(dx, w), ey = __fmul_rn(dy, w), ez = __fmul_rn(dz, w);
        const float ww = __fmul_rn(w, w);
        // the 21 of J^T J (the six that are 0 for every point stay 0)
        acc[0] = __fadd_rn(acc[0], __fadd_rn(__fmul_rn(wz, wz), __fmul_rn(wy, wy)));
        acc[1] = __fadd_rn(acc[1], -__fmul_rn(wy, wx));
        acc[2] = __fadd_rn(acc[2], -__fmul_rn(wz, wx));
        acc[4] = __fadd_rn(acc[4], -__fmul_rn(wz, w));
        acc[5] = __fadd_rn(acc[5], __fmul_rn(wy, w));
        acc[6] = __fadd_rn(acc[6], __fadd_rn(__fmul_rn(wz, wz), __fmul_rn(wx, wx)));
        acc[7] = __fadd_rn(acc[7], -__fmul_rn(wz, wy));
        acc[8] = __fadd_rn(acc[8], __fmul_rn(wz, w));
        acc[10] = __fadd_rn(acc[10], -__fmul_rn(wx, w));
        acc[11] = __fadd_rn(acc[11], __fadd_rn(__fmul_rn(wy, wy), __fmul_rn(wx, wx)));
        acc[12] = __fadd_rn(acc[12], -__fmul_rn(wy, w));
        acc[13] = __fadd_rn(acc[13], __fmul_rn(wx, w));
        acc[15] = __fadd_rn(acc[15], ww);
        acc[18] = __fadd_rn(acc[18], ww);
        acc[20] = __fadd_rn(acc[20], ww);
        // the 6 of J^T e: (p x diff) w^2 and diff w^2. Where diff lies along
        // the point's ray p x diff cancels, so each entry is taken to one
        // rounding (cross_term), not as a difference of rounded products
        acc[21] = __fadd_rn(acc[21], __fmul_rn(cross_term(y, dz, z, dy), ww));
        acc[22] = __fadd_rn(acc[22], __fmul_rn(cross_term(z, dx, x, dz), ww));
        acc[23] = __fadd_rn(acc[23], __fmul_rn(cross_term(x, dy, y, dx), ww));
        acc[24] = __fadd_rn(acc[24], __fmul_rn(w, ex));
        acc[25] = __fadd_rn(acc[25], __fmul_rn(w, ey));
        acc[26] = __fadd_rn(acc[26], __fmul_rn(w, ez));
      } else {
        const float b =
            __fadd_rn(__fadd_rn(__fmul_rn(dx, nx), __fmul_rn(dy, ny)), __fmul_rn(dz, nz));
        const float w = a.delta > 0.f ? __fmul_rn(v, huber(b, a.delta)) : v;
        const float bm = __fmul_rn(b, w);
        float row6[6];
        row6[0] = __fmul_rn(__fsub_rn(__fmul_rn(y, nz), __fmul_rn(z, ny)), w);
        row6[1] = __fmul_rn(__fsub_rn(__fmul_rn(z, nx), __fmul_rn(x, nz)), w);
        row6[2] = __fmul_rn(__fsub_rn(__fmul_rn(x, ny), __fmul_rn(y, nx)), w);
        row6[3] = __fmul_rn(nx, w);
        row6[4] = __fmul_rn(ny, w);
        row6[5] = __fmul_rn(nz, w);
        int k = 0;
#pragma unroll
        for (int r = 0; r < 6; ++r) {
#pragma unroll
          for (int c = r; c < 6; ++c) {
            acc[k] = __fadd_rn(acc[k], __fmul_rn(row6[r], row6[c]));
            ++k;
          }
        }
#pragma unroll
        for (int r = 0; r < 6; ++r) acc[21 + r] = __fadd_rn(acc[21 + r], __fmul_rn(row6[r], bm));
      }
      acc[27] = __fadd_rn(acc[27], __fmul_rn(sq, v));
      acc[28] = __fadd_rn(acc[28], v);
    }
  }

  // warp: the xor butterfly's tree (steps 16, 8, 4, 2, 1; a lane adds its
  // partner's value to its own), each step halving the sums a lane holds:
  // at step h the lane keeps the half of its sums whose index has the
  // lane's bit h and sends the other half, so lane l ends with sum l, the
  // value every lane of the full butterfly ends with (31 shuffles, not 145)
  const int lane = tid & 31;
  float h[16];
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    const float lo = acc[c], hi = c + 16 < kSums ? acc[min(c + 16, kSums - 1)] : 0.f;
    const bool up = lane & 16;
    h[c] = (up ? hi : lo) + __shfl_xor_sync(kFull, up ? lo : hi, 16);
  }
#pragma unroll
  for (int half = 8; half > 0; half >>= 1) {
    const bool up = lane & half;
#pragma unroll
    for (int c = 0; c < half; ++c) {
      const float lo = h[c], hi = h[c + half];
      h[c] = (up ? hi : lo) + __shfl_xor_sync(kFull, up ? lo : hi, half);
    }
  }
  if (lane < kSums) warp_sums[tid >> 5][lane] = h[0];
  __syncthreads();
  // CTA: the warps in warp order
  float total = 0.f;
  if (tid < kSums) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += warp_sums[w][tid];
  }
  return total;
}

// ---------------------------------------------------------------------------
// The iteration's state and its tail (JAX icp.py:398-428, the port's icp.py
// loop body): the pose's tail runs in one warp of each of its CTAs.

struct Iter {
  float* cloud;           // (N, P, 3), moved in place
  float* T;               // (N, 4, 4), rows 0-2 updated
  float* fitness;         // (N,)
  float* rmse;            // (N,)
  unsigned char* done;    // (N,) bool
  const float* n_total;   // (N,) the fitness divisor
  int it0, it_end;        // the iterations this launch runs
  int max_iter;           // the last (scoring-only) iteration
  float rf, rr;           // the convergence thresholds, float32
  int smem_cloud;         // 1: the slab lives in shared memory across iterations
  // the coarse phase of the coarse-to-fine point schedule (JAX icp.py:456-474):
  // cloud is the strided copy, and a pose's tail is coarse_tail (no scores,
  // no latch; fitness, rmse, done and n_total are neither read nor written)
  int coarse;
  // the hand-off (JAX icp.py:476-484), or null: after the launch's last
  // iteration every pose's full cloud (N, handoff_points, 3), the anchored
  // cloud the strided copy was cut from, is moved in place by its final T
  float* handoff;
  int handoff_points;
};

// sum k of the 21 packed AtA sums: entry (i, j), i <= j, of the upper
// triangle, row-major
__device__ __forceinline__ constexpr int upper(int i, int j) {
  return i * 6 - i * (i - 1) / 2 + (j - i);
}

// x of L L^T x = b, L the lower factor (below the diagonal) and D its
// diagonal: forward, then back substitution, each sum in rising k
// (ops/icp_reduce.py::_cho_solve_plain). Every lane of the tail's warp runs
// it on its own copy: the substitutions are one chain of dependent
// divisions, which lanes would not shorten.
__device__ __forceinline__ void cho_solve(const float (&L)[6][6], const float (&D)[6],
                                          const float (&b)[6], float (&x)[6]) {
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float v = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) v = __fsub_rn(v, __fmul_rn(L[i][k], y[k]));
    y[i] = __fdiv_rn(v, D[i]);
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float v = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) v = __fsub_rn(v, __fmul_rn(L[k][i], x[k]));
    x[i] = __fdiv_rn(v, D[i]);
  }
}

// (AtA + 0.01 I) x = Atb from the 29 sums, lane k of the warp holding sum
// k (`sk`): the Cholesky factor column by column, a solve, the residual
// r = Atb - M x in float32 and one refinement step
// (ops/icp_reduce.py::solve_damped_plain; JAX icp.py:87-99). Lane l works
// on row i = min(l, 5): in column j it takes m_ij - L_i0 L_j0 - ... -
// L_i,j-1 L_j,j-1 (k rising), and every row below divides it by L_jj; row
// j's entries reach every lane by shuffles as the columns need them, so each
// lane ends with the whole factor and takes the diagonal's sums and roots
// itself (no shuffle between a root and its divisions), and the residual's
// rows are again one a lane. Every scalar is the one-thread solve's,
// operation for operation. x (every lane).
__device__ __forceinline__ void solve_damped(float sk, float (&x)[6]) {
  const int i = min((int)(threadIdx.x & 31), 5);
  float m[6], row[6], L[6][6], D[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const float v = __shfl_sync(kFull, sk, i <= j ? upper(i, j) : upper(j, i));
    m[j] = j == i ? __fadd_rn(v, 0.01f) : v;
  }
  const float b = __shfl_sync(kFull, sk, 21 + i);
  float diag[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) diag[j] = __shfl_sync(kFull, sk, upper(j, j));
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float v = m[j];
    float d = __fadd_rn(diag[j], 0.01f);  // lane j's v, taken by every lane
#pragma unroll
    for (int k = 0; k < j; ++k) {
      L[j][k] = __shfl_sync(kFull, row[k], j);
      v = __fsub_rn(v, __fmul_rn(row[k], L[j][k]));
      d = __fsub_rn(d, __fmul_rn(L[j][k], L[j][k]));
    }
    D[j] = __fsqrt_rn(d);
    // L_ij below the diagonal. A lane on or above it divides 1 instead: its
    // sum there mixes entries no row uses, and a quotient of those can take
    // the division's slow path, which the whole warp then waits for (the
    // factor took 0.5 us longer so)
    row[j] = __fdiv_rn(i > j ? v : 1.f, D[j]);
  }
  float rhs[6], dx[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) rhs[k] = __shfl_sync(kFull, b, k);
  cho_solve(L, D, rhs, x);
  float mx = __fmul_rn(m[0], x[0]);
#pragma unroll
  for (int j = 1; j < 6; ++j) mx = __fadd_rn(mx, __fmul_rn(m[j], x[j]));
  const float r = __fsub_rn(b, mx);
#pragma unroll
  for (int k = 0; k < 6; ++k) rhs[k] = __shfl_sync(kFull, r, k);
  cho_solve(L, D, rhs, dx);
#pragma unroll
  for (int k = 0; k < 6; ++k) x[k] = __fadd_rn(x[k], dx[k]);
}

// the libm sine and cosine (sinf / cosf, not the __sinf approximations):
// torch.sin / torch.cos compute the same on the card
__device__ __forceinline__ void sin_cos(float v, float& s, float& c) {
  s = sinf(v);
  c = cosf(v);
}

// The update of one pose by the 32 lanes of a warp: from the pose's sums
// (lane k holds sum k), the damped solve, the twist Rz Ry Rx
// (geometry.euler_to_rotation's formulas in their order; lane a < 3 takes
// the sine and cosine of angle a) and T <- upd @ T in `ps` (its T, 16;
// lane e < 12 sums entry e over k in order); the update's rows [R | t]
// (12) in `step`.
__device__ __forceinline__ void update_tail(float sk, float* ps, float* step) {
  const int lane = threadIdx.x & 31;
  const int e = min(lane, 11), ei = e >> 2, ej = e & 3;
  const float T0 = ps[ej], T1 = ps[4 + ej], T2 = ps[8 + ej], T3 = ps[12 + ej];
  float x[6];
  solve_damped(sk, x);
  float s, c;
  sin_cos(lane == 0 ? x[0] : lane == 1 ? x[1] : x[2], s, c);
  const float sx = __shfl_sync(kFull, s, 0), cx = __shfl_sync(kFull, c, 0);
  const float sy = __shfl_sync(kFull, s, 1), cy = __shfl_sync(kFull, c, 1);
  const float sz = __shfl_sync(kFull, s, 2), cz = __shfl_sync(kFull, c, 2);
  float u[12];
  u[0] = __fmul_rn(cz, cy);
  u[1] = __fsub_rn(__fmul_rn(__fmul_rn(cz, sy), sx), __fmul_rn(sz, cx));
  u[2] = __fadd_rn(__fmul_rn(__fmul_rn(cz, sy), cx), __fmul_rn(sz, sx));
  u[3] = x[3];
  u[4] = __fmul_rn(sz, cy);
  u[5] = __fadd_rn(__fmul_rn(__fmul_rn(sz, sy), sx), __fmul_rn(cz, cx));
  u[6] = __fsub_rn(__fmul_rn(__fmul_rn(sz, sy), cx), __fmul_rn(cz, sx));
  u[7] = x[4];
  u[8] = -sy;
  u[9] = __fmul_rn(cy, sx);
  u[10] = __fmul_rn(cy, cx);
  u[11] = x[5];
  // entry (ei, ej) of upd @ T: ((u_i0 T_0j + u_i1 T_1j) + u_i2 T_2j) + u_i3 T_3j
  const float a0 = ei == 0 ? u[0] : ei == 1 ? u[4] : u[8];
  const float a1 = ei == 0 ? u[1] : ei == 1 ? u[5] : u[9];
  const float a2 = ei == 0 ? u[2] : ei == 1 ? u[6] : u[10];
  const float a3 = ei == 0 ? u[3] : ei == 1 ? u[7] : u[11];
  float v = __fadd_rn(__fmul_rn(a0, T0), __fmul_rn(a1, T1));
  v = __fadd_rn(v, __fmul_rn(a2, T2));
  v = __fadd_rn(v, __fmul_rn(a3, T3));
  __syncwarp();  // every lane has read T
  if (lane < 12) ps[lane] = v;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 12; ++k) step[k] = u[k];
  }
}

// The tail of one iteration of one pose, by the 32 lanes of a warp: `sk`
// the lane's sum of the pose (lane k < 29: sum k), `ps` its state [T (16),
// fitness, rmse, done], `step` the result the pose's threads read: the
// update's rows (12) and 1 where the cloud moves, else 0. The pose is not
// done on entry. Scores and latch as ops/icp_reduce.py::icp_iterate_plain
// (every lane alike), then, while not done, update_tail.
__device__ __noinline__ void iteration_tail(float sk, float* ps, float* step, float n_total,
                                            int it, int max_iter, float rf, float rr) {
  const float count = __shfl_sync(kFull, sk, 28), mse = __shfl_sync(kFull, sk, 27);
  const float fit = ps[16], rmse = ps[17];
  const bool empty = count == 0.f;
  const float new_fit = empty ? fit : __fdiv_rn(count, fmaxf(n_total, 1.f));
  const float new_rmse = empty ? rmse : __fsqrt_rn(__fdiv_rn(mse, fmaxf(count, 1.f)));
  const bool converged =
      fabsf(__fsub_rn(new_fit, fit)) < rf && fabsf(__fsub_rn(new_rmse, rmse)) < rr;
  const bool done = empty || converged || it == max_iter;
  __syncwarp();  // every lane has read the scores
  if ((threadIdx.x & 31) == 0) {
    ps[16] = new_fit;
    ps[17] = new_rmse;
    ps[18] = done ? 1.f : 0.f;
    step[12] = done ? 0.f : 1.f;
  }
  if (done) return;
  update_tail(sk, ps, step);
}

// The tail of one coarse iteration (JAX icp.py:465-474,
// ops/icp_reduce.py::icp_coarse_plain), by a warp: no scores and no latch;
// a pose with no inlier holds (step[12] = 0: T and the cloud stay), any
// other takes update_tail's step.
__device__ __noinline__ void coarse_tail(float sk, float* ps, float* step) {
  const float count = __shfl_sync(kFull, sk, 28);
  if ((threadIdx.x & 31) == 0) step[12] = count == 0.f ? 0.f : 1.f;
  if (count == 0.f) return;
  update_tail(sk, ps, step);
}

// Iterations it0 .. it_end - 1 of every pose that is not done, one pose a
// CTA or a cluster of `slabs` CTAs. Each iteration: the pass's sums
// (slab_sums, in the order of the header) in lanes 0-28 of warp 0; in a cluster every CTA publishes its sums (double-buffered by the
// iteration's parity), one cluster barrier, and warp 0 of every CTA adds
// the ranks' sums in rank order. Then warp 0 of every CTA runs the tail on
// its own copy of the pose's state - the same operations on the same sums,
// so every CTA of a pose holds the same bits - and publishes `step`; after
// one CTA barrier each thread moves the points it sums, so no barrier
// guards the cloud. A pose that is done leaves the loop, every CTA of it at
// the same iteration. The state is read once and written once a launch (by
// rank 0).
//
// The coarse mode (g.coarse) runs coarse_tail on the strided copy: a pose
// moves while it has inliers; one with none holds, and its CTAs leave the
// loop at once. That is exact: the held cloud is the cloud the empty pass
// associated, so every later iteration (JAX runs them all) would find the
// same empty association and hold again. With g.handoff set, the launch
// then moves each pose's full cloud by its final T, the points split over
// the pose's CTAs as its slabs are: ((T_i0 x + T_i1 y) + T_i2 z) + T_i3,
// each operation rounded once (ops/icp_reduce.py::transform_plain), from
// the cloud the copy was cut from, not from the moved copy.
template <int kThreads, bool kProj, bool kP2P, typename Idx>
__global__ void __launch_bounds__(kThreads, 2 * kWide / kThreads)
    icp_iterate_kernel(const Args a, const Iter g) {
  extern __shared__ float slab_cloud[];  // the slab's points, when g.smem_cloud
  __shared__ float warp_sums[kThreads / 32][kSums];
  __shared__ float cta_sums[2][32];  // a cluster: this CTA's sums, by iteration parity
  __shared__ float pose_state[19];   // T (16), fitness, rmse, done
  __shared__ float step[13];         // the update's rows (12), move

  const int tid = threadIdx.x;
  const int slab = blockIdx.x % a.slabs;
  const long long pose = blockIdx.x / a.slabs;
  if (!g.coarse && g.done[pose]) return;  // every CTA of the pose reads the same flag
  const int per_slab = (a.points + a.slabs - 1) / a.slabs;
  const int begin = slab * per_slab;
  const int end = min(begin + per_slab, a.points);
  float* pose_cloud = g.cloud + 3 * pose * a.points;
  float* cl = pose_cloud;
  int cl_first = 0;
  if (g.smem_cloud) {
    for (int p = begin + tid; p < end; p += kThreads) {
#pragma unroll
      for (int c = 0; c < 3; ++c) slab_cloud[3 * (p - begin) + c] = pose_cloud[3 * p + c];
    }
    cl = slab_cloud;
    cl_first = begin;
  }
  const float n_total = g.coarse ? 0.f : g.n_total[pose];
  if (tid < 19) {
    pose_state[tid] = tid < 16 ? g.T[16 * pose + tid]
                    : g.coarse ? 0.f
                    : tid == 16 ? g.fitness[pose] : tid == 17 ? g.rmse[pose] : 0.f;
  }
  for (int it = g.it0; it < g.it_end; ++it) {
    float total = slab_sums<kThreads, kProj, kP2P, Idx>(a, cl, cl_first, pose, begin, end,
                                                        warp_sums);
    if (a.slabs > 1) {
      cg::cluster_group cluster = cg::this_cluster();
      float* mine = cta_sums[it & 1];
      if (tid < 32) mine[tid] = total;
      cluster.sync();
      if (tid < 32) {
        // the ranks in rank order: every load first, then the adds
        float part[kMaxSlabs];
#pragma unroll
        for (int r = 0; r < kMaxSlabs; ++r) {
          part[r] = r < a.slabs ? cluster.map_shared_rank(mine, r)[tid] : 0.f;
        }
        total = part[0];
#pragma unroll
        for (int r = 1; r < kMaxSlabs; ++r) {
          if (r < a.slabs) total += part[r];
        }
      }
    }
    if (tid < 32) {
      if (g.coarse) {
        coarse_tail(total, pose_state, step);
      } else {
        iteration_tail(total, pose_state, step, n_total, it, g.max_iter, g.rf, g.rr);
      }
    }
    __syncthreads();
    if (step[12] == 0.f) break;  // done (or held, coarse): the pose moves no more
    float u[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) u[k] = step[k];
    for (int p = begin + tid; p < end; p += kThreads) {
      float* c = cl + 3 * (p - cl_first);
      const float x = c[0], y = c[1], z = c[2];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        c[i] = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(u[4 * i], x), __fmul_rn(u[4 * i + 1], y)),
                                   __fmul_rn(u[4 * i + 2], z)),
                         u[4 * i + 3]);
      }
    }
  }
  if (g.handoff != nullptr) {
    // the final T: this CTA's state, published by the last iteration's barrier
    float t[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) t[k] = pose_state[k];
    const int hp = g.handoff_points;
    const int per = (hp + a.slabs - 1) / a.slabs;
    const int hb = slab * per;
    const int he = min(hb + per, hp);
    float* full = g.handoff + 3 * pose * hp;
    for (int p = hb + tid; p < he; p += kThreads) {
      float* c = full + 3 * p;
      const float x = c[0], y = c[1], z = c[2];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        c[i] = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(t[4 * i], x), __fmul_rn(t[4 * i + 1], y)),
                                   __fmul_rn(t[4 * i + 2], z)),
                         t[4 * i + 3]);
      }
    }
  }
  // every rank's sums stay readable until every rank has read them
  if (a.slabs > 1) cg::this_cluster().sync();
  if (g.smem_cloud) {
    for (int p = begin + tid; p < end; p += kThreads) {
#pragma unroll
      for (int c = 0; c < 3; ++c) pose_cloud[3 * p + c] = slab_cloud[3 * (p - begin) + c];
    }
  }
  if (slab == 0 && tid < 19) {
    if (tid < 16) {
      g.T[16 * pose + tid] = pose_state[tid];
    } else if (g.coarse) {
      // the coarse phase keeps no scores and no latch
    } else if (tid == 16) {
      g.fitness[pose] = pose_state[16];
    } else if (tid == 17) {
      g.rmse[pose] = pose_state[17];
    } else {
      g.done[pose] = pose_state[18] != 0.f;
    }
  }
}

// sinf / cosf of n values: the tail's trigonometry, for a check against
// torch.sin / torch.cos (chip_smoke.py [icp-iterate])
__global__ void sin_cos_kernel(const float* x, int n, float* s, float* c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) sin_cos(x[i], s[i], c[i]);
}

// `kernel` over n_poses x a.slabs CTAs of `threads`, a cluster of a.slabs a
// pose, with smem_bytes of dynamic shared memory: the cudaError_t
template <typename Kernel>
int launch_clusters(Kernel kernel, int threads, const Args& a, const Iter& g, int n_poses,
                    int smem_bytes, cudaStream_t s) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((long long)n_poses * a.slabs));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = (size_t)smem_bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)a.slabs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, a, g);
}

template <bool kProj, bool kP2P, typename Idx>
int launch_iterate(const Args& a, const Iter& g, int n_poses, int threads, int smem_bytes,
                   cudaStream_t s) {
  return threads == kNarrow
             ? launch_clusters(icp_iterate_kernel<kNarrow, kProj, kP2P, Idx>, kNarrow, a, g,
                               n_poses, smem_bytes, s)
             : launch_clusters(icp_iterate_kernel<kWide, kProj, kP2P, Idx>, kWide, a, g,
                               n_poses, smem_bytes, s);
}

template <bool kProj, typename Idx>
int launch_iterate_mode(const Args& a, const Iter& g, int n_poses, int threads, int smem_bytes,
                        bool p2p, cudaStream_t s) {
  return p2p ? launch_iterate<kProj, true, Idx>(a, g, n_poses, threads, smem_bytes, s)
             : launch_iterate<kProj, false, Idx>(a, g, n_poses, threads, smem_bytes, s);
}

// The pass's arguments, checked: 0 or a cudaError_t
int fill_args(Args& a, const float* cloud, const void* valid, int n_poses, int points,
              const float* table, long long rows, int slabs, int threads, const float* K,
              const float* gate,
              const long long* base, int height, int width, const void* idx, int idx_bytes,
              const float* dist_sq, float gate_sq, float robust_delta) {
  if (points <= 0 || rows <= 0 || slabs < 1 || slabs > kMaxSlabs || (slabs & (slabs - 1)) ||
      (threads != kWide && threads != kNarrow) || (long long)n_poses * slabs >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  a.cloud = cloud;
  a.valid = static_cast<const unsigned char*>(valid);
  a.table = reinterpret_cast<const float4*>(table);
  a.rows = rows;
  a.points = points;
  a.slabs = slabs;
  a.delta = robust_delta;
  if (idx == nullptr) {
    if (K == nullptr || gate == nullptr || height <= 0 || width <= 0) {
      return (int)cudaErrorInvalidValue;
    }
    a.K = K;
    a.gate = gate;
    a.base = base;
    a.height = height;
    a.width = width;
    return 0;
  }
  if (dist_sq == nullptr || (idx_bytes != 4 && idx_bytes != 8)) {
    return (int)cudaErrorInvalidValue;
  }
  a.idx = idx;
  a.dist_sq = dist_sq;
  a.gate_sq = gate_sq;
  return 0;
}

}  // namespace

// Iterations it0 .. it_end - 1 (of 0 .. max_iter, the last scoring only) of
// the ICP of every pose on `stream`, updating in place: cloud (n_poses,
// points, 3) float32 and valid (n_poses, points) bool, contiguous; table
// (rows, 8) float32, contiguous and 16-byte aligned; slabs in {1, 2, 4, 8},
// the CTAs a pose, and threads in {256, 128}, the threads a CTA (with the
// slabs, the order of the sums; ops/icp_reduce.py::geometry chooses both from
// the batch's shape). idx == null selects the projective front end (K, gate
// and base are device pointers, base (n_poses,) int64 or null), else the
// indexed one (idx int32 or int64 by idx_bytes, dist_sq float32, both
// (n_poses, points)). robust_delta > 0 Huber-weights the terms;
// point_to_point != 0 takes the point-to-point rows. T (n_poses, 4, 4)
// float32, fitness and rmse (n_poses,) float32, done (n_poses,) bool; n_total
// (n_poses,) float32 the fitness divisors; rf, rr the convergence
// thresholds. A pose's slab stays in shared memory across the iterations when
// the launch runs more than one and it fits in kSmemCloudMax bytes. coarse !=
// 0 runs the coarse phase on the strided copy `cloud` (fitness, rmse, done
// and n_total unused, may be null); handoff, if not null, is the (n_poses,
// handoff_points, 3) full cloud, moved in place by each pose's T after the
// last iteration. Returns the cudaError_t of the launch (0 = ok).
extern "C" int prt_icp_iterate(float* cloud, const void* valid, int n_poses, int points,
                               const float* table, long long rows, int slabs, int threads,
                               const float* K, const float* gate, const long long* base,
                               int height, int width, const void* idx, int idx_bytes,
                               const float* dist_sq, float gate_sq, float robust_delta,
                               int point_to_point, float* T,
                               float* fitness, float* rmse, void* done, const float* n_total,
                               int it0, int it_end, int max_iter, float rf, float rr, int coarse,
                               float* handoff, int handoff_points, void* stream) {
  if (n_poses <= 0 || it_end <= it0) return 0;
  Args a = {};
  const int bad = fill_args(a, cloud, valid, n_poses, points, table, rows, slabs, threads, K,
                            gate, base, height, width, idx, idx_bytes, dist_sq, gate_sq,
                            robust_delta);
  if (bad != 0) return bad;
  const bool scored = coarse == 0;
  if (T == nullptr || it0 < 0 || it_end > max_iter + 1 ||
      (scored && (fitness == nullptr || rmse == nullptr || done == nullptr ||
                  n_total == nullptr)) ||
      (handoff != nullptr && (!coarse || handoff_points <= 0))) {
    return (int)cudaErrorInvalidValue;
  }
  Iter g = {};
  g.cloud = cloud;
  g.T = T;
  g.fitness = fitness;
  g.rmse = rmse;
  g.done = static_cast<unsigned char*>(done);
  g.n_total = n_total;
  g.it0 = it0;
  g.it_end = it_end;
  g.max_iter = max_iter;
  g.rf = rf;
  g.rr = rr;
  g.coarse = coarse != 0;
  g.handoff = handoff;
  g.handoff_points = handoff_points;
  const long long slab_bytes = 12LL * ((points + slabs - 1) / slabs);
  g.smem_cloud = it_end - it0 > 1 && slab_bytes <= kSmemCloudMax;
  const int smem_bytes = g.smem_cloud ? (int)slab_bytes : 0;
  const bool p2p = point_to_point != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (idx == nullptr) {
    return launch_iterate_mode<true, int>(a, g, n_poses, threads, smem_bytes, p2p, s);
  }
  return idx_bytes == 4
             ? launch_iterate_mode<false, int>(a, g, n_poses, threads, smem_bytes, p2p, s)
             : launch_iterate_mode<false, long long>(a, g, n_poses, threads, smem_bytes, p2p, s);
}

// s, c (n,) = sinf, cosf of x (n,) float32 on `stream`: the tail's
// trigonometry alone. Returns the cudaError_t of the launch.
extern "C" int prt_sin_cos(const float* x, int n, float* s, float* c, void* stream) {
  if (n <= 0) return 0;
  sin_cos_kernel<<<(n + kWide - 1) / kWide, kWide, 0,
                   static_cast<cudaStream_t>(stream)>>>(x, n, s, c);
  return (int)cudaGetLastError();
}
