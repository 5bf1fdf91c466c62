// Fused association + normal-equation reduction of one ICP pass for Hopper
// (sm_90a): out (N, 29) = per pose, the sum over its P points of the packed
// vector [21 upper-triangular AtA | 6 Atb | point-to-point mse | count].
//
// The port's own kernel. It is the reference's single transform_reduce over
// thrust__pcd2Ab (icp.h:125-209, icp.cu:170-172), in which each point looks
// its neighbour up and maps to 29 floats, and the function of the JAX
// package's _normal_equations_packed (pose_refine_tpu/icp.py:215-238) with
// the scene query inlined. On the TPU the query's row gather cannot live in a
// Pallas body (scripts/probe_pallas_gather.py::gather_pallas is the probe
// that tried), so there the rows go through device memory between the
// association and the reduction; csrc/gather.cu ported that step alone. Here
// the thread that fetches a row consumes it in registers: the (N, P, 8) row
// block is never written, and the dozen elementwise launches between the
// gather and the sums of a pass collapse into this one.
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
//  * indexed (scene/nn.py): the row index and dist^2 come from the flash-NN
//    kernels; the index is clamped into the table and the gate is
//    dist^2 < max_dist^2.
//
// The 28 float sums are taken in float32 (no TF32, no half), in a fixed
// order: a thread adds its points in rising order, a warp merges by an xor
// butterfly, the CTA's warps are added in warp order, and the CTAs of one
// pose - a thread block cluster, one CTA per slab of points - are added in
// rank order by rank 0 through distributed shared memory. No float atomics:
// two launches on equal inputs give equal bits. Every term is rounded one
// operation at a time (no fused multiply-add), and the plain PyTorch version
// (ops/icp_reduce.py::assoc_reduce_plain) takes the same terms in the same
// order, so the kernel equals it bit for bit; a matrix product or torch.sum
// orders the adds otherwise and differs in the last bits (the count never).
//
// What bounds it on the H100: bytes and latency, not arithmetic. A point
// costs 13 bytes of cloud and valid mask from device memory, one 32-byte row
// that mostly hits L2 (a 640x480 table is 9.8 MB of the 50 MB), and about 90
// FP32 instructions (a product and its add are two); 256 poses x 2,048 points are 6.8 MB and 2 us at the
// card's rates. What the design does about it: each thread issues the loads
// of kBatch points before it consumes any (two dependent memory latencies a
// batch, not a point), the grid is sized to the card (a pose is split over
// up to 8 slabs when the poses alone leave SMs idle: 16 tracked hypotheses
// give 128 CTAs), and the cluster merge keeps the pass at one launch.
//
// A masked point contributes its terms multiplied by 0, as the plain version
// does, so a non-finite coordinate of a masked point poisons the sums in
// both; the ICP anchors padded rows to a real point for that reason.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 29;     // 21 AtA + 6 Atb + mse + count
constexpr int kBatch = 4;     // points a thread loads before it accumulates
constexpr int kMaxSlabs = 8;  // the portable cluster size

struct Args {
  const float* cloud;          // (N, P, 3)
  const unsigned char* valid;  // (N, P) bool
  const float4* table;         // (R, 8) as two float4 a row
  long long rows;
  int points;  // P
  int slabs;   // CTAs a pose = cluster size
  float* out;  // (N, 29)
  // projective front end
  const float* K;         // (3, 3) row-major intrinsics, on the device
  const float* gate;      // () max_dist_diff, on the device
  const long long* base;  // (N,) row offset of each pose's frame, or null
  int height, width;
  // indexed front end
  const void* idx;       // (N, P) int32 or int64
  const float* dist_sq;  // (N, P)
  float gate_sq;
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

template <bool kProj, typename Idx>
__global__ void __launch_bounds__(kThreads) assoc_reduce_kernel(const Args a) {
  __shared__ float warp_sums[kWarps][kSums];
  __shared__ float cta_sums[32];

  const int tid = threadIdx.x;
  const int slab = blockIdx.x % a.slabs;
  const long long pose = blockIdx.x / a.slabs;
  const int per_slab = (a.points + a.slabs - 1) / a.slabs;
  const int begin = slab * per_slab;
  const int end = min(begin + per_slab, a.points);
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
        px[j] = __ldg(a.cloud + 3 * i);
        py[j] = __ldg(a.cloud + 3 * i + 1);
        pz[j] = __ldg(a.cloud + 3 * i + 2);
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
      const float bm = __fmul_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(dx, nx), __fmul_rn(dy, ny)), __fmul_rn(dz, nz)), v);
      float row6[6];
      row6[0] = __fmul_rn(__fsub_rn(__fmul_rn(y, nz), __fmul_rn(z, ny)), v);
      row6[1] = __fmul_rn(__fsub_rn(__fmul_rn(z, nx), __fmul_rn(x, nz)), v);
      row6[2] = __fmul_rn(__fsub_rn(__fmul_rn(x, ny), __fmul_rn(y, nx)), v);
      row6[3] = __fmul_rn(nx, v);
      row6[4] = __fmul_rn(ny, v);
      row6[5] = __fmul_rn(nz, v);
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
      const float sq =
          __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      acc[27] = __fadd_rn(acc[27], __fmul_rn(sq, v));
      acc[28] = __fadd_rn(acc[28], v);
    }
  }

  // warp: xor butterfly, every lane ends with the warp's sum
#pragma unroll
  for (int k = 0; k < kSums; ++k) {
#pragma unroll
    for (int step = 16; step > 0; step >>= 1) {
      acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], step);
    }
  }
  if ((tid & 31) == 0) {
#pragma unroll
    for (int k = 0; k < kSums; ++k) warp_sums[tid >> 5][k] = acc[k];
  }
  __syncthreads();
  // CTA: the warps in warp order
  float total = 0.f;
  if (tid < kSums) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += warp_sums[w][tid];
  }
  if (a.slabs == 1) {
    if (tid < kSums) a.out[pose * kSums + tid] = total;
    return;
  }
  // pose: the cluster's CTAs in rank order, read by rank 0 out of their
  // shared memory
  cg::cluster_group cluster = cg::this_cluster();
  if (tid < kSums) cta_sums[tid] = total;
  cluster.sync();
  if (cluster.block_rank() == 0 && tid < kSums) {
    for (unsigned r = 1; r < cluster.num_blocks(); ++r) {
      total += cluster.map_shared_rank(cta_sums, r)[tid];
    }
    a.out[pose * kSums + tid] = total;
  }
  cluster.sync();  // no CTA leaves while rank 0 may still read its sums
}

template <bool kProj, typename Idx>
int launch(const Args& a, int n_poses, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((long long)n_poses * a.slabs));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)a.slabs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, assoc_reduce_kernel<kProj, Idx>, a);
}

}  // namespace

// out (n_poses, 29) on `stream`. cloud (n_poses, points, 3) float32 and valid
// (n_poses, points) bool, contiguous; table (rows, 8) float32, contiguous and
// 16-byte aligned; slabs in {1, 2, 4, 8}, the CTAs a pose. idx == null
// selects the projective front end (K, gate and base are device pointers,
// base (n_poses,) int64 or null), else the indexed one (idx int32 or int64 by
// idx_bytes, dist_sq float32, both (n_poses, points)). Returns the
// cudaError_t of the launch (0 = ok).
extern "C" int prt_assoc_reduce(const float* cloud, const void* valid, int n_poses, int points,
                                const float* table, long long rows, int slabs, const float* K,
                                const float* gate, const long long* base, int height, int width,
                                const void* idx, int idx_bytes, const float* dist_sq,
                                float gate_sq, float* out, void* stream) {
  if (n_poses <= 0) return 0;
  if (points <= 0 || rows <= 0 || slabs < 1 || slabs > kMaxSlabs || (slabs & (slabs - 1)) ||
      (long long)n_poses * slabs >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  Args a = {};
  a.cloud = cloud;
  a.valid = static_cast<const unsigned char*>(valid);
  a.table = reinterpret_cast<const float4*>(table);
  a.rows = rows;
  a.points = points;
  a.slabs = slabs;
  a.out = out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (idx == nullptr) {
    if (K == nullptr || gate == nullptr || height <= 0 || width <= 0) {
      return (int)cudaErrorInvalidValue;
    }
    a.K = K;
    a.gate = gate;
    a.base = base;
    a.height = height;
    a.width = width;
    return launch<true, int>(a, n_poses, s);
  }
  if (dist_sq == nullptr || (idx_bytes != 4 && idx_bytes != 8)) {
    return (int)cudaErrorInvalidValue;
  }
  a.idx = idx;
  a.dist_sq = dist_sq;
  a.gate_sq = gate_sq;
  return idx_bytes == 4 ? launch<false, int>(a, n_poses, s)
                        : launch<false, long long>(a, n_poses, s);
}
