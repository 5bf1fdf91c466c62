// Exact nearest-neighbour search ("flash-NN") for Hopper (sm_90a): one CTA
// per tile of 128 queries, one query per thread, scene streamed through
// shared memory 128 points at a time with a running minimum.
//
// Replaces two Pallas TPU kernels of pose_refine_tpu/scene/nn_pallas.py:
//   * nn_flash_packed (body _kernel): exact NN over the whole scene
//     (kPrune = false);
//   * nn_flash_gated (body _kernel_gated): the same argmin, exact for every
//     query whose NN lies inside the gate, skipping 128-point chunks that
//     cannot hold an in-gate NN of any query of the tile (kPrune = true).
//     "Inside" is by true distance: a query whose NN lies within float32
//     rounding of the gate may score inside it and still lose that chunk,
//     as with the Pallas kernel.
//
// Scene: the field-major pack_scene table (8, S_pad) f32 [x, y, z, |s|^2,
// 0...]; pad columns carry |s|^2 = BIG so they never win. Score of a pair:
// |s|^2 - 2 q.s (argmin of it is argmin of |q - s|^2). A thread scans
// chunks in index order and points of a chunk in index order with a strict
// `<`, so of equal scores the smallest global index is kept: the Pallas
// kernels' tie rule (per-lane strict `<`, then the smallest index among the
// lanes that hold the row minimum).
//
// Pruning (kPrune), nn_pallas.py:240-305 with frames = 1 and one band per
// tile:
//   pass 1: ub(q) = min_b |q - c_b| + r_b over the 32-point balls of the
//           scene table (centre = box centre, r = half diagonal), clamped
//           to the gate; the tile's radius is the max over its queries;
//   scan:   chunk c is scanned iff the squared distance between its box and
//           the tile's query box is <= radius^2. The decision is uniform
//           across the CTA (every thread evaluates it on the same reduced
//           values), so the chunk loop has no divergence.
// Threads of a partial last tile hold no query and take no part in the
// tile's box or radius. The JAX wrapper's tile size and sub-tile bands,
// and its group merge of chunk boxes, are TPU tuning and are not carried.
//
// Arithmetic matches the JAX kernels as XLA compiles them on the CPU, which
// contracts the 3-term sums into fused multiply-adds:
//   |q|^2 = fma(z, z, fma(y, y, x*x))      (the reduction jnp.sum(q*q, -1)),
//   q.s = fma(qz, sz, fma(qx, sx, qy*sy))  (the elementwise qx*sx + qy*sy + qz*sz),
//   score = |s|^2 - 2*(q.s),  dist^2 = max(best + |q|^2, 0).
// Every step is written with __fmaf_rn / __fmul_rn / __fadd_rn / __fsub_rn
// so nvcc cannot re-associate or contract differently; the plain PyTorch
// version (scene/nn_flash.py) evaluates the same single-rounding steps.
//
// What bounds it on the H100: FP32 issue in the scan, about 7 instructions
// per (query, point) pair (one broadcast 16-byte shared load, one multiply,
// two FMAs, one multiply-subtract pair, a compare/select); the scene is a
// few hundred KB and stays in L2. The design keeps the per-pair work to
// that: the four fields of a point are one float4 in shared memory read by
// all threads at the same address (a broadcast, no bank conflicts), and the
// gated kernel spends one box test per chunk per thread to skip whole
// chunks. Several queries per thread and tensor-core scoring (ROADMAP P1)
// are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 128;  // scene points per chunk (S_CHUNK)
constexpr int kTile = 128;   // queries per CTA, one per thread
constexpr int kWarps = kTile / 32;
constexpr float kBig = 3.0e38f;
constexpr int kIBig = 1 << 30;

// x*x + y*y + z*z as XLA contracts the elementwise expression
__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fmaf_rn(z, z, __fmaf_rn(x, x, __fmul_rn(y, y)));
}

// the same sum as XLA contracts the reduction jnp.sum(q * q, -1)
__device__ __forceinline__ float sum_sq(float x, float y, float z) {
  return __fmaf_rn(z, z, __fmaf_rn(y, y, __fmul_rn(x, x)));
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <bool kPrune>
__global__ void __launch_bounds__(kTile)
nn_flash_kernel(const float* __restrict__ q, int nq, const float* __restrict__ table,
                int s_pad, const float* __restrict__ boxes, const float* __restrict__ balls,
                int n_balls, float gate2, int* __restrict__ idx_out,
                float* __restrict__ dist_out, int* __restrict__ scanned) {
  __shared__ float4 stage[kChunk];
  __shared__ float part[7][kWarps];
  const int tid = threadIdx.x;
  const int i = blockIdx.x * kTile + tid;
  const bool active = i < nq;
  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (active) {
    qx = q[3 * (size_t)i];
    qy = q[3 * (size_t)i + 1];
    qz = q[3 * (size_t)i + 2];
  }
  const int n_chunks = s_pad / kChunk;

  float lo_x = 0.f, lo_y = 0.f, lo_z = 0.f, hi_x = 0.f, hi_y = 0.f, hi_z = 0.f, tile_r2 = 0.f;
  if (kPrune) {
    // pass 1: per-query NN distance upper bound over the balls
    // [cx; cy; cz; r] (4, n_balls), staged through shared memory
    float ub = kBig;
    for (int b0 = 0; b0 < n_balls; b0 += kChunk) {
      __syncthreads();
      const int b = b0 + tid;
      if (b < n_balls) {
        stage[tid] = make_float4(balls[b], balls[(size_t)n_balls + b],
                                 balls[2 * (size_t)n_balls + b], balls[3 * (size_t)n_balls + b]);
      }
      __syncthreads();
      const int nb = min(kChunk, n_balls - b0);
      for (int k = 0; k < nb; ++k) {
        const float4 c = stage[k];
        const float d = __fadd_rn(
            __fsqrt_rn(sq3(__fsub_rn(qx, c.x), __fsub_rn(qy, c.y), __fsub_rn(qz, c.z))), c.w);
        ub = fminf(ub, d);
      }
    }
    // clamp to the gate BEFORE the tile max: a query with no scene nearby
    // is invalid under the gate either way and must not widen the radius
    const float ub_q = fminf(ub, __fsqrt_rn(gate2));
    const float inf = __int_as_float(0x7f800000);
    float v[7] = {active ? ub_q : -inf, active ? qx : inf, active ? qy : inf,
                  active ? qz : inf,    active ? qx : -inf, active ? qy : -inf,
                  active ? qz : -inf};
    v[0] = warp_max(v[0]);
    for (int k = 1; k < 4; ++k) v[k] = warp_min(v[k]);
    for (int k = 4; k < 7; ++k) v[k] = warp_max(v[k]);
    if ((tid & 31) == 0) {
      for (int k = 0; k < 7; ++k) part[k][tid >> 5] = v[k];
    }
    __syncthreads();
    float r = part[0][0];
    lo_x = part[1][0]; lo_y = part[2][0]; lo_z = part[3][0];
    hi_x = part[4][0]; hi_y = part[5][0]; hi_z = part[6][0];
    for (int w = 1; w < kWarps; ++w) {
      r = fmaxf(r, part[0][w]);
      lo_x = fminf(lo_x, part[1][w]); lo_y = fminf(lo_y, part[2][w]); lo_z = fminf(lo_z, part[3][w]);
      hi_x = fmaxf(hi_x, part[4][w]); hi_y = fmaxf(hi_y, part[5][w]); hi_z = fmaxf(hi_z, part[6][w]);
    }
    tile_r2 = __fmul_rn(r, r);
  }

  float best = kBig;
  int bidx = 0;
  int n_scanned = 0;
  for (int c = 0; c < n_chunks; ++c) {
    if (kPrune) {
      const float* bx = boxes + 8 * (size_t)c;  // [xlo ylo zlo 0 xhi yhi zhi 0]
      const float dx = fmaxf(fmaxf(__fsub_rn(bx[0], hi_x), __fsub_rn(lo_x, bx[4])), 0.0f);
      const float dy = fmaxf(fmaxf(__fsub_rn(bx[1], hi_y), __fsub_rn(lo_y, bx[5])), 0.0f);
      const float dz = fmaxf(fmaxf(__fsub_rn(bx[2], hi_z), __fsub_rn(lo_z, bx[6])), 0.0f);
      if (!(sq3(dx, dy, dz) <= tile_r2)) continue;  // uniform across the CTA
    }
    __syncthreads();  // every thread is done with the previous chunk
    const int s = c * kChunk + tid;
    stage[tid] = make_float4(table[s], table[(size_t)s_pad + s], table[2 * (size_t)s_pad + s],
                             table[3 * (size_t)s_pad + s]);
    __syncthreads();
    if (active) {
#pragma unroll 8
      for (int k = 0; k < kChunk; ++k) {
        const float4 p = stage[k];
        const float dot = __fmaf_rn(qz, p.z, __fmaf_rn(qx, p.x, __fmul_rn(qy, p.y)));
        const float score = __fsub_rn(p.w, __fmul_rn(2.0f, dot));
        if (score < best) {  // strict: the smaller index keeps ties
          best = score;
          bidx = c * kChunk + k;
        }
      }
    }
    ++n_scanned;
  }

  if (active) {
    const float qq = sum_sq(qx, qy, qz);
    const float d = fmaxf(__fadd_rn(best, qq), 0.0f);
    if (kPrune) {
      idx_out[i] = min(bidx, kIBig - 1);
      dist_out[i] = best >= kBig ? kBig : d;
    } else {
      idx_out[i] = bidx;
      dist_out[i] = d;
    }
  }
  if (scanned != nullptr && tid == 0) scanned[blockIdx.x] = n_scanned;
}

}  // namespace

// Nearest scene point of nq queries (nq, 3) against the pack_scene table
// (8, s_pad), on `stream`. prune != 0 runs the gated kernel with the chunk
// boxes (s_pad/128, 8), the balls (4, n_balls) and the squared gate; prune
// == 0 the full scan (boxes, balls and gate2 unused). Writes idx (nq,)
// int32 and dist (nq,) f32; when `scanned` is not null, also the number of
// chunks each tile scanned (ceil(nq/128),) int32. Returns the cudaError_t
// of the launch (0 = ok).
extern "C" int prt_nn_flash(const float* queries, int nq, const float* table, int s_pad,
                            const float* boxes, const float* balls, int n_balls, float gate2,
                            int prune, int* idx, float* dist, int* scanned, void* stream) {
  if (nq <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = (nq + kTile - 1) / kTile;
  if (prune) {
    nn_flash_kernel<true><<<grid, kTile, 0, s>>>(queries, nq, table, s_pad, boxes, balls,
                                                 n_balls, gate2, idx, dist, scanned);
  } else {
    nn_flash_kernel<false><<<grid, kTile, 0, s>>>(queries, nq, table, s_pad, boxes, balls,
                                                  n_balls, gate2, idx, dist, scanned);
  }
  return (int)cudaGetLastError();
}
