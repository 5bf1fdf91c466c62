// Exact nearest-neighbour search ("flash-NN") for Hopper (sm_90a): one CTA
// of 128 threads per tile of 128 queries. The scene streams through two
// shared-memory buffers 128 points at a time; warp w scores points
// [32w, 32w + 32) of every chunk against all 128 queries of the tile, four
// queries a lane held in registers, and the four warps' minima merge at
// the end.
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
// 0...], 16-byte aligned; pad columns carry |s|^2 = BIG so they never win.
// Score of a pair: |s|^2 - 2 q.s (argmin of it is argmin of |q - s|^2). Of
// equal scores the smallest global index is kept, the Pallas kernels' tie
// rule (per-lane strict `<`, then the smallest index among the lanes that
// hold the row minimum); see "The argmin" below for why this scan keeps it.
//
// Pruning (kPrune), nn_pallas.py:240-305 with one band per tile:
//   pass 1: ub(q) = min_b |q - c_b| + r_b over the 32-point balls of the
//           scene table (centre = box centre, r = half diagonal), clamped
//           to the gate; the tile's radius is the max over its queries
//           (one query per thread here);
//   scan:   chunk c is scanned iff the squared distance between its box and
//           the tile's query box is <= radius^2. The test is CTA-uniform,
//           so it runs thread-parallel ahead of the scan: each warp tests
//           128 chunks of a batch of 512 (a ballot per 32), and the
//           survivors are compacted in index order into a list in shared
//           memory, which the scan then streams.
// Threads of a partial last tile hold no query and take no part in the
// tile's box or radius. The JAX wrapper's tile size and sub-tile bands,
// and its group merge of chunk boxes, are TPU tuning and are not carried.
//
// Stacked frames (kPrune, nn_pallas.py:252-255, 302-309): the table holds
// `frames` equal-width per-frame regions side by side, the boxes and balls
// frame-major. A frame id windows the ball pass, the box test and the chunk
// scan to its frame's region, so a query costs one frame's scan, and the
// index it returns is the stacked column (frame-local + fid * frame_rows),
// as the Pallas kernel returns it. The JAX package vmaps a frame id per
// pose; here `frame_id` holds one id per pose and the grid is 2-D,
// (tiles of one pose's `per_pose` queries, poses), so a tile never mixes
// two poses' frames. Ids are clamped to [0, frames). Without `frame_id` the
// grid is the 1-D one over all queries and every query takes frame 0, the
// Pallas kernel's default fid. With frames = 1 and no `frame_id` the
// single-frame instantiation (kStacked = false) runs, which carries none of
// the frame arithmetic.
//
// Arithmetic matches the JAX kernels as XLA compiles them on the CPU, which
// contracts the 3-term sums into fused multiply-adds:
//   |q|^2 = fma(z, z, fma(y, y, x*x))      (the reduction jnp.sum(q*q, -1)),
//   q.s = fma(qz, sz, fma(qx, sx, qy*sy))  (the elementwise qx*sx + qy*sy + qz*sz),
//   score = |s|^2 - 2*(q.s),  dist^2 = max(best + |q|^2, 0).
// The scan holds q' = -2q (exact) and takes
//   score = |s|^2 + fma(q'z, sz, fma(q'x, sx, q'y*sy)):
// scaling by 2 commutes with every rounding (no overflow or underflow at
// metre-scale inputs), so the chain is -2*(q.s) bit for bit and the last
// add is the same single rounding (but for the sign of a score that is
// zero, which compares equal either way and which dist^2 = max(best +
// |q|^2, 0) drops). Every step is written with __fmaf_rn /
// __fmul_rn / __fadd_rn / __fsub_rn so nvcc cannot re-associate or contract
// differently; the plain PyTorch version (scene/nn_flash.py) evaluates the
// same single-rounding steps.
//
// The argmin. Per pair the scan keeps only m = fminf(m, score). After a
// group of 16 points (kGroup) a strict m < best records the group's first
// column; nothing else about the index is kept in the loop. A warp's groups
// come in rising column order, so an earlier group keeps a tie. At the end
// the four warps' (best, group column) pairs of a query merge through
// shared memory - smaller score, then smaller column: groups are disjoint
// column ranges - and the query's thread scores the winning group's 16
// points again from the table (the same instructions, so the same bits)
// and takes the first that equals the minimum. That is the smallest index
// of the minimal score, what a point-by-point strict `<` in index order
// keeps. (A rescan inside the loop whenever a group improves was the
// alternative: a warp holds 128 queries, so some lane improves in most
// groups and the warp takes the rescan almost every time; it measured
// 15-20% slower on an H100.)
//
// What bounds it on the H100: instruction issue in the scan. Per (query,
// point) pair: FMUL, FFMA, FFMA, FADD, FMNMX, a quarter of a broadcast
// 16-byte shared load (four queries share it; a buffer is field-major, so
// one load brings one field of four points) and 2/16 for the group's
// compare and column select: about 5.4 issue slots, against 9 for one
// query a thread with a compare and two selects a pair. Measured on an
// H100 (700 W) the scan issues at about 80% of the card's rate, 6.9 slots a
// pair: the broadcast shared loads hold most of the rest (PERF.md). The
// scene is a few hundred KB and stays in L2; each thread copies 16 bytes of
// a chunk with one cp.async into the buffer the scan is not reading, so
// the copy of chunk c + 1 runs under the scan of chunk c and one
// __syncthreads a chunk is the only barrier. Tensor-core scoring
// (ROADMAP P1) changes results at near-ties and is not used here.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 128;              // scene points per chunk (S_CHUNK)
constexpr int kTile = 128;               // queries per CTA (Q_TILE)
constexpr int kWarps = kTile / 32;
constexpr int kQ = kTile / 32;           // queries a lane holds in the scan
constexpr int kPart = kChunk / kWarps;   // points of a chunk one warp scans
constexpr int kGroup = 16;               // points per argmin group
constexpr int kStages = 2;               // buffers of the chunk stage
constexpr int kBatch = 512;              // chunks per box-test batch
constexpr int kPerWarp = kBatch / kWarps;
constexpr int kRounds = kPerWarp / 32;   // ballots a warp casts per batch
constexpr float kBig = 3.0e38f;
constexpr int kIBig = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;

// x*x + y*y + z*z as XLA contracts the elementwise expression
__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fmaf_rn(z, z, __fmaf_rn(x, x, __fmul_rn(y, y)));
}

// the same sum as XLA contracts the reduction jnp.sum(q * q, -1)
__device__ __forceinline__ float sum_sq(float x, float y, float z) {
  return __fmaf_rn(z, z, __fmaf_rn(y, y, __fmul_rn(x, x)));
}

// |s|^2 - 2 q.s from n = -2q: the reference's bits (see the note above)
__device__ __forceinline__ float score(float nx, float ny, float nz, float sx, float sy,
                                       float sz, float ss) {
  return __fadd_rn(ss, __fmaf_rn(nz, sz, __fmaf_rn(nx, sx, __fmul_rn(ny, sy))));
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}

// wait for every cp.async this thread has issued
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// kStacked = false is the single-frame kernel (frames = 1, no frame_id):
// the frame arguments are compile-time 0/1 there.
template <bool kPrune, bool kStacked>
__global__ void __launch_bounds__(kTile)
nn_flash_kernel(const float* __restrict__ q, int nq, const float* __restrict__ table,
                int s_pad, const float* __restrict__ boxes, const float* __restrict__ balls,
                int n_balls, float gate2, const int* __restrict__ frame_id, int frames,
                int per_pose, int* __restrict__ idx_out, float* __restrict__ dist_out,
                int* __restrict__ scanned) {
  // the chunk stage: kStages buffers of [x | y | z | |s|^2] x kChunk
  __shared__ __align__(16) float ring[kStages][4][kChunk];
  __shared__ int list[kPrune ? kBatch : 1];  // surviving chunks of a batch, frame-local
  __shared__ int list_n[kWarps];
  __shared__ float part[7][kWarps];
  __shared__ float m_best[kWarps][kTile];
  __shared__ int m_col[kWarps][kTile];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // the query range and frame of this tile: all queries and frame 0, or
  // one pose's queries (blockIdx.y) and that pose's frame
  int fid = 0, first = 0, n_local = nq;
  if (kStacked && frame_id != nullptr) {
    fid = min(max(frame_id[blockIdx.y], 0), frames - 1);
    first = blockIdx.y * per_pose;
    n_local = per_pose;
  }
  // the ball pass, the merge and the output take one query a thread
  const int local = blockIdx.x * kTile + tid;
  const bool active = local < n_local;
  const int i = first + local;
  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (active) {
    qx = q[3 * (size_t)i];
    qy = q[3 * (size_t)i + 1];
    qz = q[3 * (size_t)i + 2];
  }
  const int n_frames = kStacked ? frames : 1;
  const int n_chunks = s_pad / kChunk / n_frames;  // chunks of one frame
  const int c_first = kStacked ? fid * n_chunks : 0;

  float lo_x = 0.f, lo_y = 0.f, lo_z = 0.f, hi_x = 0.f, hi_y = 0.f, hi_z = 0.f, tile_r2 = 0.f;
  if (kPrune) {
    // pass 1: per-query NN distance upper bound over the frame's balls
    // [cx; cy; cz; r] (4, n_balls), staged through shared memory; the
    // frame's balls are [fid * nb_frame, (fid + 1) * nb_frame)
    float4* stage = reinterpret_cast<float4*>(&ring[0][0][0]);
    const int nb_frame = kStacked ? n_balls / frames : n_balls;
    // ub2 > ub^2: the factor covers the product's rounding and the floor
    // its underflow (ub below ~1e-15 keeps ub2 = 1e-30; an overflow to inf
    // only takes every root). A ball with d2 > ub2 has sqrt(d2) >= ub, and
    // its radius is >= 0 (ball_table's half diagonal), so it cannot lower
    // ub, and most balls skip the IEEE square root; ub comes out bit for
    // bit as if every ball had taken it
    float ub = kBig, ub2 = kBig;
    for (int b0 = 0; b0 < nb_frame; b0 += kChunk) {
      __syncthreads();
      const int b = (kStacked ? fid * nb_frame : 0) + b0 + tid;
      if (b0 + tid < nb_frame) {
        stage[tid] = make_float4(balls[b], balls[(size_t)n_balls + b],
                                 balls[2 * (size_t)n_balls + b], balls[3 * (size_t)n_balls + b]);
      }
      __syncthreads();
      const int nb = min(kChunk, nb_frame - b0);
      for (int k = 0; k < nb; ++k) {
        const float4 c = stage[k];
        const float d2 = sq3(__fsub_rn(qx, c.x), __fsub_rn(qy, c.y), __fsub_rn(qz, c.z));
        if (d2 <= ub2) {
          ub = fminf(ub, __fadd_rn(__fsqrt_rn(d2), c.w));
          ub2 = fmaxf(__fmul_rn(__fmul_rn(ub, ub), 1.000001f), 1.0e-30f);
        }
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
    if (lane == 0) {
      for (int k = 0; k < 7; ++k) part[k][warp] = v[k];
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

  // the scan's queries of this lane: lane, lane + 32, ... of the tile, as
  // n = -2q; a lane past the last query scans with n = 0 and is not read
  float nx[kQ], ny[kQ], nz[kQ], best[kQ];
  int bcol[kQ];
#pragma unroll
  for (int j = 0; j < kQ; ++j) {
    const int lq = blockIdx.x * kTile + 32 * j + lane;
    float x = 0.0f, y = 0.0f, z = 0.0f;
    if (lq < n_local) {
      const float* p = q + 3 * (size_t)(first + lq);
      x = p[0]; y = p[1]; z = p[2];
    }
    nx[j] = __fmul_rn(-2.0f, x);
    ny[j] = __fmul_rn(-2.0f, y);
    nz[j] = __fmul_rn(-2.0f, z);
    best[j] = kBig;
    bcol[j] = 0;
  }

  int n_scanned = 0;
  for (int b0 = 0; b0 < n_chunks; b0 += kBatch) {
    const int nb = min(kBatch, n_chunks - b0);
    int n_list = nb;
    unsigned hit[kRounds];
    int mine = 0;
    if (kPrune) {
      // the box test of this batch: warp w takes chunks [w, w + 1) * kPerWarp
#pragma unroll
      for (int r = 0; r < kRounds; ++r) {
        const int cl = warp * kPerWarp + 32 * r + lane;
        bool keep = false;
        if (cl < nb) {
          const float* bx = boxes + 8 * (size_t)(c_first + b0 + cl);  // [xlo ylo zlo 0 xhi yhi zhi 0]
          const float dx = fmaxf(fmaxf(__fsub_rn(bx[0], hi_x), __fsub_rn(lo_x, bx[4])), 0.0f);
          const float dy = fmaxf(fmaxf(__fsub_rn(bx[1], hi_y), __fsub_rn(lo_y, bx[5])), 0.0f);
          const float dz = fmaxf(fmaxf(__fsub_rn(bx[2], hi_z), __fsub_rn(lo_z, bx[6])), 0.0f);
          keep = sq3(dx, dy, dz) <= tile_r2;
        }
        hit[r] = __ballot_sync(kFull, keep);
        mine += __popc(hit[r]);
      }
    }
    __syncthreads();  // every thread is done with the previous batch's ring and list
    if (kPrune) {
      if (lane == 0) list_n[warp] = mine;
      __syncthreads();
      int at = 0;
      n_list = 0;
      for (int w = 0; w < kWarps; ++w) {
        if (w < warp) at += list_n[w];
        n_list += list_n[w];
      }
#pragma unroll
      for (int r = 0; r < kRounds; ++r) {
        if ((hit[r] >> lane) & 1u) {
          list[at + __popc(hit[r] & ((1u << lane) - 1u))] = b0 + warp * kPerWarp + 32 * r + lane;
        }
        at += __popc(hit[r]);
      }
      __syncthreads();
    }

    // stream the listed chunks: thread t copies 16 bytes (field t / 32,
    // points 4 (t % 32) ...) of listed chunk n into buffer n % 2, one chunk
    // ahead of the scan
    auto issue = [&](int n) {
      if (n < n_list) {
        const int c = c_first + (kPrune ? list[n] : b0 + n);
        cp_async16(&ring[n & 1][warp][4 * lane],
                   table + (size_t)warp * s_pad + (size_t)c * kChunk + 4 * lane);
      }
    };
    issue(0);
    for (int n = 0; n < n_list; ++n) {
      cp_async_wait_all();
      // chunk n is visible to all, and all are done with chunk n - 1,
      // whose buffer the next copy overwrites
      __syncthreads();
      issue(n + 1);
      const int st = n & 1;
      const int col0 = (c_first + (kPrune ? list[n] : b0 + n)) * kChunk + warp * kPart;
      const float* sx = &ring[st][0][warp * kPart];
      const float* sy = &ring[st][1][warp * kPart];
      const float* sz = &ring[st][2][warp * kPart];
      const float* sw = &ring[st][3][warp * kPart];
#pragma unroll
      for (int g = 0; g < kPart; g += kGroup) {
        float m[kQ];
#pragma unroll
        for (int j = 0; j < kQ; ++j) m[j] = best[j];
#pragma unroll
        for (int k = g; k < g + kGroup; k += 4) {
          const float4 X = *reinterpret_cast<const float4*>(sx + k);
          const float4 Y = *reinterpret_cast<const float4*>(sy + k);
          const float4 Z = *reinterpret_cast<const float4*>(sz + k);
          const float4 W = *reinterpret_cast<const float4*>(sw + k);
#pragma unroll
          for (int j = 0; j < kQ; ++j) {
            m[j] = fminf(m[j], score(nx[j], ny[j], nz[j], X.x, Y.x, Z.x, W.x));
            m[j] = fminf(m[j], score(nx[j], ny[j], nz[j], X.y, Y.y, Z.y, W.y));
            m[j] = fminf(m[j], score(nx[j], ny[j], nz[j], X.z, Y.z, Z.z, W.z));
            m[j] = fminf(m[j], score(nx[j], ny[j], nz[j], X.w, Y.w, Z.w, W.w));
          }
        }
#pragma unroll
        for (int j = 0; j < kQ; ++j) {
          if (m[j] < best[j]) bcol[j] = col0 + g;  // strict: the earlier group keeps ties
          best[j] = m[j];
        }
      }
    }
    n_scanned += n_list;
  }

  // merge the warps' minima of query tid: the smaller score, then the
  // smaller group column
#pragma unroll
  for (int j = 0; j < kQ; ++j) {
    m_best[warp][32 * j + lane] = best[j];
    m_col[warp][32 * j + lane] = bcol[j];
  }
  __syncthreads();
  float bmin = m_best[0][tid];
  int col = m_col[0][tid];
  for (int w = 1; w < kWarps; ++w) {
    const float bw = m_best[w][tid];
    const int cw = m_col[w][tid];
    if (bw < bmin || (bw == bmin && cw < col)) {
      bmin = bw;
      col = cw;
    }
  }
  if (active) {
    // the first point of the winning group whose score is the minimum
    float found = kBig;
    int bidx = 0;
    if (bmin < kBig) {
      const float ax = __fmul_rn(-2.0f, qx), ay = __fmul_rn(-2.0f, qy), az = __fmul_rn(-2.0f, qz);
      const float* t = table + col;
      for (int k = kGroup - 1; k >= 0; --k) {
        const float s = score(ax, ay, az, t[k], t[(size_t)s_pad + k], t[2 * (size_t)s_pad + k],
                              t[3 * (size_t)s_pad + k]);
        if (s == bmin) {
          found = s;
          bidx = col + k;
        }
      }
    }
    const float qq = sum_sq(qx, qy, qz);
    const float d = fmaxf(__fadd_rn(found, qq), 0.0f);
    if (kPrune) {
      idx_out[i] = min(bidx, kIBig - 1);
      dist_out[i] = found >= kBig ? kBig : d;
    } else {
      idx_out[i] = bidx;
      dist_out[i] = d;
    }
  }
  if (scanned != nullptr && tid == 0) {
    scanned[kStacked ? blockIdx.y * gridDim.x + blockIdx.x : blockIdx.x] = n_scanned;
  }
}

}  // namespace

// Nearest scene point of nq queries (nq, 3) against the pack_scene table
// (8, s_pad), 16-byte aligned, on `stream`. prune != 0 runs the gated
// kernel with the chunk boxes (s_pad/128, 8), the balls (4, n_balls) and
// the squared gate, over a table of `frames` stacked frames: with frame_id
// (nq / per_pose,) int32 each pose's per_pose queries take their pose's
// frame, without it (null) every query takes frame 0. prune == 0 runs the
// full scan (boxes, balls, gate2 and the frame arguments unused; frames
// must be 1). Writes idx (nq,) int32 and dist (nq,) f32; when `scanned` is
// not null, also the number of chunks each tile scanned (one int32 per
// tile, pose-major). Returns the cudaError_t of the launch (0 = ok).
extern "C" int prt_nn_flash(const float* queries, int nq, const float* table, int s_pad,
                            const float* boxes, const float* balls, int n_balls, float gate2,
                            int prune, const int* frame_id, int frames, int per_pose,
                            int* idx, float* dist, int* scanned, void* stream) {
  if (nq <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((nq + kTile - 1) / kTile);
  if (frame_id != nullptr) grid = dim3((per_pose + kTile - 1) / kTile, nq / per_pose);
  if (prune && (frames != 1 || frame_id != nullptr)) {
    nn_flash_kernel<true, true><<<grid, kTile, 0, s>>>(queries, nq, table, s_pad, boxes, balls,
                                                       n_balls, gate2, frame_id, frames,
                                                       per_pose, idx, dist, scanned);
  } else if (prune) {
    nn_flash_kernel<true, false><<<grid, kTile, 0, s>>>(queries, nq, table, s_pad, boxes, balls,
                                                        n_balls, gate2, nullptr, 1, nq, idx,
                                                        dist, scanned);
  } else {
    nn_flash_kernel<false, false><<<grid, kTile, 0, s>>>(queries, nq, table, s_pad, boxes,
                                                         balls, n_balls, gate2, nullptr, 1, nq,
                                                         idx, dist, scanned);
  }
  return (int)cudaGetLastError();
}
