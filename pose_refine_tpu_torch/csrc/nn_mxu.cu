// Exact nearest-neighbour search with a tensor-core screen and an exact
// re-score, for Hopper (sm_90a): B2's result (nn_flash.cu) bit for bit.
//
// Replaces the Pallas TPU kernel scripts/probe_mxu_nn.py::nn_flash_mxu (body
// _kernel_mxu), a probe of B2's scoring on the TPU's matrix unit: score(q,
// s) = |s|^2 - 2 q.s as a (Q_TILE, 4) x (4, S_CHUNK) product
// [1, qx, qy, qz] . [ss, -2x, -2y, -2z] at Precision.HIGHEST, with the
// running minimum on the vector unit. That product rounds otherwise than
// B2's elementwise score, so it flips near-tie neighbours. Here the product
// is only a screen: every pair whose screened score could be the minimum is
// scored again with B2's own score() and the argmin is taken over those
// exact scores. The function is B2's: of the pairs with the smallest B2
// score the smallest column wins, dist^2 = max(score + |q|^2, 0), and idx
// and dist^2 equal nn_flash_packed's bit for bit. Input: the
// pack_scene_mxu table (8, S_pad), rows 0-3 pack_scene's [x, y, z, |s|^2],
// rows 4-6 [-2x, -2y, -2z].
//
// The screen. TF32 keeps 10 mantissa bits, so each operand v is split into
// TF32 parts v = hi + lo + d, |lo| <= 2^-11 |v|, |d| <= 2^-22 |v|, and the
// 3xTF32 product hi.hi + hi.lo + lo.hi is packed along K into one
// m16n8k8 and one m16n8k4 mma.sync a 16 x 8 tile:
//   m16n8k4: A = [0, qx, qy, qz]_lo           B = [ss, -2x, -2y, -2z]_hi
//   m16n8k8: A = [1, qx, qy, qz]_hi (twice)   B = [ss, -2x, -2y, -2z]_hi over _lo
// (the 1 has no lo part). In the k8 fragment a thread holds A's column t
// and t + 4, which are the same value here, and B's rows t (hi) and t + 4
// (lo) of one column, so a tile takes one 8-byte shared load of (hi, lo)
// for both products.
//
// Why the result is exact. Let eps_q bound |screen - B2 score| over every
// pair of query q, and w be a pair of minimal B2 score. Then screen(w) <=
// B2(w) + eps_q, and B2(w) <= B2(p) for every pair p. Each of a thread's
// pairs is tested against a threshold T of its query; a tile of pairs with
// one that passes is re-scored exactly, and the thread keeps the exact
// (score, column) minimum with a strict `<` in increasing column order. T
// only ever takes values that are >= B2(w) + eps_q, so w and every pair
// tied with it are re-scored:
//   * the seed T = m + 2 eps_q, m the smallest screen over a sample of the
//     columns (every kSeedStride-th chunk; of the query's four threads):
//     m = screen(p) >= B2(p) - eps_q for some pair p, so m + 2 eps_q >=
//     B2(w) + eps_q;
//   * T = b + eps_q, b the best exact score so far of the query's four
//     threads: b >= B2(w).
// The four threads sharing the query merge by (score, column), so the
// smallest column of the smallest score wins. T's additions round up.
//
// eps_q. With M_q = Smax^2 + 2 |q| Smax (Smax = the largest |s| over real
// columns, |s|^2 < BIG), the sum of the terms' magnitudes
// ss + 2 |q.s|_1 <= M_q bounds every partial sum, and:
//   * the dropped lo.lo and the split remainders d: 3 x 2^-22 M_q;
//   * the tensor core's float32 accumulation, its order and rounding
//     unspecified: taken as truncation of each of the k8's 8 products and
//     the accumulator to the largest addend's exponent, plus a truncating
//     normalisation, 10 x 2^-23 M_q (the k4 runs first on the lo.hi terms,
//     ~2^-11 M_q, and adds ~2^-30 M_q); the TF32 products are exact;
//   * B2's own float32 rounding of the score (a product, two FMAs and an
//     add, each within 2^-24 of its result): 4 x 2^-24 M_q.
// Together 2.25 x 2^-20 M_q, about 2^-18.8 M_q. The kernel takes
// eps_q = kC M_q + 2^-100 with kC = 2^-16, 7x that reckoning (the floor
// covers denormal products that the tensor core may flush); the relative
// errors of M_q's own float evaluation (a few 2^-24) are inside the margin.
// kC is never lowered from observed data: chip_smoke.py prints the largest
// |screen - B2 score| / eps_q it sees on the pairs it re-scores.
//
// The seed. A threshold that starts high re-scores every pair that improves
// on the best so far: over a table sorted along an axis (the probe's is
// lexsorted by z) a query meets its neighbourhood gradually and keeps
// improving, so the first chunk alone is a poor seed. A screen-only pass
// over every kSeedStride-th chunk (an eighth of the tensor work) seeds T
// near the final minimum before the scan starts.
//
// Layout. A CTA of 8 warps takes 512 queries; warp w owns queries
// [64w, 64w + 64) as four 16-row m-tiles, so each B fragment feeds four
// m-tiles. The table's TF32 parts are split once a call by a prologue kernel
// (nn_mxu_split_kernel) into scratch that the wrapper allocates, laid out a
// chunk at a time as the stage wants it ((hi, lo) pairs, [chunk][t][128]),
// which also writes Smax^2. The scan streams 128-column chunks through
// 2 kRound shared-memory buffers with 16-byte cp.async - the (hi, lo) rows
// (row stride 132 pairs: a half-warp's 8-byte loads hit 32 distinct banks)
// and the float32 rows x, y, z, |s|^2 for the re-score - one round of
// kRound chunks ahead of the scan, with one barrier a round. In the
// accumulator fragment a thread holds rows g and g + 8 of each m-tile (g =
// lane / 4) at columns 2t, 2t+1 (t = lane % 4) of each n-tile: eight query
// rows, each with its threshold and exact best in registers; -2q and eps_q
// of the CTA's rows are in shared memory.
//
// The candidates. The 16 compares of a thread's tile are or-ed into one
// bit of a register (bit j: n-tile j) and nothing else happens in the scan
// loop. At the end of the chunk each thread re-scores its marked tiles -
// its 8 rows x 2 columns, B2's four instructions a pair - and at the end of
// a round the quad shares its best. Slower on an H100, and not kept:
// re-scoring where the candidate is found (a divergent branch in the
// loop), a warp queue with shared 64-bit atomicMin keys (their latency),
// marking the candidate m-tiles to re-score 4 pairs instead of 16, and
// taking a round's chunks in an order rotated by warp (both cost more in
// the loop than they save).
//
// What bounds it on the H100: the tensor cores' 24 flop a pair (the k8 and
// k4 products of 16 x 8 pairs: 3072 flop), at mma.sync's rate, below
// wgmma's 495 TFLOP/s, and the CUDA cores' compare of every screened score
// with its threshold (one FSETP a pair). chip_smoke.py bounds it by 2
// instructions a pair (a min of the score and a compare, the least an
// argmin needs) or the tensor work at 495 TFLOP/s, the larger, and prints
// the re-scored pairs a query. Beside the screen, the re-score and the
// barriers, which the CTA's warps reach in step, take much of the time
// (PERF.md).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kChunk = 128;                 // scene columns a chunk
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMT = 4;                      // 16-row m-tiles a warp
constexpr int kSlots = 2 * kMT;             // query rows a thread holds
constexpr int kTile = kWarps * kMT * 16;    // queries a CTA (512)
constexpr int kStrideB = kChunk + 4;        // (hi, lo) row stride in pairs
constexpr int kSeedStride = 8;              // the seed screens every 8th chunk
constexpr int kMinCtas = 16 / kWarps;       // resident CTAs an SM (registers)
constexpr int kRound = 3;                   // chunks between two barriers
constexpr int kBuffers = 2 * kRound;        // stage buffers
constexpr int kSplitThreads = 256;
constexpr float kBig = 3.0e38f;
constexpr float kC = 1.0f / 65536.0f;       // eps_q = kC * M_q + kEpsFloor
constexpr float kEpsFloor = 7.8886091e-31f;  // 2^-100

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + d with hi, lo in TF32 (x - hi is exact in float32)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(__fsub_rn(x, __uint_as_float(hi)));
}

// d = a (16x4, row) * b (4x8, col), TF32 operands, float32 accumulators from 0
__device__ __forceinline__ void mma_k4(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm(
      "mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %7, %7, %7};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0), "f"(0.0f));
}

// d += a (16x8, row) * b (8x8, col)
__device__ __forceinline__ void mma_k8(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// |q|^2 as XLA contracts jnp.sum(q * q, -1), as nn_flash.cu's sum_sq
__device__ __forceinline__ float sum_sq(float x, float y, float z) {
  return __fmaf_rn(z, z, __fmaf_rn(y, y, __fmul_rn(x, x)));
}

// nn_flash.cu's score(), verbatim: |s|^2 - 2 q.s from n = -2q
__device__ __forceinline__ float score(float nx, float ny, float nz, float sx, float sy,
                                       float sz, float ss) {
  return __fadd_rn(ss, __fmaf_rn(nz, sz, __fmaf_rn(nx, sx, __fmul_rn(ny, sy))));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The prologue: column c's [ss, -2x, -2y, -2z] split into TF32 (hi, lo)
// pairs at split[chunk][t][c % 128], and Smax^2 = the largest |s|^2 < BIG
// (a float's bits order as an int's for values >= 0; *smax2 starts at 0).
__global__ void __launch_bounds__(kSplitThreads)
nn_mxu_split_kernel(const float* __restrict__ table, int s_pad, uint2* __restrict__ split,
                    float* __restrict__ smax2) {
  __shared__ float part[kSplitThreads / 32];
  const int c = blockIdx.x * kSplitThreads + threadIdx.x;
  float m = 0.0f;
  if (c < s_pad) {
    const float ss = table[3 * (size_t)s_pad + c];
    const float b[4] = {ss, table[4 * (size_t)s_pad + c], table[5 * (size_t)s_pad + c],
                        table[6 * (size_t)s_pad + c]};
    uint2* dst = split + (size_t)(c / kChunk) * 4 * kChunk + (c % kChunk);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      uint32_t hi, lo;
      split_tf32(b[t], hi, lo);
      dst[t * kChunk] = make_uint2(hi, lo);
    }
    if (ss < kBig) m = ss;  // pad columns carry BIG
  }
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kSplitThreads / 32; ++w) m = fmaxf(m, part[w]);
    atomicMax(reinterpret_cast<int*>(smax2), __float_as_int(m));
  }
}

// kStats: also count each query's re-scored pairs and the largest
// |screen - B2 score| / eps_q over its candidates (chip_smoke.py's
// measurement)
template <bool kStats>
__global__ void __launch_bounds__(kThreads, kMinCtas)
nn_mxu_kernel(const float* __restrict__ q, int nq, const float* __restrict__ table, int s_pad,
              const uint2* __restrict__ split, const float* __restrict__ smax2_in,
              int* __restrict__ idx_out, float* __restrict__ dist_out,
              int* __restrict__ rescored_out, float* __restrict__ err_out) {
  // the chunk stage, kBuffers buffers: (hi, lo) of [ss, -2x, -2y, -2z] by
  // row t, and the float32 rows x, y, z, |s|^2
  __shared__ __align__(16) uint2 sb[kBuffers][4][kStrideB];
  __shared__ __align__(16) float sf[kBuffers][4][kChunk];
  __shared__ __align__(16) float4 sq[kTile];  // a query row's (-2q, eps_q)
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = warp * (16 * kMT);  // the warp's first row in the CTA
  const int n_chunks = s_pad / kChunk;

  // the stream of steps: first the seed's chunks (every kSeedStride-th),
  // then every chunk, kRound steps between two barriers. A step's chunk is
  // copied into buffer k % kBuffers in 16-byte pieces: 256 of (hi, lo)
  // pairs (row r, pairs 2p, 2p + 1) and, after the seed, 128 of the
  // float32 rows (row fr, floats 4fp ...)
  const int n_seed = (n_chunks + kSeedStride - 1) / kSeedStride;
  const int n_steps = n_seed + n_chunks;
  auto issue = [&](int k) {
    if (k < n_steps) {
      const int c = k < n_seed ? k * kSeedStride : k - n_seed;
      const int b = k % kBuffers;
      for (int i = tid; i < (k < n_seed ? 256 : 384); i += kThreads) {
        if (i < 256) {
          const int r = i >> 6, p = i & 63;
          cp_async16(&sb[b][r][2 * p], split + ((size_t)c * 4 + r) * kChunk + 2 * p);
        } else {
          const int fr = (i - 256) >> 5, fp = i & 31;
          cp_async16(&sf[b][fr][4 * fp],
                     table + (size_t)fr * s_pad + (size_t)c * kChunk + 4 * fp);
        }
      }
    }
  };
  for (int k = 0; k < kRound; ++k) issue(k);

  const float smax2 = *smax2_in;
  const float smax = __fsqrt_ru(smax2);
  for (int i = tid; i < kTile; i += kThreads) {
    const int r = blockIdx.x * kTile + i;
    float x = 0.0f, y = 0.0f, z = 0.0f;
    if (r < nq) {
      x = q[3 * (size_t)r];
      y = q[3 * (size_t)r + 1];
      z = q[3 * (size_t)r + 2];
    }
    const float m_q = __fmaf_ru(__fmul_ru(2.0f, __fsqrt_ru(sum_sq(x, y, z))), smax, smax2);
    sq[i] = make_float4(__fmul_rn(-2.0f, x), __fmul_rn(-2.0f, y), __fmul_rn(-2.0f, z),
                        __fmaf_ru(kC, m_q, kEpsFloor));
  }

  // this thread's A fragments of [1, qx, qy, qz] (column t) for rows g and
  // g + 8 of each m-tile - the k8's four registers (rows g, g + 8, g, g + 8)
  // and the k4's two - and for each of its eight rows (slot 2 mt + h) a
  // threshold and the exact (score, column) best over its columns
  uint32_t ah[kMT][4], al[kMT][2];
  float thr[kSlots], best[kSlots];
  int bidx[kSlots], cnt[kSlots];
  float err = 0.0f;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = blockIdx.x * kTile + wrow + mt * 16 + h * 8 + g;
      float a = 1.0f;
      if (t > 0) a = r < nq ? q[3 * (size_t)r + t - 1] : 0.0f;
      split_tf32(a, ah[mt][h], al[mt][h]);
      ah[mt][h + 2] = ah[mt][h];
      const int s = 2 * mt + h;
      thr[s] = best[s] = kBig;
      bidx[s] = cnt[s] = 0;
    }
  }

  for (int k0 = 0; k0 < n_steps; k0 += kRound) {
    cp_async_wait_all();
    // this round's chunks are visible to all, and all are done with the
    // last round's, whose buffers the next copies overwrite (the first
    // barrier also publishes sq)
    __syncthreads();
    for (int k = k0 + kRound; k < k0 + 2 * kRound; ++k) issue(k);
    for (int k = k0; k < k0 + kRound && k < n_steps; ++k) {
      const int st = k % kBuffers;
      if (k < n_seed) {  // the seed: screen only, thr holds the running minimum
        for (int j = 0; j < kChunk / 8; ++j) {
          const uint2 b = sb[st][t][j * 8 + g];
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            float acc[4];
            mma_k4(acc, al[mt][0], al[mt][1], b.x);
            mma_k8(acc, ah[mt], b.x, b.y);
            thr[2 * mt] = fminf(thr[2 * mt], fminf(acc[0], acc[1]));
            thr[2 * mt + 1] = fminf(thr[2 * mt + 1], fminf(acc[2], acc[3]));
          }
        }
        if (k == n_seed - 1) {  // the quad's smallest screen seeds the threshold
#pragma unroll
          for (int s = 0; s < kSlots; ++s) {
            float m = fminf(thr[s], __shfl_xor_sync(0xffffffffu, thr[s], 1));
            m = fminf(m, __shfl_xor_sync(0xffffffffu, m, 2));
            thr[s] = __fadd_ru(m, __fmul_ru(2.0f, sq[wrow + (s >> 1) * 16 + (s & 1) * 8 + g].w));
          }
        }
        continue;
      }
      const int col0 = (k - n_seed) * kChunk;  // the chunk's first column
      uint32_t pend = 0;  // this thread's n-tiles with candidates (bit j)
#pragma unroll 2
      for (int j = 0; j < kChunk / 8; ++j) {
        const uint2 b = sb[st][t][j * 8 + g];
        float acc[kMT][4];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma_k4(acc[mt], al[mt][0], al[mt][1], b.x);
          mma_k8(acc[mt], ah[mt], b.x, b.y);
        }
        bool hit = false;
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          hit |= (acc[mt][0] <= thr[2 * mt]) | (acc[mt][1] <= thr[2 * mt]) |
                 (acc[mt][2] <= thr[2 * mt + 1]) | (acc[mt][3] <= thr[2 * mt + 1]);
        }
        if (hit) pend |= 1u << j;
        if (kStats && hit) {  // the screen's error on each candidate
#pragma unroll
          for (int b2 = 0; b2 < 4 * kMT; ++b2) {
            const int mt = b2 >> 2, e = b2 & 3, s = 2 * mt + (e >> 1);
            if (acc[mt][e] <= thr[s]) {
              const float4 n = sq[wrow + mt * 16 + (e >> 1) * 8 + g];
              const int lc = j * 8 + 2 * t + (e & 1);
              const float v = score(n.x, n.y, n.z, sf[st][0][lc], sf[st][1][lc],
                                    sf[st][2][lc], sf[st][3][lc]);
              err = fmaxf(err, __fdividef(fabsf(__fsub_rn(acc[mt][e], v)), n.w));
            }
          }
        }
      }
      // the tiles with candidates, re-scored exactly: every pair of the
      // tile (this thread's 8 rows x its 2 columns), the tiles in column
      // order and a row's two columns in order, with a strict `<`
      while (pend) {
        const int j = __ffs(pend) - 1;
        pend &= pend - 1;
        const int lc = j * 8 + 2 * t;
        const float x0 = sf[st][0][lc], y0 = sf[st][1][lc], z0 = sf[st][2][lc];
        const float s0 = sf[st][3][lc];
        const float x1 = sf[st][0][lc + 1], y1 = sf[st][1][lc + 1], z1 = sf[st][2][lc + 1];
        const float s1 = sf[st][3][lc + 1];
#pragma unroll
        for (int s = 0; s < kSlots; ++s) {
          const float4 n = sq[wrow + (s >> 1) * 16 + (s & 1) * 8 + g];
          const float v0 = score(n.x, n.y, n.z, x0, y0, z0, s0);
          const float v1 = score(n.x, n.y, n.z, x1, y1, z1, s1);
          if (v0 < best[s]) {
            best[s] = v0;
            bidx[s] = col0 + lc;
          }
          if (v1 < best[s]) {
            best[s] = v1;
            bidx[s] = col0 + lc + 1;
          }
          if (kStats) cnt[s] += 2;
        }
      }
    }
    // the quad's best exact score lowers every thread's threshold
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      float b = fminf(best[s], __shfl_xor_sync(0xffffffffu, best[s], 1));
      b = fminf(b, __shfl_xor_sync(0xffffffffu, b, 2));
      thr[s] = fminf(thr[s], __fadd_ru(b, sq[wrow + (s >> 1) * 16 + (s & 1) * 8 + g].w));
    }
  }

  // the quad sharing a row merges by (score, column)
  if (kStats) {
    err = fmaxf(err, __shfl_xor_sync(0xffffffffu, err, 1));
    err = fmaxf(err, __shfl_xor_sync(0xffffffffu, err, 2));
  }
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    float v = best[s];
    int i = bidx[s];
    int c = cnt[s];
    for (int off = 1; off < 4; off <<= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, off);
      const int oi = __shfl_xor_sync(0xffffffffu, i, off);
      if (ov < v || (ov == v && oi < i)) {
        v = ov;
        i = oi;
      }
      if (kStats) c += __shfl_xor_sync(0xffffffffu, c, off);
    }
    const int r = blockIdx.x * kTile + wrow + (s >> 1) * 16 + (s & 1) * 8 + g;
    if (t == 0 && r < nq) {
      const float qq = sum_sq(q[3 * (size_t)r], q[3 * (size_t)r + 1], q[3 * (size_t)r + 2]);
      idx_out[r] = i;
      dist_out[r] = fmaxf(__fadd_rn(v, qq), 0.0f);
      if (kStats) {
        rescored_out[r] = c;
        err_out[r] = err;
      }
    }
  }
}

}  // namespace

// The prologue on `stream`: the pack_scene_mxu table (8, s_pad), s_pad a
// multiple of 128, split into split (s_pad / 128, 4, 128) (hi, lo) pairs
// of 32-bit words, and *smax2 = the largest |s|^2 of a real column.
// Returns the cudaError_t of the launch (0 = ok).
extern "C" int prt_nn_mxu_split(const float* table, int s_pad, void* split, float* smax2,
                                void* stream) {
  if (s_pad <= 0 || s_pad % kChunk) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = cudaMemsetAsync(smax2, 0, sizeof(float), s);
  if (e != cudaSuccess) return (int)e;
  nn_mxu_split_kernel<<<(s_pad + kSplitThreads - 1) / kSplitThreads, kSplitThreads, 0, s>>>(
      table, s_pad, static_cast<uint2*>(split), smax2);
  return (int)cudaGetLastError();
}

// Nearest scene point of nq queries (nq, 3) against the pack_scene_mxu
// table (8, s_pad), 16-byte aligned, and its prologue's split and smax2, on
// `stream`: idx (nq,) int32, dist (nq,) f32 = max(score + |q|^2, 0), B2's
// bits. With rescored and err (both or neither), each query's re-scored
// pairs and the largest |screen - B2 score| / eps_q of its quad's
// re-scores. Returns the cudaError_t of the launch (0 = ok).
extern "C" int prt_nn_mxu(const float* queries, int nq, const float* table, int s_pad,
                          const void* split, const float* smax2, int* idx, float* dist,
                          int* rescored, float* err, void* stream) {
  if (nq <= 0) return 0;
  if (s_pad <= 0 || s_pad % kChunk || (rescored == nullptr) != (err == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = (unsigned)((nq + kTile - 1) / kTile);
  const uint2* sp = static_cast<const uint2*>(split);
  if (rescored != nullptr) {
    nn_mxu_kernel<true><<<grid, kThreads, 0, s>>>(queries, nq, table, s_pad, sp, smax2, idx,
                                                   dist, rescored, err);
  } else {
    nn_mxu_kernel<false><<<grid, kThreads, 0, s>>>(queries, nq, table, s_pad, sp, smax2, idx,
                                                    dist, nullptr, nullptr);
  }
  return (int)cudaGetLastError();
}
