// Exact nearest-neighbour search with the score taken as a tensor-core
// product, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel scripts/probe_mxu_nn.py::nn_flash_mxu (body
// _kernel_mxu), a probe of B2's scoring (nn_flash.cu) on the TPU's matrix
// unit: score(q, s) = |s|^2 - 2 q.s as a (Q_TILE, 4) x (4, S_CHUNK) product
// at Precision.HIGHEST, with the running minimum on the vector unit. Hopper's
// matrix unit is the tensor cores, so here a 128-point chunk is scored with
// mma.sync.m16n8k8 in TF32 against the whole 8-row pack_scene_mxu tile:
//   A row (a query) = [0, 0, 0, 1, qx, qy, qz, 0]
//   B (8 x 128)     = [x; y; z; |s|^2; -2x; -2y; -2z; 0]    (table rows 0..7)
//   A . B           = |s|^2 - 2 q.s
// TF32 keeps 10 mantissa bits, so each operand is split into a TF32 high
// part and a TF32 remainder and the score is the 3xTF32 sum a_lo*b_hi +
// a_hi*b_lo + a_hi*b_hi (the lo*lo term, ~2^-22 relative, is dropped), the
// counterpart of HIGHEST's multi-pass product on the TPU. The accumulation
// order inside the tensor core is unspecified, so the scores are not those
// of any fixed float32 expression: the plain PyTorch version
// (scene/nn_mxu.py) takes the product in float64, rounded once, and the two
// agree up to near-ties (the band in scene/nn_mxu.py).
//
// Tie rule: of the pairs with the smallest score, the smallest scene index
// wins (the Pallas kernel's per-lane strict `<` across chunks, then the
// smallest chunk*128+lane among the lanes holding the row minimum). Every
// pair's score is computed once, so any order of reduction that keeps the
// (score, index) minimum gives that result. Here a thread visits its
// columns in increasing index order with a strict `<`, and the four threads
// of a quad that share a row merge their (score, index) pairs at the end.
//
// Layout: one CTA of 4 warps per 128 queries; warp w owns queries
// [32w, 32w+32) of the tile as two 16-row m-tiles. A chunk of the table
// (8 x 128 floats) is split into its TF32 parts once, when it is staged in
// shared memory (row stride 136 floats, so the B-fragment loads of a warp
// hit 32 distinct banks), and every warp reads it for its 16 n-tiles of 8
// points. In the accumulator fragment a thread holds rows g and g+8 of each
// m-tile (g = lane / 4) at columns 2t, 2t+1 (t = lane % 4) of each n-tile.
//
// What bounds it on the H100: the tensor cores take 3 x 16 x 8 x 8 MACs per
// 128 (query, point) pairs (48 flop a pair, half of them on the zero columns
// of A), and mma.sync does not reach the wgmma peak of 495 TFLOP/s; the
// argmin stays on the CUDA cores at three instructions a pair (the compare,
// the selects of score and index), against B2's eight: the tensor cores
// remove only the score's arithmetic. The design keeps the per-pair
// CUDA-core work to those three (the index is a constant offset per
// accumulator element) and splits the scene operand once per chunk rather
// than once per warp. The least an argmin needs is two a pair (a min of the
// score, and a compare that finds the rare chunks that improve it, the only
// place the index must change): chip_smoke.py bounds the kernel by that.
// m16n8k4 (no zero columns), fewer split products, the two-instruction
// argmin and a wgmma/TMA pipeline are later work.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kChunk = 128;           // scene points per chunk (S_CHUNK)
constexpr int kTile = 128;            // queries per CTA
constexpr int kStride = kChunk + 8;   // shared-memory row stride in floats
constexpr float kBig = 3.0e38f;

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo with hi, lo in TF32 (x - hi is exact in float32)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(__fsub_rn(x, __uint_as_float(hi)));
}

// d += a (16x8, row) * b (8x8, col), TF32 operands, float32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// |q|^2 as XLA contracts jnp.sum(q * q, -1), as nn_flash.cu's sum_sq
__device__ __forceinline__ float sum_sq(float x, float y, float z) {
  return __fmaf_rn(z, z, __fmaf_rn(y, y, __fmul_rn(x, x)));
}

__global__ void __launch_bounds__(kTile)
nn_mxu_kernel(const float* __restrict__ q, int nq, const float* __restrict__ table, int s_pad,
              int* __restrict__ idx_out, float* __restrict__ dist_out) {
  __shared__ uint32_t b_hi[8][kStride];
  __shared__ uint32_t b_lo[8][kStride];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * kTile + warp * 32;  // first query of this warp

  // A fragments of the two m-tiles: a0/a1 at column t (1 in column 3),
  // a2/a3 at column t + 4 (qx, qy, qz, 0), rows g and g + 8
  uint32_t a_hi[2][4], a_lo[2][4];
  const uint32_t one = (t == 3) ? to_tf32(1.0f) : 0u;
  for (int mt = 0; mt < 2; ++mt) {
    float v[2] = {0.0f, 0.0f};
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + mt * 16 + h * 8 + g;
      if (t < 3 && r < nq) v[h] = q[3 * (size_t)r + t];
    }
    a_hi[mt][0] = a_hi[mt][1] = one;
    a_lo[mt][0] = a_lo[mt][1] = 0u;
    split_tf32(v[0], a_hi[mt][2], a_lo[mt][2]);
    split_tf32(v[1], a_hi[mt][3], a_lo[mt][3]);
  }

  // running (score, index) minimum of rows (mt, h): slot 2 * mt + h
  float best[4] = {kBig, kBig, kBig, kBig};
  int bidx[4] = {0, 0, 0, 0};
  const int n_chunks = s_pad / kChunk;
  for (int c = 0; c < n_chunks; ++c) {
    __syncthreads();  // every warp is done with the previous chunk
    for (int r = 0; r < 8; ++r) {
      split_tf32(table[(size_t)r * s_pad + (size_t)c * kChunk + tid], b_hi[r][tid], b_lo[r][tid]);
    }
    __syncthreads();
    for (int j = 0; j < kChunk / 8; ++j) {
      const int col = j * 8 + g;  // B fragment: rows t and t + 4, column g
      const uint32_t bh0 = b_hi[t][col], bh1 = b_hi[t + 4][col];
      const uint32_t bl0 = b_lo[t][col], bl1 = b_lo[t + 4][col];
      const int base = c * kChunk + j * 8 + 2 * t;
      for (int mt = 0; mt < 2; ++mt) {
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_tf32(acc, a_lo[mt], bh0, bh1);
        mma_tf32(acc, a_hi[mt], bl0, bl1);
        mma_tf32(acc, a_hi[mt], bh0, bh1);
        for (int e = 0; e < 4; ++e) {  // e: row g + 8 * (e >> 1), column 2t + (e & 1)
          const int slot = 2 * mt + (e >> 1);
          if (acc[e] < best[slot]) {  // strict: the smaller index keeps ties
            best[slot] = acc[e];
            bidx[slot] = base + (e & 1);
          }
        }
      }
    }
  }

  for (int slot = 0; slot < 4; ++slot) {
    float v = best[slot];
    int i = bidx[slot];
    for (int off = 1; off < 4; off <<= 1) {  // the quad sharing this row
      const float ov = __shfl_xor_sync(0xffffffffu, v, off);
      const int oi = __shfl_xor_sync(0xffffffffu, i, off);
      if (ov < v || (ov == v && oi < i)) {
        v = ov;
        i = oi;
      }
    }
    const int r = row0 + (slot >> 1) * 16 + (slot & 1) * 8 + g;
    if (t == 0 && r < nq) {
      const float qq = sum_sq(q[3 * (size_t)r], q[3 * (size_t)r + 1], q[3 * (size_t)r + 2]);
      idx_out[r] = i;
      dist_out[r] = fmaxf(__fadd_rn(v, qq), 0.0f);
    }
  }
}

}  // namespace

// Nearest scene point of nq queries (nq, 3) against the pack_scene_mxu
// table (8, s_pad), on `stream`: idx (nq,) int32, dist (nq,) f32 =
// max(score + |q|^2, 0). Returns the cudaError_t of the launch (0 = ok).
extern "C" int prt_nn_mxu(const float* queries, int nq, const float* table, int s_pad,
                          int* idx, float* dist, void* stream) {
  if (nq <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  nn_mxu_kernel<<<(nq + kTile - 1) / kTile, kTile, 0, s>>>(queries, nq, table, s_pad, idx, dist);
  return (int)cudaGetLastError();
}
