// L1: the refine's window lift of an (N, H, W) int32 framebuffer for Hopper
// (sm_90a), in one launch.
//
// Replaces the JAX package's XLA code of the lift (no Pallas kernel behind
// it): pose_refine_tpu/ops/depth_to_cloud.py::window_cloud_batched (:198),
// compact_topk (:101) and morton_key (:79) as pose_refine_tpu/pipeline.py:
// 111-146 composes them. Its plain version is
// pose_refine_tpu_torch/ops/depth_to_cloud.py::window_lift (the port's
// PyTorch of the same functions); this kernel equals it bit for bit.
//
// What it computes, for each pose n (one CTA):
//   1. the object box r0, r1, c0, c1: the least / greatest row and column
//      holding a pixel > 0 (r0 = H, r1 = -1 and c0 = W, c1 = -1 when empty);
//   2. the crop origin cy = clip(floor((r0 + r1) / 2) - window / 2, 0,
//      max(H - window, 0)), cx likewise;
//   3. the strided window: sh x sw slots, sh = ceil(min(window, H) / stride),
//      P = sh * sw, slot r at pixel (cy + (r / sw) * stride, cx + (r % sw) *
//      stride);
//   4. the slot's point, in the rounded operations of the plain version on
//      the card: z = d * fl(1 / 1000) (a CUDA tensor divided by a host scalar
//      is a product with the scalar's float reciprocal in PyTorch), x = ((u -
//      K[0,2]) / K[0,0]) * z, y likewise (true divisions: K is a tensor on the
//      card), each operation one _rn intrinsic so that nothing is contracted;
//      valid = d > 0, an invalid row all zeros;
//   5. when k = max_points < P, the selection of compact_topk: the valid slots
//      by ascending hash rank ((r * M) as wrapping int32) mod P (Python sign,
//      M = 2654435761 & 0x7FFFFFFF), ties to the lower r, then the invalid
//      slots by ascending r; the first k are kept;
//   6. the order: projective scenes take the selection's order (the identity
//      without a selection); NN scenes (`morton`) the Morton order of the
//      slots' (row, column) - with a selection the kept valid slots, then the
//      kept invalid ones; without one all P slots, invalid ones interleaved.
//
// What bounds it on the H100: bytes. It must read the framebuffer once (the
// bench's 256 renders of 256 x 200: 52.4 MB) and write P' = min(k, P) rows of
// 13 bytes a pose (6.8 MB); a handful of integer operations a pixel and ~8
// float operations a kept point are far below the byte time.
//
// Design. One CTA a pose: everything the selection and the orders need is
// per pose, so no CTA waits for another and nothing is reduced across CTAs.
// The box is a pass over the pose's framebuffer with 16-byte loads (when the
// pose's base is 16-byte aligned), each thread's running extremes reduced by
// warp reductions and shared atomics. The window's slots are read again by
// the later passes, from L2. No comparison sort:
//   - ranks: each valid slot adds one to its rank's bucket (a shared atomic),
//     an exclusive block scan of the P buckets gives their starts (and
//     n_valid), each valid slot takes a place in its bucket (an atomic, in no
//     set order) and one thread a bucket orders its few slots by r. At a
//     power-of-two P the hash is a bijection and every bucket holds one slot
//     at most; elsewhere ranks collide (P = 2500: 2,179 ranks) and the
//     in-bucket order is what keeps compact_topk's tie rule. The k kept valid
//     slots are the first k of the buckets' concatenation; the invalid slots
//     before k are found by a block scan over r.
//   - Morton order: the Morton rank of a slot (the number of grid cells with
//     a smaller Morton code) is counted directly, level by level: at each of
//     the code's 2-bit digits the cells of the quadrants before the slot's own
//     that lie inside the sh x sw grid, O(log max(sh, sw)). Without a
//     selection a slot's output row is its Morton rank. With one, each kept
//     slot is written at its Morton rank in a P-entry array, and one block
//     scan over that array gives the kept valid slots their rows and the kept
//     invalid ones theirs after them. A walk over the Morton code space would
//     visit 4^ceil(log2 max(sh, sw)) codes, up to 2^28 for a thin window; the
//     rank space has exactly P entries.
// The two P-entry int arrays (bucket counts, later the Morton slots; the
// bucket lists) live in dynamic shared memory when 8P bytes fit
// kSharedCapBytes (P <= 28,672; the bench's 4,096 takes 32 KB) and otherwise
// in a scratch buffer the wrapper allocates (N x 2P ints), addressed through
// the same generic pointer. Without a selection the kernel needs neither.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// dynamic shared memory a CTA may take for its two P-entry arrays; mirrored
// by ops/lift_cuda.py::SHARED_CAP_BYTES, which allocates the scratch above it
constexpr int kSharedCapBytes = 224 * 1024;
constexpr unsigned kHashMul = 2654435761u & 0x7FFFFFFFu;
constexpr int kInvalidBit = 1 << 30;  // a kept invalid slot in the Morton array
constexpr int kMortonCap = 1 << 14;   // morton_key's 14-bit grid

struct Params {
  const int* depth;
  const float* K;
  float* clouds;
  unsigned char* valid;
  int* scratch;  // nullptr: the arrays live in dynamic shared memory
  int h, w, window, stride, sh, sw, p, k, levels, morton, tl_x, tl_y;
};

struct ScanSmem {
  long long warp[kWarps];
  long long total;
};

// exclusive prefix sum of one value a thread, in thread order; ``total`` is
// the block's sum. Ends with a barrier, so it may be called again at once.
__device__ long long block_scan(long long v, ScanSmem& s, long long& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) s.warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const long long wv = lane < kWarps ? s.warp[lane] : 0;
    long long wi = wv;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long t = __shfl_up_sync(0xffffffffu, wi, o);
      if (lane >= o) wi += t;
    }
    if (lane < kWarps) s.warp[lane] = wi - wv;
    if (lane == 31) s.total = wi;
  }
  __syncthreads();
  const long long excl = s.warp[warp] + incl - v;
  total = s.total;
  __syncthreads();
  return excl;
}

__device__ __forceinline__ int floor_half(int s) { return s >= 0 ? s / 2 : -((1 - s) / 2); }

__device__ __forceinline__ int clamp_int(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// compact_topk's rank: (r * kHashMul as wrapping int32) mod p, Python sign
__device__ __forceinline__ int hash_rank(int r, int p) {
  const int prod = (int)((unsigned)r * kHashMul);
  const int m = prod % p;
  return m < 0 ? m + p : m;
}

// the number of cells of the sh x sw grid whose Morton code (column bit l at
// code bit 2l, row bit l at 2l + 1) is below the code of (row, col)
__device__ int morton_rank(int row, int col, int sh, int sw, int levels) {
  int count = 0, rb = 0, cb = 0;
  for (int l = levels - 1; l >= 0; --l) {
    const int side = 1 << l;
    const int digit = (((row >> l) & 1) << 1) | ((col >> l) & 1);
    for (int t = 0; t < digit; ++t) {
      const int br = rb + ((t >> 1) << l), bc = cb + ((t & 1) << l);
      count += clamp_int(sh - br, 0, side) * clamp_int(sw - bc, 0, side);
    }
    rb += (digit >> 1) << l;
    cb += (digit & 1) << l;
  }
  return count;
}

// one pose's window: its framebuffer, crop origin and camera
struct Window {
  const int* img;
  int w, sw, stride, cy, cx, u0, v0, sh, levels;
  float fx, ppx, fy, ppy;

  __device__ __forceinline__ int depth_at(int r) const {
    const int i = r / sw, j = r - i * sw;
    return img[(cy + i * stride) * w + cx + j * stride];
  }

  __device__ __forceinline__ int morton(int r) const {
    const int i = r / sw;
    return morton_rank(i, r - i * sw, sh, sw, levels);
  }

  // slot r's point and valid flag into output row ``row``
  __device__ __forceinline__ void put(int r, float* cl, unsigned char* vl, int row) const {
    const int i = r / sw, j = r - i * sw;
    const int d = img[(cy + i * stride) * w + cx + j * stride];
    float x = 0.0f, y = 0.0f, z = 0.0f;
    if (d > 0) {
      // PyTorch's float reciprocal of the host scalar 1000, rounded once
      z = __fmul_rn(__int2float_rn(d), 1.0f / 1000.0f);
      const float u = __int2float_rn(u0 + j * stride), v = __int2float_rn(v0 + i * stride);
      x = __fmul_rn(__fdiv_rn(__fsub_rn(u, ppx), fx), z);
      y = __fmul_rn(__fdiv_rn(__fsub_rn(v, ppy), fy), z);
    }
    float* o = cl + 3LL * row;
    o[0] = x;
    o[1] = y;
    o[2] = z;
    vl[row] = d > 0 ? 1 : 0;
  }
};

// the object box of one (h, w) framebuffer into box = {r0, r1, c0, c1}
// (set by the caller to {h, -1, w, -1} before a barrier)
__device__ void object_box(const int* img, int h, int w, int* box) {
  int r0 = h, r1 = -1, c0 = w, c1 = -1;
  auto take = [&](int r, int c) {
    r0 = min(r0, r);
    r1 = max(r1, r);
    c0 = min(c0, c);
    c1 = max(c1, c);
  };
  const int hw = h * w;
  int scalar_from = 0;  // the pixels from here on are read one at a time
  if ((reinterpret_cast<uintptr_t>(img) & 15) == 0) {
    const int n4 = hw >> 2;
    const int4* img4 = reinterpret_cast<const int4*>(img);
    for (int f4 = threadIdx.x; f4 < n4; f4 += kThreads) {
      const int4 q = __ldg(img4 + f4);
      if (q.x > 0 || q.y > 0 || q.z > 0 || q.w > 0) {
        int r = (4 * f4) / w, c = 4 * f4 - r * w;
        const int v[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (v[e] > 0) take(r, c);
          if (++c == w) {
            c = 0;
            ++r;
          }
        }
      }
    }
    scalar_from = 4 * n4;
  }
  for (int f = scalar_from + threadIdx.x; f < hw; f += kThreads) {
    if (__ldg(img + f) > 0) {
      const int r = f / w;
      take(r, f - r * w);
    }
  }
  r0 = __reduce_min_sync(0xffffffffu, r0);
  r1 = __reduce_max_sync(0xffffffffu, r1);
  c0 = __reduce_min_sync(0xffffffffu, c0);
  c1 = __reduce_max_sync(0xffffffffu, c1);
  if ((threadIdx.x & 31) == 0) {
    atomicMin(box + 0, r0);
    atomicMax(box + 1, r1);
    atomicMin(box + 2, c0);
    atomicMax(box + 3, c1);
  }
}

// calls f(r, i) for the invalid slots r of the window in ascending order
// whose index i among the invalid slots is below ``want``; block-uniform
template <typename F>
__device__ void first_invalid(const Window& g, int p, int want, ScanSmem& s, F f) {
  long long seen = 0;
  for (int base = 0; base < p && seen < want; base += kThreads) {
    const int r = base + threadIdx.x;
    const bool inv = r < p && g.depth_at(r) <= 0;
    long long total;
    const long long before = seen + block_scan(inv ? 1 : 0, s, total);
    if (inv && before < want) f(r, (int)before);
    seen += total;
  }
}

__global__ void __launch_bounds__(kThreads, 2) window_lift_kernel(Params P) {
  __shared__ int box[4];
  __shared__ ScanSmem scan;
  extern __shared__ int dyn[];
  const int n = blockIdx.x;
  const int* img = P.depth + (long long)n * P.h * P.w;
  const bool select = P.k < P.p;
  const int out_rows = select ? P.k : P.p;
  float* cl = P.clouds + 3LL * n * out_rows;
  unsigned char* vl = P.valid + (long long)n * out_rows;
  // bucket counts (later the Morton array) and bucket lists, P entries each
  int* cnt = select ? (P.scratch != nullptr ? P.scratch + 2LL * n * P.p : dyn) : nullptr;
  int* list = select ? cnt + P.p : nullptr;

  if (threadIdx.x == 0) {
    box[0] = P.h;
    box[1] = -1;
    box[2] = P.w;
    box[3] = -1;
  }
  if (select) {
    for (int q = threadIdx.x; q < P.p; q += kThreads) cnt[q] = 0;
  }
  __syncthreads();
  object_box(img, P.h, P.w, box);
  __syncthreads();

  const int half = P.window / 2;
  Window g;
  g.img = img;
  g.w = P.w;
  g.sw = P.sw;
  g.sh = P.sh;
  g.levels = P.levels;
  g.stride = P.stride;
  g.cy = clamp_int(floor_half(box[0] + box[1]) - half, 0, max(P.h - P.window, 0));
  g.cx = clamp_int(floor_half(box[2] + box[3]) - half, 0, max(P.w - P.window, 0));
  g.u0 = P.tl_x + g.cx;
  g.v0 = P.tl_y + g.cy;
  g.fx = __ldg(P.K + 0);
  g.ppx = __ldg(P.K + 2);
  g.fy = __ldg(P.K + 4);
  g.ppy = __ldg(P.K + 5);

  if (!select) {
    for (int r = threadIdx.x; r < P.p; r += kThreads) {
      g.put(r, cl, vl, P.morton ? g.morton(r) : r);
    }
    return;
  }

  // the valid slots' hash ranks: bucket counts, their starts, the buckets
  for (int r = threadIdx.x; r < P.p; r += kThreads) {
    if (g.depth_at(r) > 0) atomicAdd(cnt + hash_rank(r, P.p), 1);
  }
  __syncthreads();
  long long n_valid = 0;
  for (int base = 0; base < P.p; base += kThreads) {
    const int q = base + threadIdx.x;
    long long total;
    const long long start = n_valid + block_scan(q < P.p ? cnt[q] : 0, scan, total);
    if (q < P.p) cnt[q] = (int)start;
    n_valid += total;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < P.p; r += kThreads) {
    if (g.depth_at(r) > 0) list[atomicAdd(cnt + hash_rank(r, P.p), 1)] = r;
  }
  __syncthreads();
  // cnt[q] is now bucket q's end: order each bucket's slots by r
  for (int q = threadIdx.x; q < P.p; q += kThreads) {
    const int lo = q > 0 ? cnt[q - 1] : 0, hi = cnt[q];
    for (int a = lo + 1; a < hi; ++a) {
      const int v = list[a];
      int b = a - 1;
      while (b >= lo && list[b] > v) {
        list[b + 1] = list[b];
        --b;
      }
      list[b + 1] = v;
    }
  }
  __syncthreads();
  const int kept_valid = (int)(n_valid < P.k ? n_valid : P.k);
  const int kept_invalid = P.k - kept_valid;

  if (!P.morton) {
    for (int a = threadIdx.x; a < kept_valid; a += kThreads) g.put(list[a], cl, vl, a);
    first_invalid(g, P.p, kept_invalid, scan,
                  [&](int r, int i) { g.put(r, cl, vl, kept_valid + i); });
    return;
  }

  // Morton order of the kept slots: each at its Morton rank, then one scan
  int* slot_at = cnt;
  for (int m = threadIdx.x; m < P.p; m += kThreads) slot_at[m] = -1;
  __syncthreads();
  for (int a = threadIdx.x; a < kept_valid; a += kThreads) {
    const int r = list[a];
    slot_at[g.morton(r)] = r;
  }
  first_invalid(g, P.p, kept_invalid, scan,
                [&](int r, int) { slot_at[g.morton(r)] = r | kInvalidBit; });
  __syncthreads();
  // packed counts before each entry: kept slots << 32 | kept valid slots
  long long before_base = 0;
  for (int base = 0; base < P.p; base += kThreads) {
    const int m = base + threadIdx.x;
    const int s = m < P.p ? slot_at[m] : -1;
    const long long v = s < 0 ? 0 : ((1LL << 32) | ((s & kInvalidBit) ? 0 : 1));
    long long total;
    const long long before = before_base + block_scan(v, scan, total);
    if (s >= 0) {
      const int kept = (int)(before >> 32), valid_before = (int)(before & 0xffffffffLL);
      if (s & kInvalidBit) {
        g.put(s & ~kInvalidBit, cl, vl, kept_valid + (kept - valid_before));
      } else {
        g.put(s, cl, vl, valid_before);
      }
    }
    before_base += total;
  }
}

}  // namespace

// The window lift of n (h, w) int32 renders on `stream` (see the note
// above): clouds (n, P', 3) float32 and valid (n, P') bytes 0 / 1, P' =
// min(max_points, P). K: the 3 x 3 float32 camera on the card. scratch: n x
// 2P int32 when max_points < P and 8P > kSharedCapBytes, else nullptr.
// Returns the cudaError_t of the launch (0 = ok).
extern "C" int prt_window_lift(const int* depth, int n, int h, int w, const float* K,
                               int window, int stride, int max_points, int morton, int tl_x,
                               int tl_y, float* clouds, unsigned char* valid, int* scratch,
                               void* stream) {
  if (n <= 0) return 0;
  if (h <= 0 || w <= 0 || window <= 0 || stride <= 0 || max_points <= 0 ||
      (long long)h * w >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  Params prm;
  prm.depth = depth;
  prm.K = K;
  prm.clouds = clouds;
  prm.valid = valid;
  prm.scratch = scratch;
  prm.h = h;
  prm.w = w;
  prm.window = window;
  prm.stride = stride;
  prm.sh = ((window < h ? window : h) + stride - 1) / stride;
  prm.sw = ((window < w ? window : w) + stride - 1) / stride;
  prm.p = prm.sh * prm.sw;
  prm.k = max_points;
  prm.morton = morton != 0;
  prm.tl_x = tl_x;
  prm.tl_y = tl_y;
  const int side = prm.sh > prm.sw ? prm.sh : prm.sw;
  if (prm.morton && side > kMortonCap) return (int)cudaErrorInvalidValue;
  prm.levels = 0;
  while ((1 << prm.levels) < side) ++prm.levels;
  size_t smem = 0;
  if (max_points < prm.p && scratch == nullptr) {
    smem = 2 * sizeof(int) * (size_t)prm.p;
    if (smem > (size_t)kSharedCapBytes) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          window_lift_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
  }
  window_lift_kernel<<<n, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(prm);
  return (int)cudaGetLastError();
}
