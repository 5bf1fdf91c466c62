// Row gather of an (R, 8) float32 table for Hopper (sm_90a): the ICP
// association's lookup of [point xyz | normal xyz | 0 0] rows.
//
// Replaces the Pallas TPU kernel scripts/probe_pallas_gather.py::gather_pallas
// (body `kernel`): out[i] = table[idx[i]]. Here the index is clamped into
// [0, R) first, which is what both association call sites compute: the
// projective query clamps the pixel before it forms the row, and the NN
// query clamps the flash kernels' indices (a padded-table index or the gated
// kernel's guard value would otherwise read past the table).
//
// What bounds it on the H100: bytes. Per output row it reads one 4- or
// 8-byte index and 32 bytes of the table, and writes 32 bytes; the bench
// refine's association gathers 524,288 rows a call, about 36 MB of traffic.
// The Pallas probe kept the whole table in VMEM; on Hopper the tables (a
// 640x480 frame is 307,200 rows, 9.8 MB) do not fit in shared memory but do
// fit in the 50 MB L2, so the table is not staged and is read through the
// read-only path (__ldg).
//
// Design. A thread with one row has one dependent chain in flight (index
// load, then two row loads, then two stores), and each of its warp's memory
// instructions touches 32 sectors half: a row is two 16-byte loads, so a
// warp's load instruction asks for half of 32 rows' sectors and the next
// for the other half, and its stores write 16 of every 32 bytes. Here a
// thread moves 16-byte halves of rows: lane pair (2k, 2k + 1) of a warp
// loads the two halves of one row with one instruction (16 whole sectors
// an instruction) and its stores write 512 contiguous bytes. A thread
// takes kHalves halves at a time, kThreads halves apart (a CTA steps over
// kThreads rows), issues both index and row loads before its first store,
// and the grid fills the SMs once (the kernel's occupancy times the SM
// count, asked of the runtime once a device) and strides over the rest.
// Lanes 2k and 2k + 1 read the same index, a broadcast within the warp's
// coalesced 64- or 128-byte index load, so an index view at any offset is
// read as it is. On an H100 this was faster at the bench association shape
// and at the tracked frame's than 4, 8 or 16 halves a thread, and than
// consecutive whole rows a thread with 16-byte index loads, whose warp
// instructions still ask for half sectors (PERF.md). A gather moves data
// and rounds nothing, so the kernel equals its plain version bit for bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kHalves = 2;  // halves a thread moves a step
constexpr int kMaxDevices = 64;

// out (as n x 2 halves) = table rows' halves; half f is row f / 2's half f % 2
template <typename Idx>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const float4* __restrict__ table, long long rows,
                   const Idx* __restrict__ idx, long long n, float4* __restrict__ out) {
  const long long total = 2 * n;
  const long long step = (long long)gridDim.x * kThreads * kHalves;
  for (long long base = (long long)blockIdx.x * kThreads * kHalves + threadIdx.x; base < total;
       base += step) {
    float4 v[kHalves];
#pragma unroll
    for (int k = 0; k < kHalves; ++k) {
      const long long f = base + (long long)k * kThreads;
      if (f < total) {
        long long r = (long long)__ldg(idx + (f >> 1));
        r = r < 0 ? 0 : (r >= rows ? rows - 1 : r);
        v[k] = __ldg(table + 2 * r + (f & 1));
      }
    }
#pragma unroll
    for (int k = 0; k < kHalves; ++k) {
      const long long f = base + (long long)k * kThreads;
      if (f < total) out[f] = v[k];
    }
  }
}

// CTAs that fill the card once: resident CTAs an SM of this instantiation
// times the SM count, asked once a device
template <typename Idx>
int grid_cap() {
  static int cap[kMaxDevices] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return 0;
  if (cap[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, gather_rows_kernel<Idx>, kThreads, 0) != cudaSuccess) {
      return 0;
    }
    cap[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  return cap[dev];
}

template <typename Idx>
int launch(const float4* table, long long rows, const Idx* idx, long long n, float4* out,
           cudaStream_t s) {
  const int cap = grid_cap<Idx>();
  if (cap == 0) {
    const cudaError_t e = cudaGetLastError();
    return e != cudaSuccess ? (int)e : (int)cudaErrorUnknown;
  }
  const long long per_cta = (long long)kThreads * kHalves;  // halves a CTA step
  long long grid = (2 * n + per_cta - 1) / per_cta;
  if (grid > cap) grid = cap;
  gather_rows_kernel<Idx><<<(unsigned)grid, kThreads, 0, s>>>(table, rows, idx, n, out);
  return (int)cudaGetLastError();
}

}  // namespace

// out (n, 8) = table (rows, 8)[clamp(idx, 0, rows - 1)] on `stream`. idx
// is int32 (idx_bytes 4) or int64 (idx_bytes 8), aligned to its element
// size; table and out are 16-byte aligned and contiguous. Returns the
// cudaError_t of the launch (0 = ok).
extern "C" int prt_gather_rows(const float* table, long long rows, const void* idx,
                               int idx_bytes, long long n, float* out, void* stream) {
  if (n <= 0) return 0;
  if (rows <= 0 || (idx_bytes != 4 && idx_bytes != 8) ||
      reinterpret_cast<uintptr_t>(idx) % idx_bytes) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* t = reinterpret_cast<const float4*>(table);
  float4* o = reinterpret_cast<float4*>(out);
  if (idx_bytes == 4) return launch<int>(t, rows, static_cast<const int*>(idx), n, o, s);
  return launch<long long>(t, rows, static_cast<const long long*>(idx), n, o, s);
}
