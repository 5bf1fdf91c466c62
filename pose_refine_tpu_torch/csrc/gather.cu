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
// fit in the 50 MB L2, so the table is not staged: one thread per output
// row, two 16-byte loads through the read-only path and two 16-byte stores,
// consecutive threads on consecutive output rows. A gather moves data and
// rounds nothing, so the kernel equals its plain version bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename Idx>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const float4* __restrict__ table, long long rows,
                   const Idx* __restrict__ idx, long long n, float4* __restrict__ out) {
  const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (i >= n) return;
  long long r = (long long)__ldg(idx + i);
  r = r < 0 ? 0 : (r >= rows ? rows - 1 : r);
  const float4 a = __ldg(table + 2 * r);
  const float4 b = __ldg(table + 2 * r + 1);
  out[2 * i] = a;
  out[2 * i + 1] = b;
}

}  // namespace

// out (n, 8) = table (rows, 8)[clamp(idx, 0, rows - 1)] on `stream`. idx is
// int32 (idx_bytes 4) or int64 (idx_bytes 8); table and out are 16-byte
// aligned and contiguous. Returns the cudaError_t of the launch (0 = ok).
extern "C" int prt_gather_rows(const float* table, long long rows, const void* idx,
                               int idx_bytes, long long n, float* out, void* stream) {
  if (n <= 0) return 0;
  if (rows <= 0 || (idx_bytes != 4 && idx_bytes != 8)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long grid = (n + kThreads - 1) / kThreads;
  const float4* t = reinterpret_cast<const float4*>(table);
  float4* o = reinterpret_cast<float4*>(out);
  if (idx_bytes == 4) {
    gather_rows_kernel<int><<<(unsigned)grid, kThreads, 0, s>>>(
        t, rows, static_cast<const int*>(idx), n, o);
  } else {
    gather_rows_kernel<long long><<<(unsigned)grid, kThreads, 0, s>>>(
        t, rows, static_cast<const long long*>(idx), n, o);
  }
  return (int)cudaGetLastError();
}
