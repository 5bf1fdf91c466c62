// Probe of the ICP iteration kernel's source (csrc/icp_reduce.cu, or another
// revision of it with the same C interface): the pose tail alone, and the
// residency of the source's kernels on the card.
//
// Not compiled on its own: probes/icp_tail.py compiles a unit that includes
// the kernel source first and this file after it, so the probe runs the
// source's own device functions and instantiations (the same code, flags and
// registers as the kernel library's), and defines PRT_PROBE_WARP_TAIL and
// PRT_PROBE_THREADS_TEMPLATE after the source's signatures.
//
//  * tail_probe_kernel: one CTA of one warp a pose, as the kernel's rank-0
//    CTA runs a pose's tail. It calls the source's iteration_tail (or
//    coarse_tail) `reps` times on the pose's 29 sums, in the way the source
//    calls it: by the warp where its tail takes the lane's sum
//    (PRT_PROBE_WARP_TAIL, the warp-wide tail), else by thread 0 (the
//    one-thread tail of before). The
//    convergence thresholds are 0 and the last iteration is out of reach, so
//    the latch never stops a pose; T is composed with the same update every
//    repetition. The launch's time over `reps` is the tail's latency a pose.
//  * prt_probe_residency: cudaFuncGetAttributes (registers, local bytes a
//    thread, static shared memory) and
//    cudaOccupancyMaxActiveBlocksPerMultiprocessor (CTAs an SM at the given
//    dynamic shared memory) of one instantiation of the iteration kernel, at
//    a thread count where the source has two.

namespace {

__global__ void tail_probe_kernel(const float* sums, const float* state, int reps, int coarse,
                                  float* out) {
  __shared__ float s[32];
  __shared__ float ps[19];
  __shared__ float step[13];
  const int lane = threadIdx.x;
  const long long pose = blockIdx.x;
  s[lane] = lane < 29 ? sums[29 * pose + lane] : 0.f;
  if (lane < 19) ps[lane] = state[19 * pose + lane];
  __syncwarp();
  for (int r = 0; r < reps; ++r) {
#ifdef PRT_PROBE_WARP_TAIL
    if (coarse) {
      coarse_tail(s[lane], ps, step);
    } else {
      iteration_tail(s[lane], ps, step, 1e4f, 0, INT_MAX, 0.f, 0.f);
    }
#else
    if (lane == 0) {
      if (coarse) {
        coarse_tail(s, ps, step);
      } else {
        iteration_tail(s, ps, step, 1e4f, 0, INT_MAX, 0.f, 0.f);
      }
    }
#endif
    __syncwarp();
  }
  if (lane < 13) out[32 * pose + lane] = step[lane];
  if (lane < 19) out[32 * pose + 13 + lane] = ps[lane];
}

template <typename K>
int residency_of(K kernel, int threads, int smem_bytes, int* out) {
  cudaFuncAttributes at;
  cudaError_t e = cudaFuncGetAttributes(&at, kernel);
  if (e != cudaSuccess) return (int)e;
  if (smem_bytes > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  out[0] = at.numRegs;
  out[1] = (int)at.localSizeBytes;
  out[2] = blocks;
  out[3] = (int)at.sharedSizeBytes;
  out[4] = threads;
  return 0;
}

#ifdef PRT_PROBE_THREADS_TEMPLATE
// a source whose kernels take their thread count as a template parameter
template <bool kProj, bool kP2P, typename Idx>
int residency_mode(int threads, int smem_bytes, int* out) {
  return threads == kNarrow
             ? residency_of(icp_iterate_kernel<kNarrow, kProj, kP2P, Idx>, kNarrow, smem_bytes,
                            out)
             : residency_of(icp_iterate_kernel<kWide, kProj, kP2P, Idx>, kWide, smem_bytes, out);
}
#else
// a source of one thread count, kThreads
template <bool kProj, bool kP2P, typename Idx>
int residency_mode(int, int smem_bytes, int* out) {
  return residency_of(icp_iterate_kernel<kProj, kP2P, Idx>, kThreads, smem_bytes, out);
}
#endif

template <bool kProj, typename Idx>
int residency_front(int p2p, int threads, int smem_bytes, int* out) {
  return p2p ? residency_mode<kProj, true, Idx>(threads, smem_bytes, out)
             : residency_mode<kProj, false, Idx>(threads, smem_bytes, out);
}

}  // namespace

// out (n, 32): the tail's step (13) and the pose state (19) after `reps`
// tails of each of n poses from sums (n, 29) and state (n, 19) [T (16),
// fitness, rmse, done]. Returns the cudaError_t of the launch.
extern "C" int prt_probe_tail(const float* sums, const float* state, int n, int reps, int coarse,
                              float* out, void* stream) {
  if (n <= 0) return 0;
  tail_probe_kernel<<<n, 32, 0, static_cast<cudaStream_t>(stream)>>>(sums, state, reps, coarse,
                                                                     out);
  return (int)cudaGetLastError();
}

// out[5] = registers a thread, local bytes a thread, CTAs an SM at
// smem_bytes of dynamic shared memory, static shared bytes, threads a CTA
// of the iteration kernel, by front end (projective: idx_bytes 0; indexed:
// 4 or 8), terms (p2p) and threads a CTA (a source of one thread count
// ignores it). Returns a cudaError_t.
extern "C" int prt_probe_residency(int idx_bytes, int p2p, int threads, int smem_bytes,
                                   int* out) {
  if (idx_bytes == 0) return residency_front<true, int>(p2p, threads, smem_bytes, out);
  return idx_bytes == 4 ? residency_front<false, int>(p2p, threads, smem_bytes, out)
                        : residency_front<false, long long>(p2p, threads, smem_bytes, out);
}
