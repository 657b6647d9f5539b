// Kernel K1: bulk AREPAS runtimes (paper Algorithm 1), written by hand for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/skyline.py::
// skyline_runtimes (_skyline_kernel). Same contract:
//   (J, Smax) int32 skylines x (J,) int32 valid lengths x (J, K) int32
//   allocations -> (J, K) int32 simulated runtimes,
// runtime = seconds with s <= nt + sum over maximal runs of s > nt of
// floor(run area / nt). Its plain PyTorch version is
// repro_torch/core/arepas.py::simulate_runtime_batch.
//
// What bounds it: bytes. Each second costs a compare and an add, so the
// least time is the valid prefix of every skyline read once (plus the
// allocation and output bytes) at the memory rate. The design therefore
// reads each job's valid prefix exactly once, whatever K is (up to the
// block's warp count), and never touches the padding past valid_len:
//   * one block per job; 8 warps; warp w owns allocation k = k0 + w;
//   * the block walks the valid prefix in 1024-second tiles, loaded once
//     into shared memory with coalesced reads (skewed by one word every 32
//     so lane-contiguous reads are free of bank conflicts) and used by all
//     8 allocations;
//   * inside a tile each lane folds 32 consecutive seconds into a Run
//     summary, the warp combines the 32 summaries in order with shuffles,
//     and lane 0 folds the tile's summary into its carry: the open over-cap
//     run crosses tile edges as the carry's int64 tail.
// The TPU kernel's one-hot T x T matmul (TPUs avoid scatters), its
// Smax % time_block tiling constraint and its f32 floor(x / nt + 1e-6)
// nudge have no counterpart here: areas are int64 and the stretched length
// is exact integer division.
//
// The run algebra (struct Run, its fold, combine and warp reduction) lives
// in arepas_run.cuh, which kernel K3 (cluster_step.cu) shares.
//
// `rows`, where given, maps output row j to skyline row rows[j] of a
// resident pool (and its length), so a caller that holds every skyline on
// the card passes a (J,) index instead of copying (J, Smax) rows.

#include <cuda_runtime.h>
#include <stdint.h>

#include "arepas_run.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPerLane = 32;                  // consecutive seconds per lane
constexpr int kTile = 32 * kPerLane;          // seconds per tile
constexpr int kShared = kTile + kTile / 32;   // one pad word per 32

using arepas::Run;

__global__ void __launch_bounds__(kThreads)
arepas_runtimes_kernel(const int* __restrict__ sky,
                       const int* __restrict__ lens,
                       const long long* __restrict__ rows,
                       const int* __restrict__ allocs,
                       int* __restrict__ out, int smax, int K) {
  __shared__ int tile[kShared];
  const int j = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long src = rows ? rows[j] : j;
  const int* row = sky + src * smax;
  const int vlen = min(max(lens[src], 0), smax);

  for (int k0 = 0; k0 < K; k0 += kWarps) {
    const int k = k0 + warp;
    const int a = k < K ? allocs[(long long)j * K + k] : 1;
    const int nt = a >= 1 ? a : 1;
    Run carry = arepas::identity();

    for (int t0 = 0; t0 < vlen; t0 += kTile) {
      const int n = min(kTile, vlen - t0);
      __syncthreads();  // the previous tile is no longer read
      for (int e = threadIdx.x; e < n; e += kThreads)
        tile[e + e / 32] = row[t0 + e];
      __syncthreads();

      // this lane's 32 consecutive seconds, folded left to right
      Run r = arepas::identity();
      const int base = lane * kPerLane;
      const int stop = min(kPerLane, n - base);
      for (int i = 0; i < stop; ++i)
        arepas::push(r, tile[lane * (kPerLane + 1) + i], nt);
      r = arepas::warp_combine(r, lane, nt);
      if (lane == 0) carry = arepas::combine(carry, r, nt);
    }

    if (lane == 0 && k < K) {
      out[(long long)j * K + k] = a >= 1 ? arepas::runtime(carry, vlen, nt) : -1;
    }
  }
}

}  // namespace

// Plain C interface for ctypes. Launches on `stream`, does not synchronise,
// and returns cudaGetLastError() so a refused launch is reported.
// `rows` may be null (row j of `sky` for output row j).
extern "C" int arepas_runtimes_launch(const void* sky, const void* lens,
                                      const void* rows, const void* allocs,
                                      void* out, int J, int smax, int K,
                                      void* stream) {
  if (J > 0 && K > 0) {
    arepas_runtimes_kernel<<<J, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)sky, (const int*)lens, (const long long*)rows,
        (const int*)allocs, (int*)out, smax, K);
  }
  return (int)cudaGetLastError();
}
