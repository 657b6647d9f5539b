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
// Run algebra. Writing an over-cap second as nt + x (x >= 1), a run of L
// seconds with excess X stretches to floor((L * nt + X) / nt) = L +
// floor(X / nt) seconds, so runtime = valid_len + sum over runs of
// floor(X_run / nt). A Run summarises a stretch of seconds: the excess of
// its leading and trailing over-cap runs (0 when it starts / ends under the
// cap), the floor sum of the runs closed inside it, and whether it is one
// over-cap run throughout. The empty stretch {0, 0, 0, full} is the
// identity; combining is associative, so any split of the prefix gives the
// same answer.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPerLane = 32;                  // consecutive seconds per lane
constexpr int kTile = 32 * kPerLane;          // seconds per tile
constexpr int kShared = kTile + kTile / 32;   // one pad word per 32

struct Run {
  long long head;  // excess of the leading over-cap run (0: starts under)
  long long tail;  // excess of the trailing over-cap run (0: ends under)
  int acc;         // sum of floor(excess / nt) over runs closed inside
  int full;        // 1: one over-cap run throughout, or empty
};

__device__ __forceinline__ int floor_div(long long x, int nt) {
  // x >= 0, nt >= 1; 32-bit division when it fits
  if (x <= 0x7fffffffLL) return (int)((unsigned)x / (unsigned)nt);
  return (int)(x / nt);
}

__device__ __forceinline__ Run combine(const Run& a, const Run& b, int nt) {
  Run r;
  if (a.full && b.full) {
    r.head = r.tail = a.head + b.head;
    r.acc = 0;
    r.full = 1;
  } else if (a.full) {
    r.head = a.head + b.head;
    r.tail = b.tail;
    r.acc = b.acc;
    r.full = 0;
  } else if (b.full) {
    r.head = a.head;
    r.tail = a.tail + b.head;
    r.acc = a.acc;
    r.full = 0;
  } else {
    // a's trailing run and b's leading run meet and close inside
    const long long mid = a.tail + b.head;
    r.head = a.head;
    r.tail = b.tail;
    r.acc = a.acc + b.acc + (mid > 0 ? floor_div(mid, nt) : 0);
    r.full = 0;
  }
  return r;
}

__device__ __forceinline__ Run shfl_down(const Run& r, int off) {
  Run o;
  o.head = __shfl_down_sync(0xffffffffu, r.head, off);
  o.tail = __shfl_down_sync(0xffffffffu, r.tail, off);
  o.acc = __shfl_down_sync(0xffffffffu, r.acc, off);
  o.full = __shfl_down_sync(0xffffffffu, r.full, off);
  return o;
}

__global__ void __launch_bounds__(kThreads)
arepas_runtimes_kernel(const int* __restrict__ sky,
                       const int* __restrict__ lens,
                       const int* __restrict__ allocs,
                       int* __restrict__ out, int smax, int K) {
  __shared__ int tile[kShared];
  const int j = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int* row = sky + (long long)j * smax;
  const int vlen = min(max(lens[j], 0), smax);

  for (int k0 = 0; k0 < K; k0 += kWarps) {
    const int k = k0 + warp;
    const int a = k < K ? allocs[(long long)j * K + k] : 1;
    const int nt = a >= 1 ? a : 1;
    Run carry = {0, 0, 0, 1};

    for (int t0 = 0; t0 < vlen; t0 += kTile) {
      const int n = min(kTile, vlen - t0);
      __syncthreads();  // the previous tile is no longer read
      for (int e = threadIdx.x; e < n; e += kThreads)
        tile[e + e / 32] = row[t0 + e];
      __syncthreads();

      // this lane's 32 consecutive seconds, folded left to right
      Run r = {0, 0, 0, 1};
      const int base = lane * kPerLane;
      const int stop = min(kPerLane, n - base);
      for (int i = 0; i < stop; ++i) {
        const int s = tile[lane * (kPerLane + 1) + i];
        if (s > nt) {
          const long long x = (long long)(s - nt);
          if (r.full) {
            r.head += x;
            r.tail = r.head;
          } else {
            r.tail += x;
          }
        } else if (r.full) {
          r.full = 0;
          r.tail = 0;
        } else if (r.tail > 0) {
          r.acc += floor_div(r.tail, nt);
          r.tail = 0;
        }
      }
      // ordered warp reduction: lane i holds lanes [i, i + 2 * off)
      for (int off = 1; off < 32; off <<= 1) {
        const Run o = shfl_down(r, off);
        if ((lane & (2 * off - 1)) == 0) r = combine(r, o, nt);
      }
      if (lane == 0) carry = combine(carry, r, nt);
    }

    if (lane == 0 && k < K) {
      int rt = vlen + carry.acc + floor_div(carry.head, nt);
      if (!carry.full) rt += floor_div(carry.tail, nt);
      out[(long long)j * K + k] = a >= 1 ? rt : -1;
    }
  }
}

}  // namespace

// Plain C interface for ctypes. Launches on `stream`, does not synchronise,
// and returns cudaGetLastError() so a refused launch is reported.
extern "C" int arepas_runtimes_launch(const void* sky, const void* lens,
                                      const void* allocs, void* out, int J,
                                      int smax, int K, void* stream) {
  if (J > 0 && K > 0) {
    arepas_runtimes_kernel<<<J, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)sky, (const int*)lens, (const int*)allocs, (int*)out,
        smax, K);
  }
  return (int)cudaGetLastError();
}
