// Kernel K1: bulk AREPAS runtimes (paper Algorithm 1), written by hand for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/skyline.py::
// skyline_runtimes (_skyline_kernel). Same contract:
//   J skylines x (J, K) int32 allocations -> (J, K) int32 simulated
//   runtimes, runtime = seconds with s <= nt + sum over maximal runs of
//   s > nt of floor(run area / nt); an allocation below 1 yields -1.
// Its plain PyTorch version is repro_torch/core/arepas.py::
// simulate_runtime_batch. The skylines come in one of two layouts; the
// kernel needs only a start and a length per output row:
//   * ragged: flat int32 values and (J + 1) int64 offsets, row j the
//     seconds [offsets[j], offsets[j + 1]) -- the dataset's layout, which
//     copies the valid seconds and nothing else;
//   * pool: (U, Smax) int32 rows and (U,) valid lengths, output row j
//     reading pool row rows[j] (or row j without `rows`) -- the simulator's
//     resident layout.
//
// What bounds it. The bytes: every valid second read once (plus the
// allocations and the output) at the memory rate, 0.017 ms at the main
// path's 25,000 x 8. Short of that, the work: a compare and an add per
// second and allocation, a division per over-cap run; and the latency of
// each job's few dependent loads, which only many jobs in flight hide.
// Here:
//   * work items: a job's valid prefix is cut into segments of at most
//     kSegment seconds (K1_SEGMENT, 4,096 unless built with
//     -DK1_SEGMENT=n; at least one segment, empty jobs included); one warp
//     folds one segment for every allocation of its job;
//   * the item -> (job, segment) map is a prefix over the jobs' segment
//     counts, computed inside the launch: each block scans the jobs in
//     windows of up to kWindow into shared memory (every block the same
//     scan: J lengths, read from L2), then its warps take items i = gw,
//     gw + GW, ... of the window (gw = warp * gridDim.x + block, so
//     neighbouring items, a long job's segments among them, land on
//     different SMs) and find their job by binary search;
//   * the warp's segment of n seconds is cut into 32 contiguous lane spans
//     of ceil(n / 32) seconds (a short job keeps every lane busy); the
//     warp prefetches the segment into L2, then reads it in steps of 8
//     seconds a lane, coalesced (row e of its shared tile is lane e's next
//     8 seconds), the next step's loads in flight while it folds this one;
//   * skylines are step functions (usage changes in about 1.5 % of the
//     corpus's seconds), so a lane folds each run of equal seconds once,
//     for every distinct allocation of the pass at once (up to 8 a pass;
//     equal allocations, as the dataset grid's repeated fractions, are
//     folded once): a change mask a step, then one fold a change, in 32-bit
//     summaries with each allocation's divisor made once (arepas::Run32,
//     Divisor). Each second is read once however many allocations the job
//     has (up to 8), and the work follows the runs, not the seconds;
//   * the lanes are combined in order for every allocation at once, in 32
//     bits; an excess that does not fit (never in a real skyline: it takes
//     an over-cap run of millions of token-seconds) sends the pass to an
//     exact 64-bit fold and combine;
//   * a job of one segment writes its runtimes directly. A longer job's
//     segments write their K summaries to scratch; the last of them to
//     finish (a per-job arrival counter after __threadfence) combines the
//     summaries in segment order and resets the counter to 0 for the next
//     launch. The result is the same, bit for bit, in whatever order the
//     items ran.
// The TPU kernel's one-hot T x T matmul (TPUs avoid scatters), its
// Smax % time_block tiling constraint and its f32 floor(x / nt + 1e-6)
// nudge have no counterpart here: the division is exact integer division.
//
// The run algebra (struct Run, its fold, combine and warp reduction; the
// 32-bit summary and the divisor) lives in arepas_run.cuh, which kernel K3
// (cluster_step.cu) shares.

#include <cuda_runtime.h>
#include <stdint.h>

#include "arepas_run.cuh"

namespace {

constexpr int kWarps = 16;                    // 128 registers a thread; of
                                              // 12 to 24, the best (PERF.md)
constexpr int kThreads = kWarps * 32;
constexpr int kStep = 8;                      // seconds a lane takes at once
constexpr int kSlots = 8;                     // allocations a pass folds
// a warp's shared memory: its tile (32 rows of kStep seconds, one pad
// word) and the slots' allocations and divisors
constexpr int kTile = 32 * (kStep + 1);
constexpr int kWarpWords = kTile + 3 * kSlots;
constexpr int kWindow = 16384;                // jobs a block scans at once
// seconds of a job's valid prefix that one warp folds; a longer job is
// split into segments combined in order. 4,096 beat 1,024 and 2,048 and
// tied 8,192 on the H100 (PERF.md)
#ifndef K1_SEGMENT
#define K1_SEGMENT 4096
#endif
constexpr int kSegment = K1_SEGMENT;
static_assert(kSegment >= 32 && kSegment % 32 == 0,
              "a segment is whole lane spans of 32 seconds");
constexpr unsigned kFull = 0xffffffffu;

using arepas::Run;

struct Skylines {
  const int* values;         // ragged values or (U, smax) pool
  const long long* offsets;  // ragged: (J + 1,); null for the pool
  const int* lens;           // pool: (U,) valid lengths
  const long long* rows;     // pool: (J,) pool rows, or null (row j)
  int smax;

  // start and valid length of output row j
  __device__ __forceinline__ void row(int j, long long& start, int& len) const {
    if (offsets != nullptr) {
      start = offsets[j];
      const long long n = offsets[j + 1] - start;
      len = (int)min(max(n, 0LL), 0x7fffffffLL);
    } else {
      const long long src = rows != nullptr ? rows[j] : j;
      start = src * smax;
      len = min(max(lens[src], 0), smax);
    }
  }
};

// segments of a job of len seconds (at least one); `sdv` divides by seg
__device__ __forceinline__ int n_segments(int len, int seg,
                                          const arepas::Divisor& sdv) {
  return len <= seg ? 1 : (int)arepas::div32((unsigned)(len - 1), sdv) + 1;
}

// Fold a run of `count` seconds of usage s into every slot's summary. The
// allocations and divisors come from the warp's slot table: runs are few,
// so they are read where a run is folded and hold no registers between.
__device__ __forceinline__ void fold_run(arepas::Run32 (&c)[kSlots], int s,
                                         int count, int nd, const int* slot_nt,
                                         const unsigned* slot_dv, bool& wide) {
#pragma unroll
  for (int u = 0; u < kSlots; ++u)
    if (u < nd)
      arepas::push(c[u], s, count, slot_nt[u],
                   arepas::Divisor{slot_dv[2 * u], slot_dv[2 * u + 1]}, wide);
}

// Step t of the warp's lane spans: row e holds lane e's next kStep
// seconds; lanes 8r .. 8r + 7 take rows e = r mod 4. `fetch` loads this
// lane's share of the rows into registers (the loads stay in flight while
// the warp folds the previous step), `stage` writes them to the tile.
__device__ __forceinline__ void fetch(int (&x)[kStep], const int* src,
                                      int span, int n, int t, int lane) {
  const int off = t * kStep + lane % kStep;
#pragma unroll
  for (int r = 0; r < kStep; ++r) {
    const int e = lane / kStep + r * (32 / kStep);
    const int idx = e * span + off;
    x[r] = (off < span && idx < n) ? __ldg(src + idx) : 0;
  }
}

__device__ __forceinline__ void stage(int* tile, const int (&x)[kStep], int lane) {
#pragma unroll
  for (int r = 0; r < kStep; ++r) {
    const int e = lane / kStep + r * (32 / kStep);
    tile[e * (kStep + 1) + lane % kStep] = x[r];
  }
  __syncwarp();
}

__device__ __forceinline__ void load_step(int* tile, const int* src, int span,
                                          int n, int t, int lane) {
  int x[kStep];
  fetch(x, src, span, n, t, lane);
  stage(tile, x, lane);
}

// The pass again, one allocation at a time with the exact push(), for a
// segment in which some closing run's excess reached 2^32 (never in a
// real skyline: it takes an over-cap run of millions of token-seconds);
// returns this lane's summary of its allocation's slot, lanes in order.
__device__ __noinline__ Run exact_pass(int* tile, const int* src, int span,
                                       int n, int mine, int steps,
                                       const int* slot_nt, int nd, int slot,
                                       int lane) {
  Run res = arepas::identity();
  for (int q = 0; q < nd; ++q) {
    const int nt = slot_nt[q];
    Run c = arepas::identity();
    for (int t = 0; t < steps; ++t) {
      load_step(tile, src, span, n, t, lane);
      const int cnt = min(max(mine - t * kStep, 0), kStep);
      for (int i = 0; i < cnt; ++i)
        arepas::push(c, tile[lane * (kStep + 1) + i], nt);
      __syncwarp();
    }
    const Run r = arepas::shfl_idx(arepas::warp_combine(c, lane, nt), 0);
    if (slot == q) res = r;
  }
  return res;
}

// One work item: segment s of job j, folded for every allocation of j.
__device__ void run_item(const Skylines& sk, const int* __restrict__ allocs,
                         int* __restrict__ out, Run* __restrict__ scratch,
                         int* __restrict__ arrivals, int* wsm, int j, int s,
                         long long item, long long first_item, int K,
                         int seg, const arepas::Divisor& sdv, int lane) {
  int* tile = wsm;
  int* slot_nt = wsm + kTile;
  unsigned* slot_dv = (unsigned*)(slot_nt + kSlots);
  long long start;
  int len;
  sk.row(j, start, len);
  const int nseg = n_segments(len, seg, sdv);
  const int s0 = s * seg;
  const int n = max(min(seg, len - s0), 0);     // seconds of this segment
  const int* src = sk.values + start + s0;
  const int span = (n + 31) / 32;               // a lane's seconds
  const int mine = max(min(span, n - lane * span), 0);
  const int steps = (span + kStep - 1) / kStep;
  // the segment's lines into L2 at once: the steps' loads then wait for
  // L2, not for device memory one step after another
  for (int b = lane * 32; b < n; b += 32 * 32)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(src + b));

  for (int k0 = 0; k0 < K; k0 += kSlots) {
    const int kn = min(kSlots, K - k0);
    const bool have = lane < kn;
    const int a = have ? allocs[(long long)j * K + k0 + lane] : 0;
    int next[kStep];                            // step t + 1, in flight
    if (steps > 0) fetch(next, src, span, n, 0, lane);      // beside `a`
    // the distinct valid allocations of the pass, in order, one slot each
    int first = lane;
    for (int q = 0; q < kn; ++q) {
      const int aq = __shfl_sync(kFull, a, q);
      if (first == lane && q < lane && aq == a) first = q;
    }
    const unsigned distinct = __ballot_sync(kFull, have && a >= 1 && first == lane);
    const int nd = __popc(distinct);
    const int slot = __popc(distinct & ((1u << first) - 1));
    if (((distinct >> lane) & 1u) != 0) {
      const arepas::Divisor d = arepas::divisor(a);
      slot_nt[slot] = a;
      slot_dv[2 * slot] = d.magic;
      slot_dv[2 * slot + 1] = d.shifts;
    }
    __syncwarp();
    arepas::Run32 c[kSlots];
#pragma unroll
    for (int u = 0; u < kSlots; ++u) c[u] = arepas::identity32();

    // Skylines are step functions: the lane folds each run of equal
    // seconds once (a change mask a step, then one fold a change), so the
    // work follows the number of runs, not of seconds. Every lane folds
    // its step's cnt seconds: past the job's last second its row holds
    // zeros, under any cap, which close a trailing over-cap run into `acc`
    // instead of leaving it in `tail` -- the same runtime (a segment that
    // is not the job's last has 32 full spans).
    bool wide = false;
    int cur = 0x80000000;                       // no second has this usage
    int held = 0;                               // seconds of cur so far
    for (int t = 0; t < steps; ++t) {
      stage(tile, next, lane);
      if (t + 1 < steps) fetch(next, src, span, n, t + 1, lane);
      const int cnt = min(span - t * kStep, kStep);
      const int* row = tile + lane * (kStep + 1);
      unsigned chg = 0;
      int prev = cur;
#pragma unroll
      for (int i = 0; i < kStep; ++i) {
        const int v = row[i];
        if (i < cnt && v != prev) chg |= 1u << i;
        prev = v;
      }
      int last = 0;
      while (__any_sync(kFull, chg != 0)) {
        if (chg != 0) {
          const int i = __ffs(chg) - 1;
          chg &= chg - 1;
          const int count = held + i - last;
          if (count > 0) fold_run(c, cur, count, nd, slot_nt, slot_dv, wide);
          cur = row[i];
          held = 0;
          last = i;
        }
      }
      held += cnt - last;
      __syncwarp();                             // the tile is free again
    }
    if (held > 0) fold_run(c, cur, held, nd, slot_nt, slot_dv, wide);

    // the lanes in order, every distinct allocation at once (32-bit
    // summaries; lane 0 ends with all of them); each lane takes the
    // summary of its own allocation
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
      for (int q = 0; q < kSlots; ++q) {
        if (q < nd) {
          const arepas::Run32 o = arepas::shfl_down(c[q], off);
          if ((lane & (2 * off - 1)) == 0)
            c[q] = arepas::combine(c[q], o, arepas::Divisor{slot_dv[2 * q], slot_dv[2 * q + 1]},
                                   wide);
        }
      }
    }
    arepas::Run32 mine32 = arepas::identity32();
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      if (q < nd) {
        const arepas::Run32 r = arepas::shfl_idx(c[q], 0);
        if (slot == q) mine32 = r;
      }
    }
    Run res = arepas::widen(mine32);
    const bool exact = __any_sync(kFull, wide);
    if (exact) res = exact_pass(tile, src, span, n, mine, steps, slot_nt, nd, slot, lane);
    __syncwarp();                               // slot table reused next pass
    const long long o = (long long)j * K + k0 + lane;
    if (nseg == 1) {
      if (have && a >= 1)
        out[o] = exact ? arepas::runtime(res, len, a)
                       : arepas::runtime(mine32, len, arepas::Divisor{
                             slot_dv[2 * slot], slot_dv[2 * slot + 1]});
      else if (have) out[o] = -1;
    } else if (have) {
      scratch[item * K + k0 + lane] = res;
    }
  }
  if (nseg == 1) return;

  // the last segment of the job to finish combines them in segment order
  __threadfence();
  __syncwarp();
  int seen = 0;
  if (lane == 0) seen = atomicAdd(&arrivals[j], 1);
  seen = __shfl_sync(kFull, seen, 0);
  if (seen != nseg - 1) return;
  __threadfence();
  // lane q takes segment q of each run of 32 (their loads in flight at
  // once), warp_combine puts them in order, lane 0 carries the runs of 32
  for (int kk = 0; kk < K; ++kk) {
    const int a = allocs[(long long)j * K + kk];
    const int nt = max(a, 1);
    Run acc = arepas::identity();
    for (int q0 = 0; q0 < nseg; q0 += 32) {
      const Run part = q0 + lane < nseg
          ? arepas::load_cg(scratch + (first_item + q0 + lane) * K + kk)
          : arepas::identity();
      const Run r = arepas::warp_combine(part, lane, nt);
      if (lane == 0) acc = arepas::combine(acc, r, nt);
    }
    if (lane == 0) out[(long long)j * K + kk] = a >= 1 ? arepas::runtime(acc, len, nt) : -1;
  }
  if (lane == 0) arrivals[j] = 0;   // ready for the next launch
}

__global__ void __launch_bounds__(kThreads, 1)
arepas_runtimes_kernel(Skylines sk, const int* __restrict__ allocs,
                       int* __restrict__ out, Run* __restrict__ scratch,
                       int* __restrict__ arrivals, int J, int K,
                       long long max_items) {
  constexpr int seg = kSegment;
  extern __shared__ int smem[];
  const int win = min(J, kWindow);                // jobs scanned at once
  int* first = smem;                              // win: item prefix
  __shared__ int warp_items[kWarps];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  int* wsm = smem + win + warp * kWarpWords;
  const arepas::Divisor sdv = arepas::divisor(seg);
  const long long gw = (long long)warp * gridDim.x + blockIdx.x;
  const long long GW = (long long)kWarps * gridDim.x;

  long long base = 0;                             // items before the window
  for (int j0 = 0; j0 < J; j0 += win) {
    const int wn = min(win, J - j0);
    // this warp's share of the window: its jobs' segment counts (loads
    // independent of each other), then their exclusive prefix
    const int per = ((wn + kWarps - 1) / kWarps + 31) / 32 * 32;
    const int lo = min(warp * per, wn), hi = min(lo + per, wn);
#pragma unroll 8
    for (int jj = lo + lane; jj < hi; jj += 32) {
      long long st;
      int len;
      sk.row(j0 + jj, st, len);
      first[jj] = n_segments(len, seg, sdv);
    }
    __syncwarp();
    int run = 0;
    for (int b = lo; b < hi; b += 32) {
      const int jj = b + lane;
      const int cnt = jj < hi ? first[jj] : 0;
      int inc = cnt;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_up_sync(kFull, inc, off);
        if (lane >= off) inc += o;
      }
      if (jj < hi) first[jj] = run + inc - cnt;
      run += __shfl_sync(kFull, inc, 31);
    }
    if (lane == 0) warp_items[warp] = run;
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? warp_items[w] : 0;
      total += warp_items[w];
    }
    for (int jj = lo + lane; jj < hi; jj += 32) first[jj] += before;
    __syncthreads();

    // this warp's items of the window
    long long i = base + ((gw - base) % GW + GW) % GW;
    for (; i < base + total && i < max_items; i += GW) {
      const int li = (int)(i - base);
      int l = 0, h = wn - 1;                      // last jj with first <= li
      while (l < h) {
        const int mid = (l + h + 1) / 2;
        if (first[mid] <= li) l = mid; else h = mid - 1;
      }
      run_item(sk, allocs, out, scratch, arrivals, wsm, j0 + l,
               li - first[l], i, base + first[l], K, seg, sdv, lane);
    }
    base += total;
    __syncthreads();                              // the window is reused
  }
}

}  // namespace

// Plain C interface for ctypes. Launches on `stream`, does not synchronise,
// and returns cudaGetLastError() (or the error of the set-up that refused
// the launch), so a refused launch is reported.
//   ragged: `offsets` (J + 1) int64 into `values`; `lens`, `rows` unused;
//   pool:   `offsets` null; `values` (U, smax), `lens` (U,), `rows` (J,)
//           int64 or null.
// `scratch` holds max_items * K summaries (24 bytes each) and `arrivals`
// J int32 zeros, which the launch leaves zero; max_items bounds the
// segments of all jobs (the wrapper computes it from the shapes and
// arepas_segment()).
extern "C" int arepas_runtimes_launch(const void* values, const void* offsets,
                                      const void* lens, const void* rows,
                                      const void* allocs, void* out,
                                      void* scratch, void* arrivals, int J,
                                      int smax, int K, long long max_items,
                                      void* stream) {
  if (J <= 0 || K <= 0) return (int)cudaGetLastError();
  if (max_items < J) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // the window takes what a block's jobs need: the rest of the SM's 256 KB
  // stays L1 for the segments' lines
  const int smem = (min(J, kWindow) + kWarps * kWarpWords) * (int)sizeof(int);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(arepas_runtimes_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const long long want = (max_items + kWarps - 1) / kWarps;
  const int blocks = (int)(want < sms ? want : sms);
  const Skylines sk{(const int*)values, (const long long*)offsets,
                    (const int*)lens, (const long long*)rows, smax};
  arepas_runtimes_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      sk, (const int*)allocs, (int*)out, (Run*)scratch, (int*)arrivals, J, K,
      max_items);
  return (int)cudaGetLastError();
}

// The segment length (seconds) this library was built with.
extern "C" int arepas_segment() { return kSegment; }
