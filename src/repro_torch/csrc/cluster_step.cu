// Kernels K2 (fused epoch step) and K3 (fused elastic resize) of the
// cluster simulator, written by hand for Hopper (sm_90a).
//
// They replace the Pallas TPU kernels of src/repro/kernels/cluster_step.py:
// epoch_step_pallas (_epoch_kernel) and resize_step_pallas (_resize_kernel).
// The contract is not the f32 Pallas bodies but the float64 jnp twins the
// simulator really runs (epoch_step_ref, resize_step_ref): Mosaic has no
// f64, the H100 has. Their plain PyTorch versions are
// repro_torch/kernels/cluster_step.py::epoch_step_ref / resize_step_ref.
// The TPU kernels' one-hot matmuls (TPUs avoid scatters), their +1e-6 floor
// nudge, f32 bisection midpoint and block-divisibility asserts are TPU
// workarounds with no counterpart here: both kernels compute in int64 and
// float64 and are bitwise-equal to their plain versions.
//
// K2, epoch_step_kernel: one thread-block cluster of C = K2_CLUSTER_CTAS
// CTAs per shard (cudaLaunchKernelEx with a cluster dimension; 8 unless
// built with -DK2_CLUSTER_CTAS=C, and 16 needs
// cudaFuncAttributeNonPortableClusterSizeAllowed), 256 threads a CTA.
// CTA c of shard k owns
// lease slots [c L / C, (c + 1) L / C) and queue positions [c Q / C,
// (c + 1) Q / C) (integer division: the ranges tile L and Q whatever C).
//   1. load once: each thread holds kItems (2, 4, 8 or 16, the fewest that
//      cover the CTA's ranges) consecutive slots (tokens, end) and queue
//      tokens in registers, the lease ends of its queue positions
//      prefetched into L2 for the scatter, clears the leases that ended by
//      `now`, and the CTA scans (open slots, queue tokens) and sums (freed
//      tokens, expired leases) in one block-wide pass;
//   2. exchange 1: the CTA publishes its four partials in shared memory;
//      after one cluster barrier, warp 0 of every CTA reads all C of them
//      through distributed shared memory and knows free + freed, the
//      shard's open slots, its exclusive slot-rank offset (after expiry the
//      free slots are exactly the open ones) and its exclusive queue-token
//      offset, with no further barrier;
//   3. admission: position i is admitted iff its prefix sum (the CTA's
//      offset + the scan of step 1 + the thread's own items) fits
//      free + freed, it holds tokens and i < the shard's open slots; the
//      CTA sums its admitted count and tokens;
//   4. exchange 2: the same for (admitted, admitted tokens); the CTA then
//      arrives on the cluster barrier (it reads no peer memory after this);
//   5. scatter: the free slot of shard rank r < n_admit takes queue
//      position r (q_tok, q_end read from L2) and records it in
//      slot_of; every slot is written once, from registers; queue positions
//      >= n_admit get slot -1 from their owner; CTA 0 writes the shard's
//      (K,) totals, and every CTA waits on the barrier before it exits, so
//      no CTA's shared memory goes while a peer may still read it.
// int64 sums and float64 compares only, as the plain version: bitwise
// equal to it. A CTA's range wider than its 256 threads hold (16 each:
// L or Q beyond 4,096 C) is walked in chunks, reloaded after the
// exchanges.
// What bounds it: not bytes. At the replay's shapes (K = 4, L = 8,192,
// Q = 4,096) one launch moves about 1.4 MB (0.4 us at 3.35 TB/s); the
// kernel is a chain of latencies: one load of the tables, two cluster
// barriers with a shared-memory exchange each, the queue read of the
// scatter and the stores, so the shard's work is spread over C SMs and
// the barriers are few. C = 1 is one CTA a shard with the same two
// exchanges (its 8,192 slots exceed what 256 threads hold, so it walks two
// chunks); tools/probe_kernels.py builds C = 1 to 16 and PERF.md has
// their times.
//
// K3, resize_step_kernel: one block per candidate.
//   1. the priced allocation decision, by thread 0, in float64 in the
//      order choose_tokens_priced_torch computes it: gain cut-off rounded
//      half to even (rint), a 48-step int64 bisection on b * pow(mid, a),
//      min(cap), max(deadline floor). Every product, sum and quotient is an
//      explicit _rn intrinsic, so nvcc cannot contract them into FMAs that
//      the element-wise PyTorch version does not do;
//   2. the AREPAS runtime at max(tgt, 1): the block walks the candidate's
//      valid skyline prefix in 8,192-second tiles staged in shared memory;
//      each lane folds 32 seconds with K1's run algebra (arepas_run.cuh),
//      warps combine lanes in order, thread 0 combines warps in order;
//   3. rt = max(rt, 1); sel = tgt < cand_tok && cand_end - now > epoch_s;
//      new_end = now + max(rint(rt * (1 - done)), 1).
// What bounds it: the skyline bytes of the valid prefixes (each read
// once), as for K1; the decision is 49 double pow calls per candidate.
// `rows` indexes a resident (U, Smax) skyline pool.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "arepas_run.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

// ------------------------------------------------------------------ K2 ---
namespace cg = cooperative_groups;

constexpr int kEpochThreads = 256;
constexpr int kEpochMaxWarps = kEpochThreads / 32;

// CTAs in a shard's cluster: on the H100, 16 ran K2 alone a tenth faster
// than 8 but slowed the fused cluster path end to end, where 8 ties one
// CTA a shard (PERF.md). A card refuses a size beyond its limit at launch.
#ifndef K2_CLUSTER_CTAS
#define K2_CLUSTER_CTAS 8
#endif
constexpr int kClusterCtas = K2_CLUSTER_CTAS;
static_assert(kClusterCtas >= 1, "a cluster holds at least one CTA");

// Exclusive scan of NV int64 values over the block in thread order
// (blockDim.x a multiple of 32): x[v] becomes the sum over the threads
// before this one, total[v] the block's sum. `s` holds kEpochMaxWarps * NV
// and is still read on return: the next scan takes another buffer, or
// follows a barrier.
template <int NV>
__device__ __forceinline__ void block_exclusive_scan(long long (&x)[NV],
                                                     long long (&total)[NV],
                                                     long long* s) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nw = blockDim.x / 32;
  long long inc[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) inc[v] = x[v];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const long long o = __shfl_up_sync(kFull, inc[v], off);
      if (lane >= off) inc[v] += o;
    }
  }
  if (lane == 31) {
#pragma unroll
    for (int v = 0; v < NV; ++v) s[warp * NV + v] = inc[v];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      long long w = lane < nw ? s[lane * NV + v] : 0;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const long long o = __shfl_up_sync(kFull, w, off);
        if (lane >= off) w += o;
      }
      if (lane < nw) s[lane * NV + v] = w;
    }
  }
  __syncthreads();
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    x[v] = (warp > 0 ? s[(warp - 1) * NV + v] : 0) + inc[v] - x[v];
    total[v] = s[(nw - 1) * NV + v];
  }
}

// Warp 0: the sums of NV partials over the cluster's C CTAs, and their sum
// over the CTAs ranked before this one.
template <int NV>
__device__ __forceinline__ void cluster_partials(cg::cluster_group& cluster,
                                                 long long* part, int C, int c,
                                                 long long (&tot)[NV],
                                                 long long (&before)[NV]) {
  const int lane = threadIdx.x % 32;
  long long p[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) p[v] = 0;
  if (lane < C) {
    const long long* peer = cluster.map_shared_rank(part, lane);
#pragma unroll
    for (int v = 0; v < NV; ++v) p[v] = peer[v];
  }
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    long long inc = p[v];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const long long o = __shfl_up_sync(kFull, inc, off);
      if (lane >= off) inc += o;
    }
    tot[v] = __shfl_sync(kFull, inc, 31);
    before[v] = __shfl_sync(kFull, inc - p[v], c);
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Chunk ch of this CTA's slots [ls, le) into registers, leases that ended
// by `now` cleared (their tokens and count added to fr, ne when `count`);
// returns the chunk's free slots.
template <int kItems>
__device__ __forceinline__ long long load_slots(
    const long long* __restrict__ tokens, const double* __restrict__ end_s,
    long long rowL, int ls, int le, int at, double now, bool count,
    long long (&tok)[kItems], double (&end)[kItems], long long& fr,
    long long& ne) {
  long long open = 0;
#pragma unroll
  for (int e = 0; e < kItems; ++e) {
    const int i = at + e;
    long long t = 0;
    double en = INFINITY;
    if (i < le) {
      t = tokens[rowL + i];
      en = end_s[rowL + i];
      if (t > 0 && en <= now) {
        if (count) {
          fr += t;
          ne += 1;
        }
        t = 0;
        en = INFINITY;
      }
      open += (t == 0);
    }
    tok[e] = t;
    end[e] = en;
  }
  return open;
}

// Chunk ch of this CTA's queue tokens [qs, qe) into registers (their lease
// ends prefetched into L2 for the scatter); returns the chunk's sum.
template <int kItems>
__device__ __forceinline__ long long load_queue(
    const long long* __restrict__ q_tok, const double* __restrict__ q_end,
    long long rowQ, int qe, int at, long long (&vq)[kItems]) {
  long long sum = 0;
#pragma unroll
  for (int e = 0; e < kItems; ++e) {
    const int i = at + e;
    vq[e] = i < qe ? q_tok[rowQ + i] : 0;
    sum += vq[e];
  }
  if (at < qe)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(q_end + rowQ + at));
  return sum;
}

template <int kItems>
__global__ void __launch_bounds__(kEpochThreads, 1)
epoch_step_kernel(const double* __restrict__ end_s,
                  const long long* __restrict__ tokens,
                  const long long* __restrict__ free_tok,
                  const long long* __restrict__ q_tok,
                  const double* __restrict__ q_end, double now,
                  double* __restrict__ new_end, long long* __restrict__ new_tok,
                  int* __restrict__ slot_of, long long* __restrict__ n_admit,
                  long long* __restrict__ adm_tok, long long* __restrict__ freed,
                  long long* __restrict__ n_expired, int L, int Q) {
  __shared__ long long scan1[kEpochMaxWarps * 4];
  __shared__ long long scan2[kEpochMaxWarps * 2];
  __shared__ long long scan3[kEpochMaxWarps];
  __shared__ long long part1[4];   // published: open, queue tokens, freed, expired
  __shared__ long long part2[2];   // published: admitted, admitted tokens
  __shared__ long long shard[8];   // the shard's totals and this CTA's offsets
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int c = (int)cluster.block_rank();
  const int k = blockIdx.x / C;
  const long long rowL = (long long)k * L, rowQ = (long long)k * Q;
  const int ls = (int)((long long)c * L / C), le = (int)((long long)(c + 1) * L / C);
  const int qs = (int)((long long)c * Q / C), qe = (int)((long long)(c + 1) * Q / C);
  const int span = blockDim.x * kItems;           // positions a chunk holds
  const int nchL = (le - ls + span - 1) / span;
  const int nchQ = (qe - qs + span - 1) / span;
  const int me = threadIdx.x * kItems;
  const long long free0 = threadIdx.x == 0 ? free_tok[k] : 0;

  long long tok[kItems], vq[kItems];
  double end[kItems];
  long long fr = 0, ne = 0;

  // 1. load once, expire; scan (open, queue tokens), sum (freed, expired)
  long long open = 0, qsum = 0;
  for (int ch = 0; ch < nchL; ++ch)
    open += load_slots<kItems>(tokens, end_s, rowL, ls, le, ls + ch * span + me,
                               now, true, tok, end, fr, ne);
  for (int ch = 0; ch < nchQ; ++ch)
    qsum += load_queue<kItems>(q_tok, q_end, rowQ, qe, qs + ch * span + me, vq);
  long long x1[4] = {open, qsum, fr, ne}, t1[4];
  block_exclusive_scan<4>(x1, t1, scan1);
  if (threadIdx.x < 4) part1[threadIdx.x] = t1[threadIdx.x];
  cluster.sync();

  // 2. exchange 1
  if (threadIdx.x < 32) {
    long long tot[4], before[4];
    cluster_partials<4>(cluster, part1, C, c, tot, before);
    if (threadIdx.x == 0) {
      shard[0] = free0 + tot[2];         // free after expiry
      shard[1] = tot[0];                 // open slots
      shard[2] = before[0];              // this CTA's first free-slot rank
      shard[3] = before[1];              // queue tokens before this CTA
      shard[6] = tot[2];
      shard[7] = tot[3];
    }
  }
  __syncthreads();
  const long long free_after = shard[0], open_all = shard[1];

  // 3. admission
  long long na = 0, at = 0, cs0 = shard[3];
  for (int ch = 0; ch < nchQ; ++ch) {
    const int base = qs + ch * span + me;
    long long mine[1] = {x1[1]}, chunk[1] = {t1[1]};
    if (nchQ > 1) {
      mine[0] = load_queue<kItems>(q_tok, q_end, rowQ, qe, base, vq);
      block_exclusive_scan<1>(mine, chunk, scan3);
      __syncthreads();
    }
    long long cs = cs0 + mine[0];
#pragma unroll
    for (int e = 0; e < kItems; ++e) {
      const int i = base + e;
      cs += vq[e];
      if (i < qe && cs <= free_after && vq[e] > 0 && i < open_all) {
        na += 1;
        at += vq[e];
      }
    }
    cs0 += chunk[0];
  }
  long long x2[2] = {na, at}, t2[2];
  block_exclusive_scan<2>(x2, t2, scan2);
  if (threadIdx.x < 2) part2[threadIdx.x] = t2[threadIdx.x];
  cluster.sync();

  // 4. exchange 2
  if (threadIdx.x < 32) {
    long long tot[2], before[2];
    cluster_partials<2>(cluster, part2, C, c, tot, before);
    if (threadIdx.x == 0) {
      shard[4] = tot[0];
      shard[5] = tot[1];
    }
  }
  __syncthreads();
  cluster_arrive();                  // no peer memory is read after this
  const long long n_adm = shard[4];

  // 5. scatter: the free slot of rank r < n_admit takes queue position r
  long long r0 = shard[2];
  for (int ch = 0; ch < nchL; ++ch) {
    const int base = ls + ch * span + me;
    long long mine[1] = {x1[0]}, chunk[1] = {t1[0]};
    if (nchL > 1) {
      mine[0] = load_slots<kItems>(tokens, end_s, rowL, ls, le, base, now,
                                   false, tok, end, fr, ne);
      block_exclusive_scan<1>(mine, chunk, scan3);
      __syncthreads();
    }
    long long rank = r0 + mine[0];
#pragma unroll
    for (int e = 0; e < kItems; ++e) {
      const int i = base + e;
      if (i < le) {
        if (tok[e] == 0) {
          if (rank < n_adm) {
            tok[e] = q_tok[rowQ + rank];
            end[e] = q_end[rowQ + rank];
            slot_of[rowQ + rank] = i;
          }
          ++rank;
        }
        new_tok[rowL + i] = tok[e];
        new_end[rowL + i] = end[e];
      }
    }
    r0 += chunk[0];
  }
  for (int i = qs + threadIdx.x; i < qe; i += blockDim.x)
    if (i >= n_adm) slot_of[rowQ + i] = -1;
  if (c == 0 && threadIdx.x == 0) {
    n_admit[k] = n_adm;
    adm_tok[k] = shard[5];
    freed[k] = shard[6];
    n_expired[k] = shard[7];
  }
  cluster_wait();
}

template <int kItems>
int launch_epoch(int C, int T, int K, int L, int Q, cudaStream_t stream,
                 const void* end_s, const void* tokens, const void* free_tok,
                 const void* q_tok, const void* q_end, double now,
                 void* new_end, void* new_tok, void* slot_of, void* n_admit,
                 void* adm_tok, void* freed, void* n_expired) {
  auto kernel = epoch_step_kernel<kItems>;
  if (C > 8) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(K * C));
  cfg.blockDim = dim3((unsigned)T);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, (const double*)end_s, (const long long*)tokens,
      (const long long*)free_tok, (const long long*)q_tok,
      (const double*)q_end, now, (double*)new_end, (long long*)new_tok,
      (int*)slot_of, (long long*)n_admit, (long long*)adm_tok,
      (long long*)freed, (long long*)n_expired, L, Q);
  if (e != cudaSuccess) {
    cudaGetLastError();              // clear it: the wrapper raises
    return (int)e;
  }
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ K3 ---
constexpr int kResizeWarps = 8;
constexpr int kResizeThreads = kResizeWarps * 32;
constexpr int kPerLane = 32;                           // seconds per lane
constexpr int kResizeTile = kResizeThreads * kPerLane; // seconds per tile
constexpr int kResizeShared = kResizeTile + kResizeTile / 32;
constexpr int kBisectIters = 48;

struct Policy {
  double gain;          // max(min_gain, 1e-9)
  double max_slowdown;
  long long min_tokens, max_tokens, cap;
};

__device__ __forceinline__ long long floor_half(long long x) {
  // floor(x / 2), as PyTorch's // on int64
  long long q = x / 2;
  if ((x % 2 != 0) && (x < 0)) q -= 1;
  return q;
}

// choose_tokens_priced_torch for one candidate, then min(cap), max(floor).
__device__ long long priced_decision(double a, double b, double price,
                                     long long hi, long long flo,
                                     const Policy& p) {
  const long long lo0 = p.min_tokens;
  const double eff_gain = __dmul_rn(p.gain, price);
  const double a_star = __ddiv_rn(fabs(a), eff_gain);
  double tg = rint(a_star);                 // half to even, as torch.round
  tg = fmin(fmax(tg, (double)lo0), (double)hi);
  long long t_gain = (long long)tg;
  if (a >= 0) t_gain = lo0;
  long long tok = t_gain;
  if (p.max_slowdown > 0) {
    const double base = __dmul_rn(b, pow((double)hi, a));
    const double limit =
        __dmul_rn(__dadd_rn(1.0, __dmul_rn(p.max_slowdown, price)), base);
    long long lo = lo0, hs = hi;
    for (int it = 0; it < kBisectIters; ++it) {
      const bool cond = lo < hs;
      const long long mid = floor_half(lo + hs);
      const bool ok = __dmul_rn(b, pow((double)mid, a)) <= limit;
      if (cond && !ok) lo = mid + 1;
      if (cond && ok) hs = mid;
    }
    tok = max(min(t_gain, p.max_tokens), lo);
  }
  return max(min(tok, p.cap), flo);
}

__global__ void __launch_bounds__(kResizeThreads)
resize_step_kernel(const double* __restrict__ a, const double* __restrict__ b,
                   const double* __restrict__ price,
                   const long long* __restrict__ obs,
                   const long long* __restrict__ floor_tok,
                   const double* __restrict__ done,
                   const long long* __restrict__ cand_tok,
                   const double* __restrict__ cand_end,
                   const int* __restrict__ sky, const int* __restrict__ lens,
                   const long long* __restrict__ rows, double now,
                   double epoch_s, Policy pol, int smax,
                   long long* __restrict__ tgt_out,
                   unsigned char* __restrict__ sel_out,
                   long long* __restrict__ rt_out,
                   double* __restrict__ new_end_out) {
  __shared__ int tile[kResizeShared];
  __shared__ arepas::Run warp_runs[kResizeWarps];
  __shared__ long long tgt_s;
  const int c = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0)
    tgt_s = priced_decision(a[c], b[c], price[c], obs[c], floor_tok[c], pol);
  __syncthreads();
  const long long tgt = tgt_s;
  const int nt = (int)max(tgt, 1LL);

  const long long src = rows[c];
  const int* row = sky + src * smax;
  const int vlen = min(max(lens[src], 0), smax);
  arepas::Run carry = arepas::identity();
  for (int t0 = 0; t0 < vlen; t0 += kResizeTile) {
    const int n = min(kResizeTile, vlen - t0);
    __syncthreads();  // the previous tile and warp_runs are no longer read
    for (int e = threadIdx.x; e < n; e += kResizeThreads)
      tile[e + e / 32] = row[t0 + e];
    __syncthreads();
    arepas::Run r = arepas::identity();
    const int base = threadIdx.x * kPerLane;
    const int stop = min(kPerLane, n - base);
    for (int i = 0; i < stop; ++i)
      arepas::push(r, tile[threadIdx.x * (kPerLane + 1) + i], nt);
    r = arepas::warp_combine(r, lane, nt);
    if (lane == 0) warp_runs[warp] = r;
    __syncthreads();
    if (threadIdx.x == 0)
      for (int w = 0; w < kResizeWarps; ++w)
        carry = arepas::combine(carry, warp_runs[w], nt);
  }

  if (threadIdx.x == 0) {
    const long long rt = max((long long)arepas::runtime(carry, vlen, nt), 1LL);
    const double remaining =
        fmax(rint(__dmul_rn((double)rt, __dsub_rn(1.0, done[c]))), 1.0);
    tgt_out[c] = tgt;
    sel_out[c] = (tgt < cand_tok[c]) && (__dsub_rn(cand_end[c], now) > epoch_s);
    rt_out[c] = rt;
    new_end_out[c] = __dadd_rn(now, remaining);
  }
}

}  // namespace

// Plain C interfaces for ctypes. Each launches on `stream`, does not
// synchronise, and returns cudaGetLastError() so a refused launch is
// reported.
// K2 on K clusters of kClusterCtas CTAs (a size the card refuses is
// reported), 256 threads a CTA, each holding the smallest of 2, 4, 8 or 16 positions that covers
// the CTA's ranges (wider ranges are walked in chunks of 4,096).
extern "C" int epoch_step_launch(const void* end_s, const void* tokens,
                                 const void* free_tok, const void* q_tok,
                                 const void* q_end, double now, void* new_end,
                                 void* new_tok, void* slot_of, void* n_admit,
                                 void* adm_tok, void* freed, void* n_expired,
                                 int K, int L, int Q, void* stream) {
  constexpr int cluster = kClusterCtas;
  if (K <= 0) return (int)cudaGetLastError();
  if ((long long)K * cluster > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const long long n = (((long long)(L > Q ? L : Q)) + cluster - 1) / cluster;
  const long long per = (n + kEpochThreads - 1) / kEpochThreads;
  cudaStream_t st = (cudaStream_t)stream;
#define K2_LAUNCH(I)                                                        \
  return launch_epoch<I>(cluster, kEpochThreads, K, L, Q, st, end_s,       \
                         tokens, free_tok, q_tok, q_end, now, new_end,      \
                         new_tok, slot_of, n_admit, adm_tok, freed,         \
                         n_expired)
  if (per <= 2) K2_LAUNCH(2);
  if (per <= 4) K2_LAUNCH(4);
  if (per <= 8) K2_LAUNCH(8);
  K2_LAUNCH(16);
#undef K2_LAUNCH
}

// The CTAs of a shard's cluster this library was built with.
extern "C" int epoch_step_cluster_ctas() { return kClusterCtas; }

// Candidate c reads skyline row rows[c] of the (U, smax) pool.
extern "C" int resize_step_launch(
    const void* a, const void* b, const void* price, const void* obs,
    const void* floor_tok, const void* done, const void* cand_tok,
    const void* cand_end, const void* sky, const void* lens, const void* rows,
    double now, double epoch_s, double gain, double max_slowdown,
    long long min_tokens, long long max_tokens, long long cap, int C,
    int smax, void* tgt, void* sel, void* rt, void* new_end, void* stream) {
  if (C > 0) {
    const Policy pol{gain, max_slowdown, min_tokens, max_tokens, cap};
    resize_step_kernel<<<C, kResizeThreads, 0, (cudaStream_t)stream>>>(
        (const double*)a, (const double*)b, (const double*)price,
        (const long long*)obs, (const long long*)floor_tok,
        (const double*)done, (const long long*)cand_tok,
        (const double*)cand_end, (const int*)sky, (const int*)lens,
        (const long long*)rows, now, epoch_s, pol, smax, (long long*)tgt,
        (unsigned char*)sel, (long long*)rt, (double*)new_end);
  }
  return (int)cudaGetLastError();
}
