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
// K2, epoch_step_kernel: one block per shard walks its L lease slots and
// Q queue positions in three passes.
//   1. expiry: clear the leases that ended by `now`, block-reduce the freed
//      tokens, the expired count and the open slots after expiry;
//   2. admission: a block-wide int64 inclusive scan of the queue's tokens,
//      carried across tiles; position i is admitted iff its prefix sum fits
//      free + freed, it holds tokens and i < open slots; block-reduce the
//      admitted count and tokens;
//   3. scatter: a scan of the free-slot flags in slot order gives each free
//      slot its rank; the slot of rank r < n_admit takes queue position r.
// What bounds it: not bytes. At the replay's shapes (K = 4, L = 8,192,
// Q = 4,096) one launch moves about 1.4 MB (tables read and written, queue
// head read, slot_of written), 0.4 us at 3.35 TB/s; the kernel is bound by
// its launch and by one block per shard walking its rows serially (4 of
// 132 SMs busy). That is the simple design this port starts from.
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

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "arepas_run.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

// ------------------------------------------------------------------ K2 ---
constexpr int kEpochThreads = 1024;
constexpr int kEpochWarps = kEpochThreads / 32;

// Sum of v over the block; every thread gets it. `s` holds kEpochWarps + 1.
__device__ long long block_sum(long long v, long long* s) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  if (lane == 0) s[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kEpochWarps ? s[lane] : 0;
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(kFull, v, off);
    if (lane == 0) s[kEpochWarps] = v;
  }
  __syncthreads();
  const long long r = s[kEpochWarps];
  __syncthreads();
  return r;
}

// Inclusive scan of v over the block in thread order; `total` gets the
// block's sum. `s` holds kEpochWarps + 1.
__device__ long long block_scan(long long v, long long* s, long long& total) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int off = 1; off < 32; off <<= 1) {
    const long long o = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += o;
  }
  if (lane == 31) s[warp] = v;
  __syncthreads();
  if (warp == 0) {
    long long w = lane < kEpochWarps ? s[lane] : 0;
    for (int off = 1; off < 32; off <<= 1) {
      const long long o = __shfl_up_sync(kFull, w, off);
      if (lane >= off) w += o;
    }
    if (lane < kEpochWarps) s[lane] = w;
  }
  __syncthreads();
  const long long r = v + (warp > 0 ? s[warp - 1] : 0);
  total = s[kEpochWarps - 1];
  __syncthreads();
  return r;
}

__global__ void __launch_bounds__(kEpochThreads)
epoch_step_kernel(const double* __restrict__ end_s,
                  const long long* __restrict__ tokens,
                  const long long* __restrict__ free_tok,
                  const long long* __restrict__ q_tok,
                  const double* __restrict__ q_end, double now,
                  double* __restrict__ new_end, long long* __restrict__ new_tok,
                  int* __restrict__ slot_of, long long* __restrict__ n_admit,
                  long long* __restrict__ adm_tok, long long* __restrict__ freed,
                  long long* __restrict__ n_expired, int L, int Q) {
  __shared__ long long s[kEpochWarps + 1];
  const int k = blockIdx.x;
  const long long rowL = (long long)k * L, rowQ = (long long)k * Q;

  // 1. expiry
  long long fr = 0, ne = 0, open = 0;
  for (int i = threadIdx.x; i < L; i += kEpochThreads) {
    long long t = tokens[rowL + i];
    double e = end_s[rowL + i];
    if (t > 0 && e <= now) {
      fr += t;
      ne += 1;
      t = 0;
      e = INFINITY;
    }
    open += (t == 0);
    new_tok[rowL + i] = t;
    new_end[rowL + i] = e;
  }
  fr = block_sum(fr, s);
  ne = block_sum(ne, s);
  open = block_sum(open, s);

  // 2. admission: prefix sums against free + freed, capped by open slots
  const long long free_after = free_tok[k] + fr;
  long long carry = 0, na = 0, at = 0;
  for (int i0 = 0; i0 < Q; i0 += kEpochThreads) {
    const int i = i0 + threadIdx.x;
    const long long v = i < Q ? q_tok[rowQ + i] : 0;
    long long total;
    const long long cs = carry + block_scan(v, s, total);
    if (i < Q && cs <= free_after && v > 0 && i < open) {
      na += 1;
      at += v;
    }
    carry += total;
    if (i < Q) slot_of[rowQ + i] = -1;
  }
  na = block_sum(na, s);
  at = block_sum(at, s);

  // 3. scatter: the free slot of rank r < n_admit takes queue position r
  long long rank0 = 0;
  for (int i0 = 0; i0 < L && rank0 < na; i0 += kEpochThreads) {
    const int i = i0 + threadIdx.x;
    const long long f = (i < L && new_tok[rowL + i] == 0) ? 1 : 0;
    long long total;
    const long long rank = rank0 + block_scan(f, s, total) - 1;
    if (f && rank < na) {
      new_tok[rowL + i] = q_tok[rowQ + rank];
      new_end[rowL + i] = q_end[rowQ + rank];
      slot_of[rowQ + rank] = i;
    }
    rank0 += total;
  }

  if (threadIdx.x == 0) {
    n_admit[k] = na;
    adm_tok[k] = at;
    freed[k] = fr;
    n_expired[k] = ne;
  }
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
extern "C" int epoch_step_launch(const void* end_s, const void* tokens,
                                 const void* free_tok, const void* q_tok,
                                 const void* q_end, double now, void* new_end,
                                 void* new_tok, void* slot_of, void* n_admit,
                                 void* adm_tok, void* freed, void* n_expired,
                                 int K, int L, int Q, void* stream) {
  if (K > 0) {
    epoch_step_kernel<<<K, kEpochThreads, 0, (cudaStream_t)stream>>>(
        (const double*)end_s, (const long long*)tokens,
        (const long long*)free_tok, (const long long*)q_tok,
        (const double*)q_end, now, (double*)new_end, (long long*)new_tok,
        (int*)slot_of, (long long*)n_admit, (long long*)adm_tok,
        (long long*)freed, (long long*)n_expired, L, Q);
  }
  return (int)cudaGetLastError();
}

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
