// Kernels K2 (fused epoch step) and K3 (fused elastic resize) of the
// cluster simulator, and K6 (the decide stages' allocation policy), written
// by hand for Hopper (sm_90a).
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
// K3, resize_step_kernel: a warp a candidate, K3_BLOCK_WARPS (4)
// candidates a block.
//   1. the skyline loads start first: each warp reads its candidate's pool
//      row and length, cuts the valid prefix into one contiguous span a
//      lane, loads the first step of every span into registers and
//      prefetches the rest into L2; none of it depends on the decision;
//   2. meanwhile the warp takes the priced allocation decision in float64
//      in the order choose_tokens_priced_torch computes it: gain cut-off
//      rounded half to even (rint), the int64 bisection on b * pow(mid, a),
//      min(cap), max(deadline floor). Every product, sum and quotient is an
//      explicit _rn intrinsic, so nvcc cannot contract them into FMAs that
//      the element-wise PyTorch version does not do. The bisection is
//      walked by the whole warp, five levels of its tree a round
//      (priced_decision says how): the serial loop's mids and branches, at
//      one pow latency a round;
//   3. the AREPAS runtime at max(tgt, 1) with K1's 32-bit run algebra
//      (arepas_run.cuh): the divisor made once, each lane folds its span a
//      step of K3_CHUNK (32) seconds at a time (read coalesced, staged
//      through a tile in shared memory, a run of equal seconds folded
//      once), and the lanes are combined in order by shuffles. A sum past
//      32 bits sends the candidate to the exact 64-bit fold in the same
//      launch. (Folding a long skyline with the whole block was slower on
//      the cluster path's batches, PERF.md);
//   4. rt = max(rt, 1); sel = tgt < cand_tok && cand_end - now > epoch_s;
//      new_end = now + max(rint(rt * (1 - done)), 1).
// The inputs come in one (9, C) buffer of 8-byte rows and the outputs
// leave in one packed buffer, so the caller copies once each way.
// What bounds it: the skyline bytes of the valid prefixes (each read
// once), as for K1; the operations (the bisection levels the inputs need,
// a pow each) are far below them. The time is latency: the launch, the
// dependent loads (row, length, seconds), the decision's rounds of pow
// (the serial loop's 49 dependent pows on one thread set it before: 80 %
// of the time at every record shape, PERF.md), the fold's steps and the
// combine.
// `rows` indexes a resident (U, Smax) skyline pool.
//
// K6, decide_policy_kernel: the float64 allocation policy of the serving
// layer's decide stages (serve/service.py), choose_tokens_priced_torch and
// the runtime b * tok^a, a warp a row and kBlockWarps rows a block. It
// replaces no TPU kernel: the reference's stages leave the policy to XLA
// (a fori_loop of 48 rounds under jit), and PyTorch runs the same rounds
// as ~13 element-wise kernels each, ~500 nodes in a decide's CUDA graph.
// Each warp takes K3's priced_decision, the same device function (a null
// price is 1.0, a null observed cap is max_tokens; cap and floor are
// neutral), and lane 0 writes the token and the runtime. What bounds it:
// the pows of the open bisection levels, 126 float64 operations each; the
// bytes are a few per row. The time is latency: the launch and at most 3
// rounds of pow for an interval under 2^13 tokens, then the runtime's pow.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
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
// A warp a candidate, kBlockWarps candidates a block: 4 was the fastest
// or tied at the three record shapes on the H100, as was a warp a
// candidate against two or four (PERF.md); tools/probe_kernels.py builds
// other sizes with -D.
#ifndef K3_BLOCK_WARPS
#define K3_BLOCK_WARPS 4
#endif
constexpr int kBlockWarps = K3_BLOCK_WARPS;
constexpr int kResizeThreads = kBlockWarps * 32;
// seconds a lane folds a step: a row of its warp's tile in shared memory,
// the next step's in flight in registers. 32 beat 8 and 16 at the record
// shapes on the H100, most where one warp folds a long skyline (PERF.md)
#ifndef K3_CHUNK
#define K3_CHUNK 32
#endif
constexpr int kChunk = K3_CHUNK;
static_assert(kChunk == 8 || kChunk == 16 || kChunk == 32,
              "a load instruction covers whole rows of the tile");
constexpr int kTileRow = kChunk + 1;   // padded: a lane's row, no conflicts
// K3_PROBE, for tools/probe_kernels.py alone: 1 decides and skips the
// fold, 2 folds at the observed tokens and skips the decision, 3 skips
// both (the loads of the inputs and the stores alone).
#ifndef K3_PROBE
#define K3_PROBE 0
#endif
constexpr bool kDecide = K3_PROBE == 0 || K3_PROBE == 1;
constexpr bool kFold = K3_PROBE == 0 || K3_PROBE == 2;
// The bisection: 48 levels at most, as the plain version; a round
// evaluates the kTreeLevels levels below the current node at once, one
// node a lane (31 of the warp's 32).
constexpr int kBisectIters = 48;
constexpr int kTreeLevels = 5;
static_assert((1 << kTreeLevels) - 1 < 32, "a round's nodes fit one warp");

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

// choose_tokens_priced_torch for one candidate, then min(cap), max(floor),
// by a whole warp (every lane returns the same value). The bisection is
// the plain version's, node for node: in a round, lane n - 1 takes node n
// (heap order, 1..31) of the next kTreeLevels levels below the current
// interval (lo, hs), derives that node's interval by integer arithmetic
// alone from the branch bits of n (1: the predicate held, hs = mid; 0:
// lo = mid + 1), and evaluates the predicate at its mid. In the first
// round lane 31 evaluates the base b * hi^a, which sets the limit the
// predicates are compared with. The warp then walks the true path through
// the ballot of the 31 predicates: its mids and branches are the serial
// loop's own, bit for bit, with no assumption that b * mid^a is monotone
// in mid. The walk stops where the interval closes (lo >= hs: the serial
// loop changes nothing after it) or at 48 levels (a wider interval ends
// where the serial loop ends). An interval of at most 2^13 tokens takes
// at most 3 rounds: 3 pow latencies, not 49.
__device__ __forceinline__ long long priced_decision(double a, double b,
                                                     double price,
                                                     long long hi,
                                                     long long flo,
                                                     const Policy& p,
                                                     int lane) {
  const long long lo0 = p.min_tokens;
  const double eff_gain = __dmul_rn(p.gain, price);
  const double a_star = __ddiv_rn(fabs(a), eff_gain);
  double tg = rint(a_star);                 // half to even, as torch.round
  tg = fmin(fmax(tg, (double)lo0), (double)hi);
  long long t_gain = (long long)tg;
  if (a >= 0) t_gain = lo0;
  long long tok = t_gain;
  if (p.max_slowdown > 0) {
    const int n = lane + 1;                 // this lane's node, heap order
    const int depth = 31 - __clz(n);
    long long lo = lo0, hs = hi;
    double limit = 0.0;
    int level = 0;
    for (bool first = true; lo < hs && level < kBisectIters; first = false) {
      long long l = lo, h = hs;
      for (int k = depth - 1; k >= 0; --k) {
        const long long m = floor_half(l + h);
        if ((n >> k) & 1) h = m; else l = m + 1;
      }
      const double x = (first && lane == 31) ? (double)hi
                                             : (double)floor_half(l + h);
      const double v = __dmul_rn(b, pow(x, a));
      if (first) {
        const double base = __shfl_sync(kFull, v, 31);
        limit = __dmul_rn(__dadd_rn(1.0, __dmul_rn(p.max_slowdown, price)),
                          base);
      }
      const unsigned ok = __ballot_sync(kFull, v <= limit);
      for (int k = 0, node = 1; k < kTreeLevels && lo < hs &&
                                level < kBisectIters; ++k, ++level) {
        const long long m = floor_half(lo + hs);
        const int bit = (ok >> (node - 1)) & 1;
        if (bit) hs = m; else lo = m + 1;
        node = 2 * node + bit;
      }
    }
    tok = max(min(t_gain, p.max_tokens), lo);
  }
  return max(min(tok, p.cap), flo);
}

// Step t of a warp's 32 lane spans, into registers: lane e's span is
// seconds [e * span, (e + 1) * span) of the warp's `n` (zeros past them),
// and its step t the tile's row e. Lanes q * kChunk .. q * kChunk +
// kChunk - 1 load kChunk consecutive seconds of one row an instruction, so
// a load touches 32 / kChunk rows, not 32. The loads are volatile: the
// compiler issues them here and cannot sink them past the decision to
// their first use.
__device__ __forceinline__ void fetch(int (&x)[kChunk], const int* base,
                                      int span, int n, int t, int lane) {
  const int col = t * kChunk + lane % kChunk;
#pragma unroll
  for (int r = 0; r < kChunk; ++r) {
    const int idx = (lane / kChunk + r * (32 / kChunk)) * span + col;
    int v = 0;
    if (col < span && idx < n)
      asm volatile("ld.global.nc.b32 %0, [%1];" : "=r"(v) : "l"(base + idx));
    x[r] = v;
  }
}

// The fetched step into the warp's tile: row e holds lane e's seconds.
__device__ __forceinline__ void stage(int* tile, const int (&x)[kChunk],
                                      int lane) {
#pragma unroll
  for (int r = 0; r < kChunk; ++r)
    tile[(lane / kChunk + r * (32 / kChunk)) * kTileRow + lane % kChunk] =
        x[r];
  __syncwarp();
}

// Fold `steps` steps of the warp's 32 lane spans (lane e: seconds
// [e * span, (e + 1) * span) of base's n, zeros past n) at allocation nt,
// step 0 already in x, into 32-bit summaries, the lanes then combined in
// order: lane 0 returns the warp's. Skylines are step functions, so as in
// K1 a lane folds each run of equal seconds once: a change mask a step,
// then one fold a change, the warp looping as often as its busiest lane
// changes; the next step's loads are in flight meanwhile. The zeros past
// a lane's own seconds are under any cap: they close a trailing over-cap
// run into `acc` instead of `tail`, the same runtime. `wide` (on every
// lane) says some sum passed 32 bits.
__device__ __forceinline__ arepas::Run32 fold_warp(
    int (&x)[kChunk], const int* base, int span, int n, int steps, int* tile,
    int lane, int nt, const arepas::Divisor& dv, bool& wide) {
  const int* row = tile + lane * kTileRow;
  arepas::Run32 r = arepas::identity32();
  bool w = false;
  int cur = 0x80000000;                      // no second has this usage
  int held = 0;                              // seconds of cur so far
  for (int t = 0; t < steps; ++t) {
    stage(tile, x, lane);
    if (t + 1 < steps) fetch(x, base, span, n, t + 1, lane);
    const int cnt = min(span - t * kChunk, kChunk);
    unsigned chg = 0;
    int prev = cur;
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
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
        if (count > 0) arepas::push(r, cur, count, nt, dv, w);
        cur = row[i];
        held = 0;
        last = i;
      }
    }
    held += cnt - last;
    __syncwarp();                            // the tile is free again
  }
  if (held > 0) arepas::push(r, cur, held, nt, dv, w);
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const arepas::Run32 o = arepas::shfl_down(r, off);
    if ((lane & (2 * off - 1)) == 0) r = arepas::combine(r, o, dv, w);
  }
  wide = __any_sync(kFull, w);
  return r;
}

// The runtime of `vlen` seconds at `row` by the exact 64-bit fold and
// combine, by one warp: for a skyline in which some excess reached 2^32
// (never in a real one: it takes an over-cap run of millions of
// token-seconds). Lane 0 returns it.
__device__ __noinline__ int exact_runtime(const int* row, int vlen, int nt,
                                          int lane) {
  const int span = (vlen + 31) / 32;
  const int mine = max(min(span, vlen - lane * span), 0);
  arepas::Run r = arepas::identity();
  for (int i = 0; i < mine; ++i)
    arepas::push(r, __ldg(row + lane * span + i), nt);
  return arepas::runtime(arepas::warp_combine(r, lane, nt), vlen, nt);
}

// Candidate c's outputs from its decision and its skyline's summary (the
// exact fold where the summary went wide), written by lane 0.
__device__ __forceinline__ void finish(const double* vecs, int C, int c,
                                       long long tgt, const arepas::Run32& r,
                                       bool wide, const int* row, int vlen,
                                       int nt, const arepas::Divisor& dv,
                                       double now, double epoch_s,
                                       unsigned char* out, int lane) {
  const long long* ivecs = (const long long*)vecs;
  const int runtime = wide ? exact_runtime(row, vlen, nt, lane)
                           : arepas::runtime(r, vlen, dv);
  if (lane == 0) {
    const long long rt = max((long long)runtime, 1LL);
    const double done = vecs[5LL * C + c];
    const double remaining =
        fmax(rint(__dmul_rn((double)rt, __dsub_rn(1.0, done))), 1.0);
    long long* tgt_out = (long long*)out;
    double* end_out = (double*)(out + 16LL * C);
    tgt_out[c] = tgt;
    tgt_out[(long long)C + c] = rt;
    end_out[c] = __dadd_rn(now, remaining);
    out[24LL * C + c] = (tgt < ivecs[6LL * C + c]) &&
                        (__dsub_rn(vecs[7LL * C + c], now) > epoch_s);
  }
}

// vecs: (9, C) rows of 8 bytes, RESIZE_ROWS of kernels/cluster_step.py:
// a, b, price (f64), obs, floor (i64), done (f64), cand_tok (i64),
// cand_end (f64), pool row (i64). out: tgt (C i64), rt (C i64), new_end
// (C f64), sel (C u8), packed in that order.
__global__ void __launch_bounds__(kResizeThreads < 1024 ? kResizeThreads : 1024)
resize_step_kernel(const double* __restrict__ vecs,
                   const int* __restrict__ sky, const int* __restrict__ lens,
                   double now, double epoch_s, Policy pol, int C, int smax,
                   unsigned char* __restrict__ out) {
  __shared__ int tiles[kBlockWarps * 32 * kTileRow];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = blockIdx.x * kBlockWarps + warp;
  if (c >= C) return;
  const long long* ivecs = (const long long*)vecs;

  // the skyline's first step into registers before the decision, and the
  // rest into L2: the loads depend on the row and its length, not on the
  // allocation
  const long long src = ivecs[8LL * C + c];
  const int vlen = min(max(lens[src], 0), smax);
  const int* row = sky + src * smax;
  const int span = (vlen + 31) / 32;
  const int steps = kFold ? (span + kChunk - 1) / kChunk : 0;
  if (kFold && span > kChunk)
    for (int b = 0; b < max(min(span, vlen - lane * span), 0); b += 32)
      asm volatile("prefetch.global.L2 [%0];" ::"l"(row + lane * span + b));
  int x[kChunk];
  if (steps > 0) fetch(x, row, span, vlen, 0, lane);

  const long long tgt =
      kDecide ? priced_decision(vecs[c], vecs[(long long)C + c],
                                vecs[2LL * C + c], ivecs[3LL * C + c],
                                ivecs[4LL * C + c], pol, lane)
              : ivecs[3LL * C + c];            // at the observed tokens

  // the AREPAS runtime at max(tgt, 1), K1's 32-bit run algebra with the
  // divisor made once. An allocation past 2^31 - 1 puts every int32
  // second under the cap, as 2^31 - 1 does.
  const int nt = (int)min(max(tgt, 1LL), 0x7fffffffLL);
  const arepas::Divisor dv = arepas::divisor(nt);
  bool wide = false;
  const arepas::Run32 r = fold_warp(x, row, span, vlen, steps,
                                    tiles + warp * 32 * kTileRow, lane, nt,
                                    dv, wide);
  finish(vecs, C, c, tgt, r, wide, row, vlen, nt, dv, now, epoch_s, out,
         lane);
}

// ------------------------------------------------------------------ K6 ---
// a, b: (n,) f64; price: (n,) f64 or null (1.0); observed: (n,) i64 or null
// (pol.max_tokens). tokens: (n,) i64, runtime: (n,) f64. A warp a row: a
// warp past the last row exits whole, so the warp-wide decision always has
// its 32 lanes.
__global__ void __launch_bounds__(kResizeThreads < 1024 ? kResizeThreads : 1024)
decide_policy_kernel(const double* __restrict__ a,
                     const double* __restrict__ b,
                     const double* __restrict__ price,
                     const long long* __restrict__ observed, Policy pol,
                     int n, long long* __restrict__ tokens,
                     double* __restrict__ runtime) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long r = (long long)blockIdx.x * kBlockWarps + warp;
  if (r >= n) return;
  const double ar = a[r], br = b[r];
  const long long tok = priced_decision(
      ar, br, price != nullptr ? price[r] : 1.0,
      observed != nullptr ? observed[r] : pol.max_tokens, LLONG_MIN, pol,
      lane);
  if (lane == 0) {
    tokens[r] = tok;
    runtime[r] = __dmul_rn(br, pow((double)tok, ar));
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

// K3 on C candidates, kBlockWarps a block of kResizeThreads threads. `vecs`
// holds the (9, C) rows of 8 bytes of resize_step_kernel (the last: each
// candidate's row of the (U, smax) pool); `out` takes the packed outputs,
// 25 C bytes.
extern "C" int resize_step_launch(const void* vecs, const void* sky,
                                  const void* lens, double now,
                                  double epoch_s, double gain,
                                  double max_slowdown, long long min_tokens,
                                  long long max_tokens, long long cap, int C,
                                  int smax, void* out, void* stream) {
  if (C > 0) {
    const Policy pol{gain, max_slowdown, min_tokens, max_tokens, cap};
    const int blocks = (int)(((long long)C + kBlockWarps - 1) / kBlockWarps);
    resize_step_kernel<<<blocks, kResizeThreads, 0, (cudaStream_t)stream>>>(
        (const double*)vecs, (const int*)sky, (const int*)lens, now, epoch_s,
        pol, C, smax, (unsigned char*)out);
  }
  return (int)cudaGetLastError();
}

// K6 on n rows, kBlockWarps a block of kResizeThreads threads. `price` and
// `observed` may be null (see decide_policy_kernel); cap and floor are
// neutral.
extern "C" int decide_policy_launch(const void* a, const void* b,
                                    const void* price, const void* observed,
                                    double gain, double max_slowdown,
                                    long long min_tokens,
                                    long long max_tokens, int n,
                                    void* tokens, void* runtime,
                                    void* stream) {
  if (n > 0) {
    const Policy pol{gain, max_slowdown, min_tokens, max_tokens, LLONG_MAX};
    const int blocks = (int)(((long long)n + kBlockWarps - 1) / kBlockWarps);
    decide_policy_kernel<<<blocks, kResizeThreads, 0, (cudaStream_t)stream>>>(
        (const double*)a, (const double*)b, (const double*)price,
        (const long long*)observed, pol, n, (long long*)tokens,
        (double*)runtime);
  }
  return (int)cudaGetLastError();
}
