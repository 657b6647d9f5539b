// Kernel K4: causal (or full) grouped-query flash attention, forward,
// written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:42
// (_flash_kernel, launched by flash_attention_bhsd). Same contract:
//   q (B, Hq, S, D), k/v (B, Hkv, S, D) in float32 or bf16; query head h
//   reads kv head h / (Hq / Hkv); scores q.k * (1/sqrt(D)) in float32;
//   causal entries (row < col) set to NEG_INF = -1e30; online softmax with
//   a float32 running max, denominator and accumulator; the denominator
//   floored at 1e-30; output in q's type. Its plain PyTorch version is
//   repro_torch/kernels/ref.py::attention_ref_bhsd.
//
// Beyond the TPU kernel: the softmax scale is an argument (1/sqrt(D) by
// default in the wrapper; granite-4.0-h's attention takes 1/128), and an
// optional per-sequence start kv_start (B,) int32, the left-padding of a
// served batch: keys before a row's start are masked like the causal
// future, the key tiles wholly before it are skipped (neither loaded nor
// multiplied), and query rows before it are written as 0.
//
// Layout. The kernel takes each tensor's batch, sequence and head strides
// (in elements; the head dim is contiguous), so it reads the model's
// (B, S, H, D) activations in place, with none of the reference wrapper's
// transposes.
//
// What bounds it. At the LM serving slice's prefill (B 8, Hq 32, Hkv 8,
// S 2048, D 128, bf16, causal) the work is 4 * B * Hq * D * S^2 / 2 =
// 2.75e11 operations against 0.34 GB of q, k, v and o: bound by the tensor
// cores (989 TFLOP/s bf16: 0.278 ms) before the bytes (0.100 ms at
// 3.35 TB/s). At zamba2-2.7b's shared attention (B 8, Hq = Hkv = 32,
// D 80) 1.74e11 operations, 0.174 ms.
//
// Two instantiations of each head dim (16, 32, 64, 80, 128):
//
// bf16, the serving and training paths: the tensor cores through wgmma.
//   * One block of 288 threads owns 128 query rows of one (b, h): one
//     producer warp and two consumer warpgroups of 64 rows each. Blocks go
//     heaviest first (most key tiles); B * Hq * S / 128 of them.
//   * The producer's lane 0 loads the Q tile once, and K and V tiles of
//     128 keys into a ring of 2 stages, by TMA (cp.async.bulk.tensor over
//     tensor maps of the (B, S, H, D) tensors, 128-byte swizzle), with a
//     full mbarrier per tile and a free one per stage: the next tile's K
//     and V are in flight while the current one computes. Rows past S and
//     head-dim columns past D arrive as zeros (TMA's bounds), so any
//     S >= 1 is taken; D 16 and 32 fill part of one 64-column atom, D 80
//     two atoms, of which the products read 80 columns: S = Q K^T takes 5
//     k-steps and P V an N of 80, so D 80 costs no padded work.
//   * S = Q K^T: wgmma.m64n128k16 with both operands K-major in shared
//     memory. The online softmax runs on the accumulator fragment in
//     registers, in base 2 (the scale 1/sqrt(D) folded with log2 e, in
//     float32): the row max over a quad of lanes by shuffles, the
//     denominator summed per thread from the float32 p and reduced across
//     the quad once at the end; masks only on the tiles that cross the
//     diagonal or S.
//   * O += P V: wgmma.m64nDk16 with P as the register A operand, straight
//     from the accumulator fragment (whose layout is A's) rounded to bf16,
//     and V the MN-major B operand read in place (no transpose).
//   * The two warpgroups wait on the ring independently, so one's softmax
//     overlaps the other's products. No atomics: the output is
//     deterministic.
//   * Shared memory: 160 KB at D 80 and 128, 80 KB at D <= 64; one block
//     an SM. ptxas (-Xptxas -v, CUDA 12.9, sm_90a): D 128: 168 registers;
//     D 80: 166; D 64, 32 and 16: 128; no spills.
//
// float32, the float32 route checks (2e-5): the CUDA cores, unchanged
// from the first port.
//   * One block owns one (b, h, 64-query tile); 256 threads as a 16 x 16
//     grid: thread (ty, tx) owns query rows ty + 16 i and key columns
//     tx + 16 j (i, j < 4) of each 64 x 64 score tile, so the 16 threads
//     of a row share one half-warp and reduce with shuffles;
//   * a loop inside the block walks the 64-key tiles up to the causal
//     limit (the structural skip); K, then V, is staged in one shared
//     buffer as float32, rows padded by 4 floats so that float4 reads of
//     16 rows are free of bank conflicts; the tile of probabilities goes
//     through shared memory to the P.V product;
//   * the running max, denominator and the (4 x D/16) accumulator stay in
//     registers for the whole walk; heaviest q tiles first; rows past S
//     are computed from zeros and not stored, columns past S masked.
//   * 88 KB of shared memory at D 128 (63.5 KB at D 80), two blocks an
//     SM; ptxas: 128 registers, 32 bytes spilled at D 128, 16 at D 80.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

// ================================================================== float32
// The CUDA-core path (float32 FMAs), kept for the float32 route checks.
namespace simt {

constexpr int kBQ = 64;            // queries per block
constexpr int kBK = 64;            // keys per tile
constexpr int kThreads = 256;
constexpr int kRows = kBQ / 16;    // query rows per thread
constexpr int kCols = kBK / 16;    // key columns per thread
constexpr float kNegInf = -1e30f;

struct Strides {                   // elements; the head dim is contiguous
  long long b, s, h;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }

// rows [s0, s0 + 64) of one head of a strided tensor -> shared float32 rows
// of `ld` floats; rows past S are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          long long stride_s, int s0, int S) {
  constexpr int kVecs = D / 4;
  for (int e = threadIdx.x; e < kBQ * kVecs; e += kThreads) {
    const int r = e / kVecs, c = (e % kVecs) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s0 + r < S) x = load4(src + (long long)(s0 + r) * stride_s + c);
    *reinterpret_cast<float4*>(dst + r * ld + c) = x;
  }
}

constexpr int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

template <int D>
struct Layout {
  static_assert(D % 16 == 0, "the head dim must be a multiple of 16");
  // o columns per read: the largest of 4, 2, 1 that divides D / 16, so
  // that kGroups * kVec == D / 16 for every such D (at D = 80, 5 groups
  // of 1; a plain min(D / 16, 4) would give 1 group of 4 and drop a
  // fifth of the columns)
  static constexpr int kVec = gcd(D / 16, 4);
  static constexpr int kGroups = D / (16 * kVec);        // column groups
  static constexpr int kAcc = kGroups * kVec;            // = D / 16
  static_assert(kAcc == D / 16, "every output column has an owner");
  static constexpr int kLdQ = D + 4;
  static constexpr int kLdKV = D + 4;
  static constexpr int kLdP = kBK + 16;   // rows 2 apart land 32 banks apart
  static constexpr int kSmemFloats = kBQ * kLdQ + kBK * kLdKV + kBQ * kLdP;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       Strides sq, Strides sk, Strides sv, Strides so,
                       const int* __restrict__ kv_start, int B, int Hq,
                       int Hkv, int S, int causal, float scale) {
  using L = Layout<D>;
  extern __shared__ float smem[];
  float* Qs = smem;                          // kBQ x kLdQ
  float* KVs = Qs + kBQ * L::kLdQ;           // kBK x kLdKV: K, then V
  float* Ps = KVs + kBK * L::kLdKV;          // kBQ x kLdP

  const int nq = (S + kBQ - 1) / kBQ;
  const int bh = blockIdx.x % (B * Hq);
  const int qt = nq - 1 - blockIdx.x / (B * Hq);   // heaviest tiles first
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * kBQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int start = kv_start != nullptr ? kv_start[b] : 0;

  const T* qh = q + b * sq.b + h * sq.h;
  const T* kh = k + b * sk.b + hk * sk.h;
  const T* vh = v + b * sv.b + hk * sv.h;
  load_tile<T, D>(Qs, L::kLdQ, qh, sq.s, q0, S);

  float m[kRows], l[kRows], acc[kRows][L::kAcc];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < L::kAcc; ++c) acc[i][c] = 0.f;
  }

  const int nk = (S + kBK - 1) / kBK;
  const int nk_live = causal ? min(qt + 1, nk) : nk;   // kBQ == kBK
  for (int kt = start / kBK; kt < nk_live; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                   // the last tile's V is no longer read
    load_tile<T, D>(KVs, L::kLdKV, kh, sk.s, k0, S);
    __syncthreads();

    // s = q . k over D, 4 x 4 per thread
    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qa[kRows], ka[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qa[i] = load4(Qs + (ty + 16 * i) * L::kLdQ + d);
#pragma unroll
      for (int j = 0; j < kCols; ++j) ka[j] = load4(KVs + (tx + 16 * j) * L::kLdKV + d);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          float a = s[i][j];
          a = fmaf(qa[i].x, ka[j].x, a);
          a = fmaf(qa[i].y, ka[j].y, a);
          a = fmaf(qa[i].z, ka[j].z, a);
          a = fmaf(qa[i].w, ka[j].w, a);
          s[i][j] = a;
        }
    }

    // scale, mask, online softmax; p goes to shared memory
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (col >= S || col < start || (causal && row < col)) x = kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[(ty + 16 * i) * L::kLdP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < L::kAcc; ++c) acc[i][c] *= alpha;
    }

    __syncthreads();                   // K no longer read; P complete
    load_tile<T, D>(KVs, L::kLdKV, vh, sv.s, k0, S);
    __syncthreads();

    // acc += p . v; thread owns columns (tx + 16 g) * kVec + e
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pa[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pa[i] = load4(Ps + (ty + 16 * i) * L::kLdP + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vrow = KVs + (kk + e) * L::kLdKV;
#pragma unroll
        for (int g = 0; g < L::kGroups; ++g) {
          float vv[L::kVec];
          const float* src = vrow + (tx + 16 * g) * L::kVec;
          if constexpr (L::kVec == 4) {
            const float4 t = load4(src);
            vv[0] = t.x; vv[1] = t.y; vv[2] = t.z; vv[3] = t.w;
          } else if constexpr (L::kVec == 2) {
            const float2 t = *reinterpret_cast<const float2*>(src);
            vv[0] = t.x; vv[1] = t.y;
          } else {
            vv[0] = src[0];
          }
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            const float p = e == 0 ? pa[i].x : e == 1 ? pa[i].y : e == 2 ? pa[i].z : pa[i].w;
#pragma unroll
            for (int c = 0; c < L::kVec; ++c)
              acc[i][g * L::kVec + c] = fmaf(p, vv[c], acc[i][g * L::kVec + c]);
          }
        }
      }
    }
  }

  // o = acc / max(l, 1e-30), rows past S not stored
  T* oh = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float inv = row < start ? 0.f : 1.f / fmaxf(l[i], 1e-30f);
    T* dst = oh + (long long)row * so.s;
#pragma unroll
    for (int g = 0; g < L::kGroups; ++g)
#pragma unroll
      for (int c = 0; c < L::kVec; ++c)
        store1(dst + (tx + 16 * g) * L::kVec + c, acc[i][g * L::kVec + c] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o,
           const long long* st, const int* kv_start, int B, int Hq, int Hkv,
           int S, int causal, float scale, cudaStream_t stream) {
  const int smem = Layout<D>::kSmemFloats * (int)sizeof(float);
  auto kernel = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)B * Hq * ((S + kBQ - 1) / kBQ);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, sq, sk, sv, so, kv_start,
      B, Hq, Hkv, S, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o,
               const long long* st, const int* ks, int B, int Hq, int Hkv,
               int S, int D, int causal, float scale, cudaStream_t stream) {
  switch (D) {
    case 16:  return launch<T, 16>(q, k, v, o, st, ks, B, Hq, Hkv, S, causal, scale, stream);
    case 32:  return launch<T, 32>(q, k, v, o, st, ks, B, Hq, Hkv, S, causal, scale, stream);
    case 64:  return launch<T, 64>(q, k, v, o, st, ks, B, Hq, Hkv, S, causal, scale, stream);
    case 80:  return launch<T, 80>(q, k, v, o, st, ks, B, Hq, Hkv, S, causal, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, st, ks, B, Hq, Hkv, S, causal, scale, stream);
    default:  return (int)cudaErrorInvalidValue;
  }
}

}  // namespace simt

// ===================================================================== bf16
// The tensor-core path. One block owns 128 query rows of one (b, h): two
// consumer warpgroups of 64 rows each and one producer warp.
namespace tc {

using namespace hopper;

constexpr int kBQ = 128;           // queries per block (2 x 64)
constexpr int kBK = 128;           // keys per tile
constexpr int kStages = 2;         // K/V ring depth
constexpr int kConsumers = 256;    // two warpgroups
constexpr int kThreads = kConsumers + 32;
constexpr float kNegInf = -1e30f;

template <int D>
struct Layout {
  static_assert(D % 16 == 0 && D <= 128, "head dim");
  static constexpr int kAtoms = (D + 63) / 64;          // 64-column atoms
  static constexpr int kQ = kAtoms * kBQ * 128;         // bytes of Q
  static constexpr int kKV = kAtoms * kBK * 128;        // bytes of a K or V tile
  static constexpr int kSmem = kQ + 2 * kStages * kKV + 1024;  // + alignment
};

struct Params {
  int B, Hq, Hkv, S, causal;
  float scale_log2;                // the softmax scale * log2(e)
  long long ob, os, oh;            // o's strides (elements)
  const int* kv_start;             // (B,) first key of each row, or null
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_tc(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ o, const Params p) {
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_q, bar_k[kStages], bar_v[kStages],
      bar_free[kStages];
  uint8_t* Qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Ks = Qs + L::kQ;                 // stage s at s * kKV
  uint8_t* Vs = Ks + kStages * L::kKV;

  const int nq = (p.S + kBQ - 1) / kBQ;
  const int bh = blockIdx.x % (p.B * p.Hq);
  const int qt = nq - 1 - blockIdx.x / (p.B * p.Hq);   // heaviest tiles first
  const int b = bh / p.Hq, h = bh % p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const int q0 = qt * kBQ;
  const int nk = (p.S + kBK - 1) / kBK;
  const int nk_live = p.causal ? min(qt + 1, nk) : nk;  // kBQ == kBK
  const int start = p.kv_start != nullptr ? p.kv_start[b] : 0;
  const int kt0 = start / kBK;     // the first tile with a live key

  if (threadIdx.x == 0) {
    mbar_init(&bar_q, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bar_k[s], 1);
      mbar_init(&bar_v[s], 1);
      mbar_init(&bar_free[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // producer: one thread keeps the ring of K and V tiles full; rows past
    // S and head-dim columns past D arrive as zeros (TMA's bounds)
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(&bar_q, L::kQ);
#pragma unroll
      for (int a = 0; a < L::kAtoms; ++a)
        tma_load_4d(Qs + a * kBQ * 128, &tq, &bar_q, 64 * a, h, q0, b);
      for (int kt = kt0; kt < nk_live; ++kt) {
        const int n = kt - kt0;    // the tile's place in the ring's order
        const int s = n % kStages;
        if (n >= kStages) mbar_wait(&bar_free[s], (n / kStages - 1) & 1);
        mbar_expect_tx(&bar_k[s], L::kKV);
#pragma unroll
        for (int a = 0; a < L::kAtoms; ++a)
          tma_load_4d(Ks + s * L::kKV + a * kBK * 128, &tk, &bar_k[s], 64 * a,
                      hk, kt * kBK, b);
        mbar_expect_tx(&bar_v[s], L::kKV);
#pragma unroll
        for (int a = 0; a < L::kAtoms; ++a)
          tma_load_4d(Vs + s * L::kKV + a * kBK * 128, &tv, &bar_v[s], 64 * a,
                      hk, kt * kBK, b);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63; this thread
  // rows r and r + 8 of them, columns 8 i + c and 8 i + c + 1 of each
  // accumulator
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const int r = (threadIdx.x % 128) / 32 * 16 + lane / 4;
  const int c = 2 * (lane % 4);
  const int row0 = q0 + 64 * wg + r;          // and row0 + 8
  const uint32_t q_at = smem_u32(Qs) + 64 * 128 * wg;

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  mbar_wait(&bar_q, 0);
  for (int kt = kt0; kt < nk_live; ++kt) {
    const int s = (kt - kt0) % kStages;
    const uint32_t ph = ((kt - kt0) / kStages) & 1;
    const uint32_t k_at = smem_u32(Ks + s * L::kKV);
    const uint32_t v_at = smem_u32(Vs + s * L::kKV);
    const int k0 = kt * kBK;

    // s = q . k^T on the tensor cores: 64 x 128 a warpgroup, K = D
    float sc[kBK / 2];
    mbar_wait(&bar_k[s], ph);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      SS<kBK, 0, 0>::mma(sc,
                         desc_k(q_at + (kk / 4) * kBQ * 128, 0, kk % 4),
                         desc_k(k_at + (kk / 4) * kBK * 128, 0, kk % 4),
                         kk > 0);
    wg_commit();
    wg_wait<0>();
    fence_regs(sc);

    // scale (to base 2), mask, online softmax on the fragment
    const bool edge = (p.causal && k0 + kBK - 1 > q0 + 64 * wg) ||
                      k0 + kBK > p.S || k0 < start;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < kBK / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * i + e] * p.scale_log2;
        if (edge) {
          const int col = k0 + 8 * i + c + (e & 1);
          const int row = row0 + 8 * (e >> 1);
          if (col >= p.S || col < start || (p.causal && row < col))
            x = kNegInf;
        }
        sc[4 * i + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
      const float m_new = fmaxf(m[j], mx[j]);
      alpha[j] = ex2(m[j] - m_new);
      m[j] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kBK / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = ex2(sc[4 * i + e] - m[e >> 1]);
        sum[e >> 1] += pe;                 // the denominator sums float32 p
        sc[4 * i + e] = pe;
      }
#pragma unroll
    for (int j = 0; j < 2; ++j) l[j] = l[j] * alpha[j] + sum[j];
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[4 * i + e] *= alpha[e >> 1];

    // o += p . v: p (rounded to bf16) straight from the fragment as the
    // register operand, v MN-major from shared memory
    uint32_t pa[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) pack_a(pa[kk], sc, kk);
    mbar_wait(&bar_v[s], ph);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      RS<D, 1>::mma(acc, pa[kk], desc_mn(v_at, kk, kBK * 128), 1);
    wg_commit();
    wg_wait<0>();
    fence_regs(acc);
    mbar_arrive(&bar_free[s]);
  }

  // o = acc / max(l, 1e-30); rows past S are not stored
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 1);
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 2);
  }
  __nv_bfloat16* oh = o + b * p.ob + h * p.oh;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = row0 + 8 * j;
    if (row >= p.S) continue;
    const float inv = row < start ? 0.f : 1.f / fmaxf(l[j], 1e-30f);
    __nv_bfloat16* dst = oh + (long long)row * p.os + c;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * i) = __floats2bfloat162_rn(
          acc[4 * i + 2 * j] * inv, acc[4 * i + 2 * j + 1] * inv);
  }
}

// a TMA map over the (B, S, H, D) bf16 tensor at `ptr` with element
// strides st = (batch, sequence, head): boxes of 64 head-dim columns x 1
// head x `rows` positions; rows past S and columns past D read as zeros
int make_map(CUtensorMap* map, const void* ptr, const long long* st, int B,
             int S, int H, int D, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  return make_map_bf16(map, ptr, 4, dims, strides, box);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o,
           const long long* st, const int* kv_start, int B, int Hq, int Hkv,
           int S, int causal, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, st, B, S, Hq, D, kBQ);
  if (err == 0) err = make_map(&tk, k, st + 3, B, S, Hkv, D, kBK);
  if (err == 0) err = make_map(&tv, v, st + 6, B, S, Hkv, D, kBK);
  if (err != 0) return err;
  auto kernel = flash_attention_tc<D>;
  const int smem = Layout<D>::kSmem;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (long long)B * Hq * ((S + kBQ - 1) / kBQ);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const Params p{B, Hq, Hkv, S, causal, scale * 1.4426950408889634f,
                 st[9], st[10], st[11], kv_start};
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)o, p);
  return (int)cudaGetLastError();
}

int dispatch_d(const void* q, const void* k, const void* v, void* o,
               const long long* st, const int* ks, int B, int Hq, int Hkv,
               int S, int D, int causal, float scale, cudaStream_t stream) {
  switch (D) {
    case 16:  return launch<16>(q, k, v, o, st, ks, B, Hq, Hkv, S, causal, scale, stream);
    case 32:  return launch<32>(q, k, v, o, st, ks, B, Hq, Hkv, S, causal, scale, stream);
    case 64:  return launch<64>(q, k, v, o, st, ks, B, Hq, Hkv, S, causal, scale, stream);
    case 80:  return launch<80>(q, k, v, o, st, ks, B, Hq, Hkv, S, causal, scale, stream);
    case 128: return launch<128>(q, k, v, o, st, ks, B, Hq, Hkv, S, causal, scale, stream);
    default:  return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tc

// Plain C interface for ctypes. `strides` is a host array of 12 element
// strides: (batch, sequence, head) of q, k, v and o in that order;
// `kv_start` a device array of B int32 starts, or null. dtype 0
// is float32 (the CUDA-core path), 1 is bf16 (the tensor-core path, which
// also needs 16-byte aligned q, k, v and strides that are multiples of 8).
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (or the error of the set-up that refused the launch),
// so a refused launch is reported.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o,
                                      const long long* strides,
                                      const int* kv_start, int B, int Hq,
                                      int Hkv, int S, int D, int causal,
                                      int dtype, float scale, void* stream) {
  if (B <= 0 || S <= 0 || Hq <= 0) return (int)cudaGetLastError();
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return simt::dispatch_d<float>(q, k, v, o, strides, kv_start, B, Hq, Hkv,
                                   S, D, causal, scale, st);
  if (dtype == 1)
    return tc::dispatch_d(q, k, v, o, strides, kv_start, B, Hq, Hkv, S, D,
                          causal, scale, st);
  return (int)cudaErrorInvalidValue;
}
