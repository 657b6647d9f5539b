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
// Layout. The kernel takes each tensor's batch, sequence and head strides
// (in elements; the head dim is contiguous), so it reads the model's
// (B, S, H, D) activations in place, with none of the reference wrapper's
// transposes.
//
// What bounds it. At the LM serving slice's prefill (B 8, Hq 32, Hkv 8,
// S 2048, D 128, bf16, causal) the work is 4 * B * Hq * D * S^2 / 2 =
// 2.75e11 operations against 0.34 GB of q, k, v and o: in principle it
// is bound by the tensor cores' operations (989 TFLOP/s bf16, 0.28 ms)
// before the bytes (0.10 ms at 3.35 TB/s). As written it computes with
// float32 FMAs on the CUDA cores (67 TFLOP/s, 4.1 ms at best): simple
// and right first; mma/wgmma, TMA and pipelining are later work.
//
// Design:
//   * one block owns one (b, h, 64-query tile); 256 threads as a 16 x 16
//     grid: thread (ty, tx) owns query rows ty + 16 i and key columns
//     tx + 16 j (i, j < 4) of each 64 x 64 score tile, so the 16 threads of
//     a row share one half-warp and reduce with shuffles;
//   * a loop inside the block walks the 64-key tiles up to the causal limit
//     (tiles wholly in the causal future are never visited: the structural
//     skip); K, then V, is staged in one shared buffer as float32, rows
//     padded by 4 floats so that float4 reads of 16 rows are free of bank
//     conflicts; the tile of probabilities goes through shared memory to
//     the P.V product;
//   * the running max, denominator and the (4 x D/16) accumulator stay in
//     registers for the whole walk;
//   * 88 KB of shared memory at D = 128 (63.5 KB at zamba2-2.7b's D = 80,
//     whose accumulator is 4 x 5 columns), so two blocks share an SM; q tiles
//     are scheduled heaviest (most key tiles) first. At the slice's shape
//     the grid is B * Hq * S / 64 = 8,192 blocks over 132 SMs.
//   * Rows past S are computed from zeros and not stored; columns past S
//     are masked like causal ones, so any S >= 1 is taken.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

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
                       int B, int Hq, int Hkv, int S, int causal, float scale) {
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
  for (int kt = 0; kt < nk_live; ++kt) {
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
        if (col >= S || (causal && row < col)) x = kNegInf;
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
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
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
           const long long* st, int B, int Hq, int Hkv, int S, int causal,
           float scale, cudaStream_t stream) {
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
      (const T*)q, (const T*)k, (const T*)v, (T*)o, sq, sk, sv, so, B, Hq,
      Hkv, S, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o,
               const long long* st, int B, int Hq, int Hkv, int S, int D,
               int causal, float scale, cudaStream_t stream) {
  switch (D) {
    case 16:  return launch<T, 16>(q, k, v, o, st, B, Hq, Hkv, S, causal, scale, stream);
    case 32:  return launch<T, 32>(q, k, v, o, st, B, Hq, Hkv, S, causal, scale, stream);
    case 64:  return launch<T, 64>(q, k, v, o, st, B, Hq, Hkv, S, causal, scale, stream);
    case 80:  return launch<T, 80>(q, k, v, o, st, B, Hq, Hkv, S, causal, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, st, B, Hq, Hkv, S, causal, scale, stream);
    default:  return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface for ctypes. `strides` is a host array of 12 element
// strides: (batch, sequence, head) of q, k, v and o in that order. dtype 0
// is float32, 1 is bf16. Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() (or the error of the shared-memory attribute
// call), so a refused launch is reported.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o,
                                      const long long* strides, int B, int Hq,
                                      int Hkv, int S, int D, int causal,
                                      int dtype, float scale, void* stream) {
  if (B <= 0 || S <= 0 || Hq <= 0) return (int)cudaGetLastError();
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, o, strides, B, Hq, Hkv, S, D, causal, scale, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, strides, B, Hq, Hkv, S, D, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}
