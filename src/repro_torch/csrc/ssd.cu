// Kernel K5: the Mamba-2 SSD (state-space dual) chunk scan, forward,
// written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd.py:35 (_ssd_kernel,
// launched by ssd_chunk_scan at l.93). Same contract:
//   x (B, S, H, P) in float32 or bf16; dt (B, S, H) float32; A (H,)
//   float32; B/C (B, S, N) in x's type, shared by all heads. Chunks of Q
//   rows (S % Q == 0). Within a chunk, with log_a = dt * A and cs its
//   inclusive cumulative sum:
//     y_i = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j
//           + exp(cs_i) (C_i . h_prev)
//     h   = exp(cs_last) h_prev + sum_q exp(cs_last - cs_q) dt_q x_q B_q^T
//   with the (P, N) float32 state h carried from chunk to chunk and zero
//   before the first. The decay exp(cs_i - cs_j) is computed only for
//   i >= j: for i < j it can overflow to +inf, and inf * 0 is NaN.
//   Everything accumulates in float32; y is written in x's type. Its
//   plain PyTorch version is repro_torch/models/layers.py::ssd_chunked.
//
// What bounds it. At zamba2-2.7b's training shape (B 8, S 2048, H 80,
// P 64, N 64, Q 128, bf16) the work is 2 Q^2 (N + P) + 4 Q N P operations
// a chunk and head, 6.4e10 in all (0.065 ms at the bf16 tensor-core rate),
// against 336 MB of x and y and ~9 MB of dt, B and C (0.10 ms at
// 3.35 TB/s): bound by the bytes. At mamba2-1.3b's (H 64, N 128) by the
// operations (0.087 ms).
//
// Two instantiations of each (P, N), P in {16, 32, 64}, N in {16, 32, 64,
// 128}:
//
// bf16, the training path: the tensor cores through wgmma, Q <= 256.
//   * One block of 288 threads owns one (b, h) and walks its chunks with
//     the (P, N) float32 state in registers: no per-chunk state goes to
//     device memory. B * H blocks (640 at zamba2's shape), one an SM.
//   * A producer warp keeps a ring of up to 4 stages full (as many as
//     fit in shared memory): lane 0 copies the chunk's x (P columns of
//     head h), B and C by TMA, 128-byte swizzled, rows past Q and columns
//     past P or N zero; the lanes load dt before the stage is free and
//     form the inclusive cumulative sum cs of the float32 products dt * A
//     in float64 (a run per lane, then shuffles), and store per row cs
//     log2(e) as a float32 pair hi + lo, dt, exp(cs) and dt exp(cs_last -
//     cs). The pair keeps the decay's argument exact to float32 rounding
//     where cs reaches -300 or less (a float32 cs is off by several 1e-5
//     there), with float32 arithmetic only in the consumers.
//   * Warpgroup 0 computes y for the chunk's 64-row tiles 1 .. (tile 0 of
//     Q <= 64); warpgroup 1 computes y for tile 0 (when Q > 64) and
//     carries the state. For a tile i: exp(cs_i) C_i . h_prev
//     (wgmma.m64nPk16, C and a bf16 copy of h_prev K-major in shared
//     memory), then for each tile j <= i G = C_i . B_j^T (wgmma.m64n64k16,
//     both K-major), multiplied in registers by dt_j 2^(hi_i - hi_j +
//     lo_i - lo_j) where i >= j (0 elsewhere: the exponent is never taken
//     above the diagonal) and rounded to bf16 as the register A operand of
//     y += G . x_j (wgmma.m64nPk16 RS, x MN-major). The next tile's G
//     starts before this one's elementwise pass and runs under it.
//   * The state: h = exp(cs_last) h + (x o dt w)^T . B (wgmma.m64nNk16,
//     both operands MN-major), with w = exp(cs_last - cs) and x o dt w
//     rounded to bf16 into warpgroup 1's own buffer; h stays in warpgroup
//     1's registers. Its bf16 copy for the next chunk's C . h_prev is
//     written once warpgroup 0 has read the last one (named barriers in
//     both directions), so warpgroup 0 runs a chunk behind at most.
//   * Shared memory at Q 128: 3 stages, 178 KB at N 64; 2 stages, 199 KB
//     at N 128. ptxas (-Xptxas -v, CUDA 12.9, sm_90a): 163-168
//     registers; (P, N) (64, 128) spills 12 bytes (the second G buffer,
//     which makes that instance a little slower than one buffer would).
//
// float32, the float32 route checks (2e-5): the CUDA cores, unchanged
// from the first port. Its bf16 instantiation (bf16 loads and stores,
// float32 arithmetic) takes the bf16 chunks of more than 256 rows, which
// the tensor-core path's one TMA box cannot hold.
//   * the TPU grid (B, H, chunks) runs its chunk axis in order to carry
//     the state in VMEM; here one block owns one (b, h) and walks the
//     chunks in a loop, with the (P, N) float32 state in shared memory;
//   * a chunk is cut into 64-row time tiles. For each row tile i: C_i is
//     staged, the inter-chunk term exp(cs_i) (C_i . h_prev) starts the
//     (64 x P) accumulator in registers, then for each column tile j <= i
//     (the causal skip) B_j and dt_j x_j are staged, the 64 x 64 tile of
//     (C_i . B_j) exp(cs_i - cs_j) is formed and goes through shared
//     memory to the product with dt_j x_j. Then the state update walks
//     the tiles once more;
//   * 256 threads as a 16 x 16 grid: thread (ty, tx) owns rows ty + 16 a
//     and columns tx + 16 b of every 64-row tile, as in kernel K4; rows of
//     B, C and h are padded by 4 floats so that float4 reads of 16 rows
//     are free of bank conflicts;
//   * cs is an inclusive scan of the float32 products dt * A by one warp
//     (a run per lane, then shuffles), summed in float64, so that the
//     differences of cs are exact to float32 rounding. Rows of a tile past
//     Q are zeros and are not stored, so any Q is taken;
//   * shared memory at P 64: 91 KB at N 64 (two blocks an SM), 140 KB at
//     N 128; 128 registers, no spills.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

// ================================================================== float32
// The CUDA-core path (float32 FMAs): float32, and bf16 chunks over 256 rows.
namespace simt {

constexpr int kT = 64;             // rows of a time tile
constexpr int kThreads = 256;
constexpr int kR = kT / 16;        // tile rows (and G columns) per thread

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

template <int P, int N>
struct Layout {
  static constexpr int kLdN = N + 4;      // rows of B, C and h
  static constexpr int kLdG = kT + 16;    // rows 2 apart land 32 banks apart
  static constexpr int kC = 0;                        // kT x kLdN
  static constexpr int kB = kC + kT * kLdN;           // kT x kLdN
  static constexpr int kX = kB + kT * kLdN;           // kT x P: dt * x
  static constexpr int kG = kX + kT * P;              // kT x kLdG
  static constexpr int kH = kG + kT * kLdG;           // P x kLdN: state
  static constexpr int kFixed = kH + P * kLdN;        // then Q doubles
                                                      // and 2 x Q floats
};

// the kT rows of a strided (rows, W) matrix that start at `src` ->
// shared float32 rows of `ld` floats, row r times scale[r] if scale is
// given; rows at or past `valid` are zero.
template <typename T, int W>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          long long stride, int valid,
                                          const float* scale) {
  constexpr int kVecs = W / 4;
  for (int e = threadIdx.x; e < kT * kVecs; e += kThreads) {
    const int r = e / kVecs, c = (e % kVecs) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) {
      v = load4(src + (long long)r * stride + c);
      if (scale != nullptr) {
        const float s = scale[r];
        v.x *= s; v.y *= s; v.z *= s; v.w *= s;
      }
    }
    *reinterpret_cast<float4*>(dst + r * ld + c) = v;
  }
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads, 2)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, T* __restrict__ y, int S, int H, int Q) {
  using L = Layout<P, N>;
  constexpr int kCP = P / 16;          // y columns per thread
  constexpr int kCN = N / 16;          // state columns per thread
  extern __shared__ float smem[];
  float* Cs = smem + L::kC;
  float* Bs = smem + L::kB;
  float* Xs = smem + L::kX;
  float* Gs = smem + L::kG;
  float* Hs = smem + L::kH;
  // Q: inclusive cumsum of dt * A, in float64 (16-byte aligned: kFixed
  // is a multiple of 4 floats)
  double* cs = reinterpret_cast<double*>(smem + L::kFixed);
  float* dts = reinterpret_cast<float*>(cs + Q);      // Q: dt of the chunk
  float* wq = dts + Q;                 // Q: exp(cs_last - cs_q)

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const float a_h = A[h];
  const long long row_x = (long long)H * P;            // x, y row stride
  const T* xb = x + (long long)b * S * row_x + (long long)h * P;
  T* yb = y + (long long)b * S * row_x + (long long)h * P;
  const float* dtb = dt + (long long)b * S * H + h;    // row stride H
  const T* Bb = Bm + (long long)b * S * N;
  const T* Cb = Cm + (long long)b * S * N;

  for (int e = threadIdx.x; e < P * L::kLdN; e += kThreads) Hs[e] = 0.f;
  const int nT = (Q + kT - 1) / kT;

  for (int c0 = 0; c0 < S; c0 += Q) {
    __syncthreads();                   // the last chunk's reads are done
    for (int i = threadIdx.x; i < Q; i += kThreads) {
      const float d = dtb[(long long)(c0 + i) * H];
      dts[i] = d;
      cs[i] = (double)(d * a_h);       // log_a in float32, summed in float64
    }
    __syncthreads();
    if (warp == 0) {                   // inclusive scan: a run per lane
      const int per = (Q + 31) / 32;
      const int lo = min(lane * per, Q), hi = min(lo + per, Q);
      double run = 0.0;
      for (int i = lo; i < hi; ++i) run += cs[i];
      double incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double t = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += t;
      }
      double acc = __shfl_up_sync(0xffffffffu, incl, 1);  // exclusive
      if (lane == 0) acc = 0.0;
      for (int i = lo; i < hi; ++i) {
        acc += cs[i];
        cs[i] = acc;
      }
    }
    __syncthreads();
    const double cs_last = cs[Q - 1];
    for (int i = threadIdx.x; i < Q; i += kThreads)
      wq[i] = expf((float)(cs_last - cs[i]));

    for (int it = 0; it < nT; ++it) {
      const int i0 = it * kT;
      load_tile<T, N>(Cs, L::kLdN, Cb + (long long)(c0 + i0) * N, N, Q - i0,
                      nullptr);
      __syncthreads();

      // inter-chunk term: exp(cs_i) * (C_i . h_prev[p])
      float acc[kR][kCP];
#pragma unroll
      for (int r = 0; r < kR; ++r)
#pragma unroll
        for (int c = 0; c < kCP; ++c) acc[r][c] = 0.f;
#pragma unroll 2
      for (int n = 0; n < N; n += 4) {
        float4 ca[kR], ha[kCP];
#pragma unroll
        for (int r = 0; r < kR; ++r) ca[r] = load4(Cs + (ty + 16 * r) * L::kLdN + n);
#pragma unroll
        for (int c = 0; c < kCP; ++c) ha[c] = load4(Hs + (tx + 16 * c) * L::kLdN + n);
#pragma unroll
        for (int r = 0; r < kR; ++r)
#pragma unroll
          for (int c = 0; c < kCP; ++c) {
            float s = acc[r][c];
            s = fmaf(ca[r].x, ha[c].x, s);
            s = fmaf(ca[r].y, ha[c].y, s);
            s = fmaf(ca[r].z, ha[c].z, s);
            s = fmaf(ca[r].w, ha[c].w, s);
            acc[r][c] = s;
          }
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int i = i0 + ty + 16 * r;
        const float e = i < Q ? expf((float)cs[i]) : 0.f;
#pragma unroll
        for (int c = 0; c < kCP; ++c) acc[r][c] *= e;
      }

      // intra-chunk term over column tiles j <= i
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kT;
        __syncthreads();               // Bs, Xs and Gs are free
        load_tile<T, N>(Bs, L::kLdN, Bb + (long long)(c0 + j0) * N, N, Q - j0,
                      nullptr);
        load_tile<T, P>(Xs, P, xb + (long long)(c0 + j0) * row_x, row_x, Q - j0,
                      dts + j0);
        __syncthreads();

        float g[kR][kR];
#pragma unroll
        for (int r = 0; r < kR; ++r)
#pragma unroll
          for (int k = 0; k < kR; ++k) g[r][k] = 0.f;
#pragma unroll 2
        for (int n = 0; n < N; n += 4) {
          float4 ca[kR], ba[kR];
#pragma unroll
          for (int r = 0; r < kR; ++r) ca[r] = load4(Cs + (ty + 16 * r) * L::kLdN + n);
#pragma unroll
          for (int k = 0; k < kR; ++k) ba[k] = load4(Bs + (tx + 16 * k) * L::kLdN + n);
#pragma unroll
          for (int r = 0; r < kR; ++r)
#pragma unroll
            for (int k = 0; k < kR; ++k) {
              float s = g[r][k];
              s = fmaf(ca[r].x, ba[k].x, s);
              s = fmaf(ca[r].y, ba[k].y, s);
              s = fmaf(ca[r].z, ba[k].z, s);
              s = fmaf(ca[r].w, ba[k].w, s);
              g[r][k] = s;
            }
        }
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const int i = i0 + ty + 16 * r;
#pragma unroll
          for (int k = 0; k < kR; ++k) {
            const int j = j0 + tx + 16 * k;
            // exponent only where i >= j (and i inside the chunk)
            const float v =
                (i < Q && j <= i) ? g[r][k] * expf((float)(cs[i] - cs[j])) : 0.f;
            Gs[(ty + 16 * r) * L::kLdG + tx + 16 * k] = v;
          }
        }
        __syncthreads();

#pragma unroll 2
        for (int kk = 0; kk < kT; kk += 4) {
          float4 ga[kR];
#pragma unroll
          for (int r = 0; r < kR; ++r) ga[r] = load4(Gs + (ty + 16 * r) * L::kLdG + kk);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float xv[kCP];
#pragma unroll
            for (int c = 0; c < kCP; ++c) xv[c] = Xs[(kk + e) * P + tx + 16 * c];
#pragma unroll
            for (int r = 0; r < kR; ++r) {
              const float gv = e == 0 ? ga[r].x : e == 1 ? ga[r].y : e == 2 ? ga[r].z : ga[r].w;
#pragma unroll
              for (int c = 0; c < kCP; ++c) acc[r][c] = fmaf(gv, xv[c], acc[r][c]);
            }
          }
        }
      }

#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int i = i0 + ty + 16 * r;
        if (i >= Q) continue;
        T* dst = yb + (long long)(c0 + i) * row_x;
#pragma unroll
        for (int c = 0; c < kCP; ++c) store1(dst + tx + 16 * c, acc[r][c]);
      }
      __syncthreads();                 // Cs is free
    }

    // state update: h = exp(cs_last) h + sum_q (dt_q x_q exp(cs_last - cs_q)) B_q
    float hacc[kCP][kCN];
#pragma unroll
    for (int a = 0; a < kCP; ++a)
#pragma unroll
      for (int n = 0; n < kCN; ++n) hacc[a][n] = 0.f;
    for (int jt = 0; jt < nT; ++jt) {
      const int j0 = jt * kT;
      __syncthreads();
      load_tile<T, N>(Bs, L::kLdN, Bb + (long long)(c0 + j0) * N, N, Q - j0,
                      nullptr);
      load_tile<T, P>(Xs, P, xb + (long long)(c0 + j0) * row_x, row_x, Q - j0,
                      dts + j0);
      __syncthreads();
      const int rows = min(kT, Q - j0);
      for (int q = 0; q < rows; ++q) {
        const float w = wq[j0 + q];
        float xw[kCP], bv[kCN];
#pragma unroll
        for (int a = 0; a < kCP; ++a) xw[a] = Xs[q * P + ty + 16 * a] * w;
#pragma unroll
        for (int n = 0; n < kCN; ++n) bv[n] = Bs[q * L::kLdN + tx + 16 * n];
#pragma unroll
        for (int a = 0; a < kCP; ++a)
#pragma unroll
          for (int n = 0; n < kCN; ++n) hacc[a][n] = fmaf(xw[a], bv[n], hacc[a][n]);
      }
    }
    __syncthreads();
    const float decay = expf((float)cs_last);
#pragma unroll
    for (int a = 0; a < kCP; ++a)
#pragma unroll
      for (int n = 0; n < kCN; ++n) {
        float* hp = Hs + (ty + 16 * a) * L::kLdN + tx + 16 * n;
        *hp = *hp * decay + hacc[a][n];
      }
  }
}

template <typename T, int P, int N>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, void* y, int Bsz, int S, int H, int Q,
           cudaStream_t stream) {
  const size_t smem =
      (size_t)(Layout<P, N>::kFixed + 4 * Q) * sizeof(float);   // Q doubles + 2Q floats
  auto kernel = ssd_kernel<T, P, N>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)Bsz * H;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      (const T*)x, dt, A, (const T*)Bm, (const T*)Cm, (T*)y, S, H, Q);
  return (int)cudaGetLastError();
}

template <typename T, int P>
int dispatch_n(const void* x, const float* dt, const float* A, const void* Bm,
               const void* Cm, void* y, int Bsz, int S, int H, int N, int Q,
               cudaStream_t st) {
  switch (N) {
    case 16:  return launch<T, P, 16>(x, dt, A, Bm, Cm, y, Bsz, S, H, Q, st);
    case 32:  return launch<T, P, 32>(x, dt, A, Bm, Cm, y, Bsz, S, H, Q, st);
    case 64:  return launch<T, P, 64>(x, dt, A, Bm, Cm, y, Bsz, S, H, Q, st);
    case 128: return launch<T, P, 128>(x, dt, A, Bm, Cm, y, Bsz, S, H, Q, st);
    default:  return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_p(const void* x, const float* dt, const float* A, const void* Bm,
               const void* Cm, void* y, int Bsz, int S, int H, int P, int N,
               int Q, cudaStream_t st) {
  switch (P) {
    case 16: return dispatch_n<T, 16>(x, dt, A, Bm, Cm, y, Bsz, S, H, N, Q, st);
    case 32: return dispatch_n<T, 32>(x, dt, A, Bm, Cm, y, Bsz, S, H, N, Q, st);
    case 64: return dispatch_n<T, 64>(x, dt, A, Bm, Cm, y, Bsz, S, H, N, Q, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace simt

// ===================================================================== bf16
// The tensor-core path. One block owns one (b, h): a producer warp keeps a
// ring of whole chunks full (x, B, C by TMA; dt, the cumulative sum and
// the state-update weights by its own lanes); warpgroup 0 computes y for
// the chunk's later 64-row tiles; warpgroup 1 computes y for the earlier
// tiles and carries the state.
namespace tc {

using namespace hopper;

constexpr int kConsumers = 256;    // two warpgroups
constexpr int kThreads = kConsumers + 32;
constexpr int kMaxQ = 256;         // a chunk is one TMA box of rows
constexpr int kMaxSmem = 226 * 1024;
constexpr int kMaxStages = 4;      // ring depth, as far as it fits
constexpr double kLog2e = 1.4426950408889634;
constexpr int kBarHRead = 1;       // warpgroup 0 has read h_prev's copy
constexpr int kBarHReady = 2;      // warpgroup 1 has written h's copy
constexpr int kBarWG1 = 3;         // warpgroup 1 alone

// Byte offsets in shared memory for chunks of Q rows and state width N,
// the same on host and card. A stage holds 1 + 2 nN atoms of `rows` rows
// (x; B; C), then five float32 vectors of `rows` (Vec). After the stages:
// warpgroup 1's bf16 x o dt w (one atom) and the bf16 copy of the state
// (64 x N, nN atoms of 64 rows).
struct Geo {
  int rows, nN, atom, vec, stage, xs, h, total;
};

// The per-row vectors of a staged chunk, from the float64 inclusive
// cumulative sum cs of dt * A: cs log2(e) as a float32 pair hi + lo (so
// that the difference of two rows is exact to float32 rounding, where
// float32 cs alone would be off by several 1e-5 near -300), dt,
// exp(cs) and dt exp(cs_last - cs).
struct Vec {
  float *hi, *lo, *dt, *ecs, *sw;
};

__device__ __forceinline__ Vec vectors(uint8_t* stage, int vec, int rows) {
  float* f = reinterpret_cast<float*>(stage + vec);
  return {f, f + rows, f + 2 * rows, f + 3 * rows, f + 4 * rows};
}

__host__ __device__ inline Geo geometry(int Q, int N, int stages) {
  Geo g;
  g.rows = (Q + 63) / 64 * 64;
  g.nN = (N + 63) / 64;
  g.atom = g.rows * 128;
  g.vec = g.atom * (1 + 2 * g.nN);     // x at 0, B at atom, C at (1 + nN) atom
  g.stage = (g.vec + g.rows * 20 + 1023) / 1024 * 1024;
  g.xs = stages * g.stage;
  g.h = g.xs + g.atom;
  g.total = g.h + g.nN * 64 * 128 + 1024;   // + alignment
  return g;
}

// y of the 64-row tile `it` of a chunk, in two halves. y_start issues
// C_i . h_prev (into yacc) and C_i . B_0^T (into gacc) as one wgmma group
// and does not wait. y_finish waits for it (then, if `signal`, tells
// warpgroup 1 that h_prev's copy has been read), scales yacc by exp(cs_i),
// and for each tile j <= i forms (C_i . B_j) o exp(cs_i - cs_j) dt_j in
// registers, rounds it to bf16 as the A operand and adds its product with
// x_j; C_i . B_{j+1}^T starts before tile j's elementwise pass.
template <int P, int N>
__device__ __forceinline__ void y_start(float (&yacc)[P / 2], float (&gacc)[32],
                                        int i0, uint32_t b_at, uint32_t c_at,
                                        uint32_t h_at, int atom) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    SS<P, 0, 0>::mma(yacc, desc_k(c_at + (kk / 4) * atom, i0, kk % 4),
                     desc_k(h_at + (kk / 4) * 8192, 0, kk % 4), kk > 0);
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    SS<64, 0, 0>::mma(gacc, desc_k(c_at + (kk / 4) * atom, i0, kk % 4),
                      desc_k(b_at + (kk / 4) * atom, 0, kk % 4), kk > 0);
  wg_commit();
}

template <int P, int N>
__device__ __forceinline__ void y_finish(float (&yacc)[P / 2],
                                         float (&gacc)[32], int it,
                                         uint32_t x_at, uint32_t b_at,
                                         uint32_t c_at, int atom, Vec v,
                                         int Q, __nv_bfloat16* ychunk,
                                         long long ystride, bool signal) {
  const int lane = threadIdx.x % 32;
  const int r = (threadIdx.x % 128) / 32 * 16 + lane / 4;
  const int cc = 2 * (lane % 4);
  const int i0 = 64 * it;
  wg_wait<0>();
  fence_regs(yacc);
  fence_regs(gacc);
  if (signal) bar_arrive(kBarHRead, kConsumers);
  const int ia = i0 + r, ib = ia + 8;
  const float ea = ia < Q ? v.ecs[ia] : 0.f, eb = ib < Q ? v.ecs[ib] : 0.f;
  const float hia = ia < Q ? v.hi[ia] : 0.f, loa = ia < Q ? v.lo[ia] : 0.f;
  const float hib = ib < Q ? v.hi[ib] : 0.f, lob = ib < Q ? v.lo[ib] : 0.f;
#pragma unroll
  for (int i = 0; i < P / 8; ++i) {
    yacc[4 * i] *= ea;
    yacc[4 * i + 1] *= ea;
    yacc[4 * i + 2] *= eb;
    yacc[4 * i + 3] *= eb;
  }
  // G_j in `cur`; G_{j+1} (if any) starts into `nxt` before cur's
  // elementwise pass, so its product overlaps it
  auto step = [&](float (&cur)[32], float (&nxt)[32], int jt) {
    const int j0 = 64 * jt;
    if (jt < it) {
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
        SS<64, 0, 0>::mma(nxt, desc_k(c_at + (kk / 4) * atom, i0, kk % 4),
                          desc_k(b_at + (kk / 4) * atom, j0 + 64, kk % 4),
                          kk > 0);
      wg_commit();
    }
    const bool whole = jt < it && i0 + 64 <= Q;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int j = j0 + 8 * i + cc + t;
        const float hj = v.hi[j], lj = v.lo[j], dj = v.dt[j];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int e = 2 * half + t, row = half ? ib : ia;
          const float d = ((half ? hib : hia) - hj) + ((half ? lob : loa) - lj);
          float w = cur[4 * i + e] * dj;
          if (whole)
            w *= ex2(d);
          else
            w = (row < Q && j <= row) ? w * ex2(d) : 0.f;
          cur[4 * i + e] = w;
        }
      }
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pack_a(pa[kk], cur, kk);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      RS<P, 1>::mma(yacc, pa[kk], desc_mn(x_at + j0 * 128, kk, atom), 1);
    wg_commit();
    wg_wait<0>();                      // this x product and the next G
    fence_regs(nxt);
  };
  float g2[32];
  for (int jt = 0; jt <= it; jt += 2) {
    step(gacc, g2, jt);
    if (jt + 1 <= it) step(g2, gacc, jt + 1);
  }
  fence_regs(yacc);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = j == 0 ? ia : ib;
    if (row >= Q) continue;
    __nv_bfloat16* dst = ychunk + (long long)row * ystride + cc;
#pragma unroll
    for (int i = 0; i < P / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * i) =
          __floats2bfloat162_rn(yacc[4 * i + 2 * j], yacc[4 * i + 2 * j + 1]);
  }
}

template <int P, int N>
__global__ void __launch_bounds__(kThreads, 1)
ssd_tc(const __grid_constant__ CUtensorMap tx,
       const __grid_constant__ CUtensorMap tb,
       const __grid_constant__ CUtensorMap tcm, const float* __restrict__ dt,
       const float* __restrict__ A, __nv_bfloat16* __restrict__ y, int S,
       int H, int Q, int stages) {
  constexpr int kNA = (N + 63) / 64;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_full[kMaxStages], bar_free[kMaxStages];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const Geo g = geometry(Q, N, stages);
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int nc = S / Q;
  const int nT = g.rows / 64;

  // TMA writes rows < Q of each staged atom, and warpgroup 1 rows < Q of
  // its scaled x: rows Q .. rows - 1 of both, and the state copy, start
  // (and stay) zero
  const int pad = g.rows - Q;
  const int padded = stages * (1 + 2 * kNA) + 1;
  for (int e = threadIdx.x; e < padded * pad * 8; e += kThreads) {
    const int ch = e % 8, rr = Q + (e / 8) % pad, at = e / (8 * pad);
    uint8_t* base = at < padded - 1
                        ? sm + (at / (1 + 2 * kNA)) * g.stage +
                              (at % (1 + 2 * kNA)) * g.atom
                        : sm + g.xs;
    *reinterpret_cast<uint4*>(base + rr * 128 + ch * 16) = make_uint4(0, 0, 0, 0);
  }
  for (int e = threadIdx.x; e < kNA * 64 * 8; e += kThreads)
    *reinterpret_cast<uint4*>(sm + g.h + e * 16) = make_uint4(0, 0, 0, 0);
  fence_async_smem();
  if (threadIdx.x == 0) {
    for (int s = 0; s < kMaxStages; ++s) {
      mbar_init(&bar_full[s], 2);      // the TMA bytes' arrival + the vectors'
      mbar_init(&bar_free[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // producer warp. For chunk c: the lanes load dt (before the stage is
    // free) and form cs, the inclusive cumulative sum of the float32
    // products dt * A, in float64 (a run of up to 8 rows per lane, then
    // shuffles); once both warpgroups have released stage c % stages, lane
    // 0 starts the TMA copies of x, B and C and the lanes store the
    // chunk's vectors (Vec)
    const int lane = threadIdx.x % 32;
    const float a_h = A[h];
    const float* dtb = dt + (long long)b * S * H + h;     // row stride H
    const uint32_t bytes = (uint32_t)Q * 128 * (1 + 2 * kNA);
    const int per = (Q + 31) / 32;                         // <= 8
    const int lo = min(lane * per, Q), n = min(per, Q - lo);
    for (int c = 0; c < nc; ++c) {
      float d[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        d[k] = k < n ? dtb[(long long)(c * Q + lo + k) * H] : 0.f;
      double v[8], run = 0.0;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        run += (double)(d[k] * a_h);
        v[k] = run;
      }
      double incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double t = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += t;
      }
      double excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.0;
      const double cs_last = __shfl_sync(0xffffffffu, incl, 31);

      const int s = c % stages;
      if (c >= stages) mbar_wait(&bar_free[s], (c / stages - 1) & 1);
      uint8_t* st = sm + s * g.stage;
      if (lane == 0) {
        mbar_expect_tx(&bar_full[s], bytes);
        tma_load_4d(st, &tx, &bar_full[s], 0, h, c * Q, b);
#pragma unroll
        for (int a = 0; a < kNA; ++a) {
          tma_load_3d(st + (1 + a) * g.atom, &tb, &bar_full[s], 64 * a,
                      c * Q, b);
          tma_load_3d(st + (1 + kNA + a) * g.atom, &tcm, &bar_full[s],
                      64 * a, c * Q, b);
        }
      }
      const Vec vs = vectors(st, g.vec, g.rows);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (k < n) {
          const double x = v[k] + excl, x2 = x * kLog2e;
          const float hi = (float)x2;
          vs.hi[lo + k] = hi;
          vs.lo[lo + k] = (float)(x2 - (double)hi);
          vs.dt[lo + k] = d[k];
          vs.ecs[lo + k] = expf((float)x);
          vs.sw[lo + k] = d[k] * expf((float)(cs_last - x));
        }
      __syncwarp();
      if (lane == 0) mbar_arrive(&bar_full[s]);
    }
    return;
  }

  const int wg = threadIdx.x / 128;
  const long long ystride = (long long)H * P;
  __nv_bfloat16* yb = y + ((long long)b * S * H + h) * P;
  const uint32_t h_at = smem_u32(sm + g.h);
  const int t_split = min(1, nT / 2);  // warpgroup 1 takes tile 0 of Q > 64

  if (wg == 0) {
    // y of tiles t_split .. nT - 1
    for (int c = 0; c < nc; ++c) {
      const int s = c % stages;
      uint8_t* st = sm + s * g.stage;
      const uint32_t x_at = smem_u32(st), b_at = x_at + g.atom,
                     c_at = x_at + (1 + kNA) * g.atom;
      const Vec vs = vectors(st, g.vec, g.rows);
      mbar_wait(&bar_full[s], (c / stages) & 1);
      if (c > 0) bar_sync(kBarHReady, kConsumers);
      for (int it = t_split; it < nT; ++it) {
        float yacc[P / 2], gacc[32];
        y_start<P, N>(yacc, gacc, 64 * it, b_at, c_at, h_at, g.atom);
        y_finish<P, N>(yacc, gacc, it, x_at, b_at, c_at, g.atom, vs, Q,
                       yb + (long long)c * Q * ystride, ystride,
                       it == nT - 1 && c + 1 < nc);
      }
      mbar_arrive(&bar_free[s]);
    }
    return;
  }

  // warpgroup 1: the state
  //   h = exp(cs_last) h + (x o dt w)^T . B
  // with x o dt w rounded to bf16 into its own buffer (MN-major A: P along
  // the atom row), B MN-major from the stage, and h in registers; and y of
  // tile 0 when Q > 64, whose C_0 . h_prev is read before h's copy is
  // replaced
  const int lane = threadIdx.x % 32;
  const int r = (threadIdx.x % 128) / 32 * 16 + lane / 4;
  const int cc = 2 * (lane % 4);
  uint8_t* xs = sm + g.xs;
  const uint32_t xs_at = smem_u32(xs);
  float hacc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) hacc[i] = 0.f;
  for (int c = 0; c < nc; ++c) {
    const int s = c % stages;
    uint8_t* st = sm + s * g.stage;
    const uint32_t x_at = smem_u32(st), b_at = x_at + g.atom,
                   c_at = x_at + (1 + kNA) * g.atom;
    const Vec vs = vectors(st, g.vec, g.rows);
    mbar_wait(&bar_full[s], (c / stages) & 1);
    float yacc[P / 2], gacc[32];
    if (t_split > 0) y_start<P, N>(yacc, gacc, 0, b_at, c_at, h_at, g.atom);
    // x_q o dt_q exp(cs_last - cs_q), rounded to bf16 (a row scales as
    // one, whatever the swizzle did to its chunks)
    for (int e = threadIdx.x - 128; e < Q * 8; e += 128) {
      uint4 u = *reinterpret_cast<const uint4*>(st + e * 16);
      __nv_bfloat162* v2 = reinterpret_cast<__nv_bfloat162*>(&u);
      const float f = vs.sw[e / 8];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 t = __bfloat1622float2(v2[k]);
        v2[k] = __floats2bfloat162_rn(t.x * f, t.y * f);
      }
      *reinterpret_cast<uint4*>(xs + e * 16) = u;
    }
    fence_async_smem();
    bar_sync(kBarWG1, 128);
    const float decay = vs.ecs[Q - 1];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) hacc[i] *= decay;
    wg_fence();
    for (int jt = 0; jt < nT; ++jt)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        SS<N, 1, 1>::mma(hacc, desc_mn(xs_at + 64 * jt * 128, kk, g.atom),
                         desc_mn(b_at + 64 * jt * 128, kk, g.atom), 1);
    wg_commit();
    wg_wait<0>();                      // and C_0 . h_prev
    fence_regs(hacc);
    if (c + 1 < nc) {
      // h's bf16 copy, K-major (N along the atom row), once warpgroup 0
      // has read the last one
      bar_sync(kBarHRead, kConsumers);
#pragma unroll
      for (int i = 0; i < N / 8; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = 8 * i + cc, p = r + 8 * j;
          *reinterpret_cast<__nv_bfloat162*>(sm + g.h + (n / 64) * 8192 +
                                             swz(p, n % 64)) =
              __floats2bfloat162_rn(hacc[4 * i + 2 * j], hacc[4 * i + 2 * j + 1]);
        }
      fence_async_smem();
      bar_arrive(kBarHReady, kConsumers);
    }
    if (t_split > 0)
      y_finish<P, N>(yacc, gacc, 0, x_at, b_at, c_at, g.atom, vs, Q,
                     yb + (long long)c * Q * ystride, ystride, false);
    mbar_arrive(&bar_free[s]);
    bar_sync(kBarWG1, 128);            // h's copy and xs settled for WG 1
  }
}

template <int P, int N>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, void* y, int Bsz, int S, int H, int Q,
           cudaStream_t stream) {
  if (Q > kMaxQ) return (int)cudaErrorInvalidValue;
  int stages = kMaxStages;
  while (stages > 1 && geometry(Q, N, stages).total > kMaxSmem) --stages;
  const int smem = geometry(Q, N, stages).total;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tb, tcm;
  const cuuint64_t xdims[4] = {(cuuint64_t)P, (cuuint64_t)H, (cuuint64_t)S,
                               (cuuint64_t)Bsz};
  const cuuint64_t xstr[3] = {(cuuint64_t)P * 2, (cuuint64_t)H * P * 2,
                              (cuuint64_t)S * H * P * 2};
  const cuuint32_t xbox[4] = {64, 1, (cuuint32_t)Q, 1};
  const cuuint64_t bdims[3] = {(cuuint64_t)N, (cuuint64_t)S, (cuuint64_t)Bsz};
  const cuuint64_t bstr[2] = {(cuuint64_t)N * 2, (cuuint64_t)S * N * 2};
  const cuuint32_t bbox[3] = {64, (cuuint32_t)Q, 1};
  int err = make_map_bf16(&tx, x, 4, xdims, xstr, xbox);
  if (err == 0) err = make_map_bf16(&tb, Bm, 3, bdims, bstr, bbox);
  if (err == 0) err = make_map_bf16(&tcm, Cm, 3, bdims, bstr, bbox);
  if (err != 0) return err;
  auto kernel = ssd_tc<P, N>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (long long)Bsz * H;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      tx, tb, tcm, dt, A, (__nv_bfloat16*)y, S, H, Q, stages);
  return (int)cudaGetLastError();
}

template <int P>
int dispatch_n(const void* x, const float* dt, const float* A, const void* Bm,
               const void* Cm, void* y, int Bsz, int S, int H, int N, int Q,
               cudaStream_t st) {
  switch (N) {
    case 16:  return launch<P, 16>(x, dt, A, Bm, Cm, y, Bsz, S, H, Q, st);
    case 32:  return launch<P, 32>(x, dt, A, Bm, Cm, y, Bsz, S, H, Q, st);
    case 64:  return launch<P, 64>(x, dt, A, Bm, Cm, y, Bsz, S, H, Q, st);
    case 128: return launch<P, 128>(x, dt, A, Bm, Cm, y, Bsz, S, H, Q, st);
    default:  return (int)cudaErrorInvalidValue;
  }
}

int dispatch_p(const void* x, const float* dt, const float* A, const void* Bm,
               const void* Cm, void* y, int Bsz, int S, int H, int P, int N,
               int Q, cudaStream_t st) {
  switch (P) {
    case 16: return dispatch_n<16>(x, dt, A, Bm, Cm, y, Bsz, S, H, N, Q, st);
    case 32: return dispatch_n<32>(x, dt, A, Bm, Cm, y, Bsz, S, H, N, Q, st);
    case 64: return dispatch_n<64>(x, dt, A, Bm, Cm, y, Bsz, S, H, N, Q, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tc

// Plain C interface for ctypes. Every tensor is contiguous: x and y
// (B, S, H, P), dt (B, S, H), A (H,), Bm and Cm (B, S, N). dtype 0 is
// float32 (the CUDA-core path), 1 is bf16 (x, Bm, Cm and y 16-byte
// aligned; dt and A are float32): the tensor-core path for Q <= 256, the
// CUDA-core path in bf16 for longer chunks. Q divides S. Launches on
// `stream`, does not synchronise, and returns cudaGetLastError() (or the
// error of the set-up that refused the launch), so a refused launch is
// reported.
extern "C" int ssd_scan_launch(const void* x, const float* dt, const float* A,
                               const void* Bm, const void* Cm, void* y,
                               int Bsz, int S, int H, int P, int N, int Q,
                               int dtype, void* stream) {
  if (Bsz <= 0 || S <= 0 || H <= 0) return (int)cudaGetLastError();
  if (Q <= 0 || S % Q != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return simt::dispatch_p<float>(x, dt, A, Bm, Cm, y, Bsz, S, H, P, N, Q, st);
  if (dtype == 1 && Q > tc::kMaxQ)    // more rows than one TMA box
    return simt::dispatch_p<__nv_bfloat16>(x, dt, A, Bm, Cm, y, Bsz, S, H, P,
                                           N, Q, st);
  if (dtype == 1)
    return tc::dispatch_p(x, dt, A, Bm, Cm, y, Bsz, S, H, P, N, Q, st);
  return (int)cudaErrorInvalidValue;
}
