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
// 3.35 TB/s): bound by the bytes. As written it computes with float32
// FMAs on the CUDA cores (67 TFLOP/s at best) and reads its tiles from
// shared memory, so it sits well above that bound: simple and right
// first; mma/wgmma and pipelined loads are later work.
//
// Design:
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
//     (a run per lane, then shuffles), summed in float64: the decays are
//     exp of differences of cs, which reaches -300 or less within a chunk,
//     where a float32 sum is off by several 1e-5 and every decay near the
//     diagonal would carry that relative error; in float64 the differences
//     are exact to float32 rounding. Rows of a tile past Q are zeros and
//     are not stored, so any Q is taken;
//   * shared memory at P 64: 91 KB at N 64 (two blocks an SM), 140 KB at
//     N 128 (mamba2's state: B and C are staged a 64-row tile at a time,
//     never a whole chunk). At zamba2's shape the grid is B * H = 640
//     blocks over 132 SMs, each walking 16 chunks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

}  // namespace

// Plain C interface for ctypes. Every tensor is contiguous: x and y
// (B, S, H, P), dt (B, S, H), A (H,), Bm and Cm (B, S, N). dtype 0 is
// float32, 1 is bf16 (x, Bm, Cm and y; dt and A are float32). Q divides
// S. Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (or the error of the shared-memory attribute call),
// so a refused launch is reported.
extern "C" int ssd_scan_launch(const void* x, const float* dt, const float* A,
                               const void* Bm, const void* Cm, void* y,
                               int Bsz, int S, int H, int P, int N, int Q,
                               int dtype, void* stream) {
  if (Bsz <= 0 || S <= 0 || H <= 0) return (int)cudaGetLastError();
  if (Q <= 0 || S % Q != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_p<float>(x, dt, A, Bm, Cm, y, Bsz, S, H, P, N, Q, st);
  if (dtype == 1)
    return dispatch_p<__nv_bfloat16>(x, dt, A, Bm, Cm, y, Bsz, S, H, P, N, Q, st);
  return (int)cudaErrorInvalidValue;
}
