// Run algebra of the AREPAS segmented reduction (paper Algorithm 1), shared
// by kernel K1 (skyline.cu) and kernel K3 (cluster_step.cu).
//
// Writing an over-cap second as nt + x (x >= 1), a run of L seconds with
// excess X stretches to floor((L * nt + X) / nt) = L + floor(X / nt)
// seconds, so runtime = valid_len + sum over runs of floor(X_run / nt). A
// Run summarises a stretch of seconds: the excess of its leading and
// trailing over-cap runs (0 when it starts / ends under the cap), the floor
// sum of the runs closed inside it, and whether it is one over-cap run
// throughout. The empty stretch {0, 0, 0, full} is the identity; combining
// is associative, so any split of a skyline gives the same answer.
#pragma once

#include <cuda_runtime.h>

namespace arepas {

struct Run {
  long long head;  // excess of the leading over-cap run (0: starts under)
  long long tail;  // excess of the trailing over-cap run (0: ends under)
  int acc;         // sum of floor(excess / nt) over runs closed inside
  int full;        // 1: one over-cap run throughout, or empty
};

__device__ __forceinline__ Run identity() { return Run{0, 0, 0, 1}; }

__device__ __forceinline__ int floor_div(long long x, int nt) {
  // x >= 0, nt >= 1; 32-bit division when it fits
  if (x <= 0x7fffffffLL) return (int)((unsigned)x / (unsigned)nt);
  return (int)(x / nt);
}

// Fold one more second of usage s (to the right of r) at allocation nt.
__device__ __forceinline__ void push(Run& r, int s, int nt) {
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

// Ordered warp reduction: lane 0 ends with the summary of lanes 0..31 in
// lane order (lane i holds lanes [i, i + 2 * off) after each step).
__device__ __forceinline__ Run warp_combine(Run r, int lane, int nt) {
  for (int off = 1; off < 32; off <<= 1) {
    const Run o = shfl_down(r, off);
    if ((lane & (2 * off - 1)) == 0) r = combine(r, o, nt);
  }
  return r;
}

// Runtime of a whole valid prefix of vlen seconds summarised by `all`.
__device__ __forceinline__ int runtime(const Run& all, int vlen, int nt) {
  int rt = vlen + all.acc + floor_div(all.head, nt);
  if (!all.full) rt += floor_div(all.tail, nt);
  return rt;
}

}  // namespace arepas
