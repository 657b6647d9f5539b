// Run algebra of the AREPAS segmented reduction (paper Algorithm 1), shared
// by kernel K1 (skyline.cu) and kernel K3 (cluster_step.cu). The fold, the
// combine, the ordered warp reduction and the final runtime serve both;
// the 32-bit summary with its precomputed divisor (a run of equal seconds
// folded at once), the broadcast and the L2 read serve K1's redesign and
// suit K3's alike.
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

// floor(x / d) for every 32-bit x by one multiply-high and shifts
// (Granlund and Montgomery's round-up method): the divisor is an
// allocation, the same for a whole fold, so its constants are made once.
struct Divisor {
  unsigned magic;
  unsigned shifts;   // bit 8: the first shift (0 or 1); bits 0-7: the second
};

__device__ __forceinline__ Divisor divisor(int d) {  // d >= 1
  const int l = 32 - __clz(d - 1);                   // ceil(log2 d)
  const unsigned long long m =
      ((1ULL << 32) * ((1ULL << l) - (unsigned long long)d)) / (unsigned)d + 1;
  return Divisor{(unsigned)m, ((l > 0 ? 1u : 0u) << 8) | (unsigned)(l > 0 ? l - 1 : 0)};
}

__device__ __forceinline__ unsigned div32(unsigned x, const Divisor& dv) {
  const unsigned hi = __umulhi(dv.magic, x);
  return (hi + ((x - hi) >> (dv.shifts >> 8))) >> (dv.shifts & 0xffu);
}

// A Run of a few thousand seconds in 32 bits, folded and combined without
// a branch or a call (a 64-bit division in the fold would make the
// compiler keep registers free around it): exact while every excess fits
// in 32 bits. A sum that does not fit sets `wide`, and the caller folds
// and combines the same seconds again with Run and push(), which are
// exact for any skyline.
struct Run32 {
  unsigned head, tail;
  int acc;
  bool full;
};

__device__ __forceinline__ Run32 identity32() { return Run32{0u, 0u, 0, true}; }

// Fold c >= 1 seconds of usage s at once: the same as c push() calls. An
// over-cap second adds its excess to the open run, and c of them add c
// times as much; the first under-cap one closes the run and the rest
// change nothing.
__device__ __forceinline__ void push(Run32& r, int s, int c, int nt,
                                     const Divisor& dv, bool& wide) {
  const bool over = s > nt;
  const unsigned long long t =
      r.tail + (unsigned long long)(unsigned)c * (unsigned)(s - nt);
  wide |= over && (t >> 32) != 0;
  const bool close = !over && !r.full && r.tail != 0u;
  r.acc += close ? (int)div32(r.tail, dv) : 0;
  r.head = (over && r.full) ? (unsigned)t : r.head;  // a full run has head == tail
  r.tail = over ? (unsigned)t : 0u;
  r.full = over && r.full;
}

// combine() on 32-bit summaries, branch-free, the floor by the divisor;
// a sum that does not fit 32 bits sets `wide` (as push() does).
__device__ __forceinline__ Run32 combine(const Run32& a, const Run32& b,
                                         const Divisor& dv, bool& wide) {
  const unsigned long long hsum = (unsigned long long)a.head + b.head;
  const unsigned long long tsum = (unsigned long long)a.tail + b.head;
  wide |= ((a.full ? hsum : tsum) >> 32) != 0;
  Run32 r;
  r.full = a.full && b.full;
  r.head = a.full ? (unsigned)hsum : a.head;
  r.tail = b.full ? (a.full ? (unsigned)hsum : (unsigned)tsum) : b.tail;
  // a full summary has no closed run (acc 0); where neither is full, a's
  // trailing run and b's leading run meet and close inside
  const bool meet = !a.full && !b.full && tsum != 0;
  r.acc = a.acc + b.acc + (meet ? (int)div32((unsigned)tsum, dv) : 0);
  return r;
}

__device__ __forceinline__ Run32 shfl_down(const Run32& r, int off) {
  Run32 o;
  o.head = __shfl_down_sync(0xffffffffu, r.head, off);
  o.tail = __shfl_down_sync(0xffffffffu, r.tail, off);
  o.acc = __shfl_down_sync(0xffffffffu, r.acc, off);
  o.full = __shfl_down_sync(0xffffffffu, (int)r.full, off) != 0;
  return o;
}

__device__ __forceinline__ Run32 shfl_idx(const Run32& r, int src) {
  Run32 o;
  o.head = __shfl_sync(0xffffffffu, r.head, src);
  o.tail = __shfl_sync(0xffffffffu, r.tail, src);
  o.acc = __shfl_sync(0xffffffffu, r.acc, src);
  o.full = __shfl_sync(0xffffffffu, (int)r.full, src) != 0;
  return o;
}

// runtime() of a 32-bit summary, the floors by the divisor.
__device__ __forceinline__ int runtime(const Run32& all, int vlen,
                                       const Divisor& dv) {
  return vlen + all.acc + (int)div32(all.head, dv) +
         (all.full ? 0 : (int)div32(all.tail, dv));
}

__device__ __forceinline__ Run widen(const Run32& r) {
  return Run{(long long)r.head, (long long)r.tail, r.acc, r.full ? 1 : 0};
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

// Lane `src`'s summary, on every lane.
__device__ __forceinline__ Run shfl_idx(const Run& r, int src) {
  Run o;
  o.head = __shfl_sync(0xffffffffu, r.head, src);
  o.tail = __shfl_sync(0xffffffffu, r.tail, src);
  o.acc = __shfl_sync(0xffffffffu, r.acc, src);
  o.full = __shfl_sync(0xffffffffu, r.full, src);
  return o;
}

// A summary another block wrote (after __threadfence and an atomic that
// ordered it before this read): read through L2, never a stale L1 line.
__device__ __forceinline__ Run load_cg(const Run* p) {
  Run o;
  o.head = __ldcg(&p->head);
  o.tail = __ldcg(&p->tail);
  o.acc = __ldcg(&p->acc);
  o.full = __ldcg(&p->full);
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
