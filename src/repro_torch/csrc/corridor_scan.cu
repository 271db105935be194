// Greedy epsilon-corridor scan: the sequential recurrence behind the device
// fits of PGM (the anchored cone) and RadixSpline (GreedySplineCorridor).
//
// Replaces the reference's lax.scan of the corridor step:
// repro/core/cdf.py:chunked_corridor_scan (the exact form, :170) and
// blocked_corridor_scan (the vmapped blocks of the fast fit, :121), over
// repro/core/pgm.py:_pgm_corridor_step and
// repro/core/radix_spline.py:_rs_corridor_step.  The reference has no
// Pallas kernel here; PyTorch has no scan, and in eager code each step would
// be ~15 launches, so one exact fit of 2^22 keys would take minutes.
//
// The two recurrences, element j of a table (eps per table):
//   PGM (mode 0): x = keys[j], r = j; the carry (x0, s, lo, hi) starts at
//     (0, -1, 0, inf); lo' = max(lo, (r - s - eps) / (x - x0)),
//     hi' = min(hi, (r - s + eps) / (x - x0)); the element starts a segment
//     (flag, re-anchor at (x, r, 0, inf)) when lo' > hi' or s < 0.
//   RS (mode 1): xi = keys[j + 1], xp = keys[j], r = j + 1; the carry
//     (x0, y0, lo, hi) starts at (keys[j0], j0, -inf, inf) at the row's first
//     element j0; slope = (r - y0) / (xi - x0) outside [lo, hi] flags knot j
//     and re-anchors at (xp, r - 1); then the cone takes the point's bounds.
// The arithmetic is the reference's f64, rounded operation by operation
// (-fmad=false; IEEE division).  max and min propagate NaN, as jnp.maximum
// and jnp.minimum do (fmax/fmin would drop it): keys that collide in f64
// give dx = 0, and a NaN cone must stay NaN so the fit's verified-eps check
// vetoes it.
//
// Two kernels.
//
// corridor_blocked_kernel (the fast fit's blocks, and the one-thread walk of
// a whole row with chunk >= length, the exact form's oracle): one thread
// walks one row of `chunk` elements from a fresh carry.  A block of 128 rows
// stages its keys in shared memory, 16 a row at a time, double buffered
// with cp.async: a half-warp copies one row's 16 keys (128 contiguous
// bytes), where a thread's own loads would touch 32 lines a warp
// instruction (rows lie `chunk` keys apart).  A staged row takes 17 f64
// words, so the 16 threads of a half-warp reading their rows' key a hit 16
// different bank pairs.  The flags go out the same way: packed in shared
// memory, then written by 16 lanes a row piece.
//
// corridor_exact_kernel (the exact fit, one cooperative launch, no host
// sync): three phases over chunks of C elements, split by grid barriers.
//   1. Speculate: every chunk walked from a fresh carry, as the blocked
//      kernel walks its rows; its flags into `out`, its end carry into
//      scratch.
//   2. Correct: every chunk but a row's first walked again from its
//      predecessor's speculative end carry, rewriting the flags, until the
//      two walks flag the same element (for RS, the chunk's first element
//      counts as flagged by the speculative walk).  After a flag at p the
//      carry depends on p alone (PGM: (x_p, p, 0, inf); RS: (keys[p], p)
//      and point p + 1's bounds), and a fresh start at j0 leaves exactly
//      that carry after j0 (PGM flags j0 since s < 0; RS's start is a knot's
//      carry without the flag), so from there the two walks agree.  The
//      chunk is "synced", or not, with its end carry.
//   3. Resolve: one block a row.  Chunk 0 starts from the true carry; while
//      chunks are synced the flags are exact by induction.  From each chunk
//      that did not sync, the next chunks are walked again from the true
//      carry until the walk flags an element that `out` also flags (the
//      same argument), then the row is scanned on.  A row whose cone turns
//      NaN never flags again, never syncs, and is walked to its end.
// Every walk of the three phases is one block's, cooperative: 512 threads
// hold a window of 4,096 elements, 8 a thread, staged in shared memory (the
// next window's copy runs under this one's walk).  Under a fixed anchor the
// cone's bounds are prefix maxima and minima of per-element quotients, which
// a block computes at once: each thread its 8 quotients and their max/min,
// a block scan gives each thread the bounds before its elements, and the
// first element whose test fails (PGM: the running lo above hi; RS: the
// slope outside the bounds before it) ends the segment; the block re-anchors
// there and goes on.  max and min pick one of their operands, so any grouping
// gives the serial walk's bits (NaN absorbs either way).  PGM's bounds only
// tighten, so a span whose totals do not cross holds no flag: it is decided
// on block totals alone.  A chunk of 4,096 (one window) lets the walks of
// short segments (hundreds of keys) meet within a chunk; a chunk of 256 walked
// by one thread, 256 serial steps, did not (PERF.md).
//
// Bound on the H100.  The bytes (each key read once, a flag byte written)
// take 0.045 ms for 4 x 2^22 keys.  The exact form's data decide the rest:
// segments of amzn64 at eps 64 run 4,000-10,000 keys, so the walks meet
// almost nowhere and phase 3 walks each whole row on one SM: two (PGM) or
// three (RS) f64 divisions an element, which the SM issues at ~2 a cycle,
// plus a block round a segment.
// The plain PyTorch twins are corridor_scan_twin and corridor_scan_exact_twin
// in kernels/corridor_scan.py.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kStage = 16;                  // keys a row stages a step of the blocked kernel
constexpr int kPad = kStage + 1;            // f64 words a staged row takes (bank spread)
constexpr int kFlagWords = kStage / 4 + 1;  // words a row's staged flags take (+1 pad)
constexpr int kBlockedThreads = 128;
constexpr int kExactThreads = 512;
constexpr int kWarps = kExactThreads / 32;
constexpr int kWalk = 8;           // consecutive elements a thread holds in a cooperative walk
constexpr int kWindow = kExactThreads * kWalk;
constexpr int kWinWords = kWindow + kWindow / kWalk + 2;  // a staged window of kWindow + 1 keys
constexpr int kMinSpan = 512;      // the least span of a walk's round after a flag
constexpr unsigned kNone = 0xffffffffu;

__device__ __forceinline__ double inf_d() { return __longlong_as_double(0x7ff0000000000000LL); }

__device__ __forceinline__ double max_nan(double a, double b) {
  return (a > b || a != a) ? a : b;  // NaN in either operand gives NaN
}

__device__ __forceinline__ double min_nan(double a, double b) {
  return (a < b || a != a) ? a : b;
}

// PGM: (x0, s, lo, hi); RS: (x0, y0, lo, hi)
struct Carry {
  double x0, y0, lo, hi;
};

template <int MODE>
__device__ __forceinline__ Carry fresh(const double* k, long long j0) {
  if (MODE == 0) return Carry{0.0, -1.0, 0.0, inf_d()};
  return Carry{k[j0], (double)j0, -inf_d(), inf_d()};
}

// One step of element j: PGM x = keys[j], r = j (xp unused); RS x = keys[j + 1],
// xp = keys[j], r = j + 1.  Returns the flag.
template <int MODE>
__device__ __forceinline__ bool step(Carry& c, double x, double xp, double r, double eps) {
  if (MODE == 0) {
    const double dx = x - c.x0;
    const double dy = r - c.y0;
    const double new_lo = max_nan(c.lo, (dy - eps) / dx);
    const double new_hi = min_nan(c.hi, (dy + eps) / dx);
    const bool bad = (new_lo > new_hi) || (c.y0 < 0.0);
    c.x0 = bad ? x : c.x0;
    c.y0 = bad ? r : c.y0;
    c.lo = bad ? 0.0 : new_lo;
    c.hi = bad ? inf_d() : new_hi;
    return bad;
  }
  const double slope = (r - c.y0) / (x - c.x0);
  const bool bad = (slope < c.lo) || (slope > c.hi);
  c.x0 = bad ? xp : c.x0;
  c.y0 = bad ? r - 1.0 : c.y0;
  const double dx = x - c.x0;
  const double dy = r - c.y0;
  const double lo_b = (dy - eps) / dx;
  const double hi_b = (dy + eps) / dx;
  c.lo = bad ? lo_b : max_nan(c.lo, lo_b);
  c.hi = bad ? hi_b : min_nan(c.hi, hi_b);
  return bad;
}

struct Rows {
  const double* keys;
  long long stride;
  int n_tables;
  long long length;
  long long chunk;
  long long n_chunks;  // chunks a table: ceil(length / chunk)
  const double* eps;
  const long long* count;
  unsigned char* out;
};

__device__ __forceinline__ long long live_of(const Rows& R, int t) {
  long long live = R.length;
  if (R.count != nullptr) live = min(live, max(R.count[t], 0LL));
  return live;
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void store_carry(double* dst, const Carry& c) {
  dst[0] = c.x0;
  dst[1] = c.y0;
  dst[2] = c.lo;
  dst[3] = c.hi;
}

__device__ __forceinline__ Carry load_carry(const double* src) {
  return Carry{src[0], src[1], src[2], src[3]};
}

constexpr size_t kTileSmem = sizeof(double) * 2 * kBlockedThreads * kPad +
                             sizeof(unsigned) * kBlockedThreads * kFlagWords +
                             sizeof(long long) * 2 * kBlockedThreads + sizeof(int) * kBlockedThreads;

// One tile of the blocked kernel: TPB rows (row g = t * n_chunks + c, one a
// thread) walked from a fresh carry with staged keys, every flag written
// (staged too).
template <int MODE>
__device__ void tile_walk(const Rows& R, long long g0, long long rows, char* smem) {
  constexpr int TPB = kBlockedThreads;
  double* sk = reinterpret_cast<double*>(smem);
  unsigned* sf = reinterpret_cast<unsigned*>(sk + 2 * TPB * kPad);
  long long* koff = reinterpret_cast<long long*>(sf + TPB * kFlagWords);
  long long* foff = koff + TPB;
  int* slen = reinterpret_cast<int*>(foff + TPB);
  const int tid = threadIdx.x;
  const long long g = g0 + tid;
  int t = 0;
  long long j0 = 0;
  int len = 0;
  if (g < rows) {
    t = (int)(g / R.n_chunks);
    j0 = (g % R.n_chunks) * R.chunk;
    const long long j1 = min(j0 + R.chunk, live_of(R, t));
    len = j1 > j0 ? (int)(j1 - j0) : 0;
  }
  koff[tid] = (long long)t * R.stride + j0 + MODE;  // element j reads key j + MODE
  foff[tid] = (long long)t * R.length + j0;
  slen[tid] = len;
  const double* k = R.keys + (long long)t * R.stride;
  double e = 0.0, xp = 0.0;
  Carry c{0.0, 0.0, 0.0, 0.0};
  const bool active = len > 0;
  if (active) {
    e = R.eps[t];
    xp = k[j0];
    c = fresh<MODE>(k, j0);
  }
  __syncthreads();

  auto issue = [&](int s) {
    double* buf = sk + (s & 1) * TPB * kPad;
    for (int idx = tid; idx < TPB * kStage; idx += TPB) {
      const int i = idx / kStage, a = idx % kStage;
      const int el = s * kStage + a;
      if (el < slen[i]) cp_async8(buf + i * kPad + a, R.keys + koff[i] + el);
    }
    cp_async_commit();
  };

  issue(0);
  for (int s = 0;; ++s) {
    // also the barrier that frees the staged flags and buffer (s + 1) & 1
    if (!__syncthreads_or(active && s * kStage < len)) break;
    issue(s + 1);
    cp_async_wait<1>();
    __syncthreads();
    const double* row = sk + (s & 1) * TPB * kPad + tid * kPad;
    unsigned words[kStage / 4] = {};
#pragma unroll
    for (int a = 0; a < kStage; ++a) {
      const int j = s * kStage + a;
      if (active && j < len) {
        const double x = row[a];
        const bool flag = step<MODE>(c, x, xp, (double)(j0 + j + MODE), e);
        xp = x;
        words[a / 4] |= (unsigned)flag << (8 * (a % 4));
      }
    }
#pragma unroll
    for (int w = 0; w < kStage / 4; ++w) sf[tid * kFlagWords + w] = words[w];
    __syncthreads();
    for (int idx = tid; idx < TPB * kStage; idx += TPB) {
      const int i = idx / kStage, a = idx % kStage;
      const int el = s * kStage + a;
      if (el < slen[i])
        R.out[foff[i] + el] = (unsigned char)((sf[i * kFlagWords + a / 4] >> (8 * (a % 4))) & 1u);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the row table and buffers are reused by the next tile
}

// The exact kernel's dynamic shared memory: a walk's two windows.
constexpr size_t kExactSmem = 2 * kWinWords * sizeof(double);

template <int MODE>
__global__ void __launch_bounds__(kBlockedThreads) corridor_blocked_kernel(Rows R) {
  extern __shared__ __align__(16) char smem[];
  const long long rows = (long long)R.n_tables * R.n_chunks;
  const long long tiles = (rows + kBlockedThreads - 1) / kBlockedThreads;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x)
    tile_walk<MODE>(R, tile * kBlockedThreads, rows, smem);
}

struct WalkShared {
  long long wa[kWarps], wb[kWarps];  // each warp's (max, min), inclusive scan or total
  unsigned wv[kWarps];
  Carry c;
  int met;
  unsigned long long first;
};

// Phase 3 scans the cone's bounds as int64 keys, an order-preserving map of
// the f64 values (-0 taken as +0: the two compare equal), with NaN mapped to
// the key that absorbs: the largest for a lower bound (max), the smallest for
// an upper bound (min).  The integer max/min pick the operand the f64
// max_nan/min_nan would (up to the sign of a zero and the bits of a NaN,
// which no test sees), and cost the SM's integer units, not its f64 pipe.
constexpr long long kLoNan = 0x7fffffffffffffffLL;
constexpr long long kHiNan = -0x7fffffffffffffffLL - 1;

__device__ __forceinline__ long long order_key(double x) {
  const long long b = __double_as_longlong(x + 0.0);  // -0 + 0 = +0
  return b ^ ((b >> 63) & 0x7fffffffffffffffLL);
}

__device__ __forceinline__ long long lo_key(double x) { return x != x ? kLoNan : order_key(x); }

__device__ __forceinline__ long long hi_key(double x) { return x != x ? kHiNan : order_key(x); }

__device__ __forceinline__ double from_key(long long k, long long nan_key) {
  return k == nan_key ? __longlong_as_double(0x7ff8000000000000LL)
                      : __longlong_as_double(k ^ ((k >> 63) & 0x7fffffffffffffffLL));
}

// The max (min) of a 64-bit key over the warp: the high words' max (min),
// then the low words' among the lanes that hold it.
__device__ __forceinline__ long long warp_max64(long long v) {
  const int hi = (int)(v >> 32);
  const int mhi = __reduce_max_sync(0xffffffffu, hi);
  const unsigned mlo = __reduce_max_sync(0xffffffffu, hi == mhi ? (unsigned)v : 0u);
  return (long long)(((unsigned long long)(unsigned)mhi << 32) | mlo);
}

__device__ __forceinline__ long long warp_min64(long long v) {
  const int hi = (int)(v >> 32);
  const int mhi = __reduce_min_sync(0xffffffffu, hi);
  const unsigned mlo = __reduce_min_sync(0xffffffffu, hi == mhi ? (unsigned)v : 0xffffffffu);
  return (long long)(((unsigned long long)(unsigned)mhi << 32) | mlo);
}

// Shared-memory word of window element e: one pad word every kWalk keys, so
// the 16 threads of a half-warp reading their a-th key hit 16 bank pairs.
__device__ __forceinline__ int win_word(int e) { return e + e / kWalk; }

// Copy keys w0 .. w1 - 1 + MODE of a row into a window buffer (one group).
template <int MODE>
__device__ __forceinline__ void stage_window(const double* k, long long w0, long long w1,
                                             double* buf) {
  const int n = (int)(w1 - w0) + MODE;
  for (int e = threadIdx.x; e < n; e += kExactThreads) cp_async8(buf + win_word(e), k + w0 + e);
  cp_async_commit();
}

// Inclusive scan over the block's warps of each warp's (max, min) keys in
// sh.wa/wb: every warp reads the kWarps totals, lane l scans through warp l.
// Returns the keys before warp `warp` in (pa, pb) and the block's totals in
// (ta, tb), each seeded with (lo, hi).
__device__ __forceinline__ void warp_prefix(const WalkShared& sh, int lane, int warp, long long lo,
                                            long long hi, long long& pa, long long& pb,
                                            long long& ta, long long& tb) {
  long long a = lane < kWarps ? sh.wa[lane] : kHiNan;
  long long b = lane < kWarps ? sh.wb[lane] : kLoNan;
#pragma unroll
  for (int off = 1; off < kWarps; off <<= 1) {
    const long long oa = __shfl_up_sync(0xffffffffu, a, off);
    const long long ob = __shfl_up_sync(0xffffffffu, b, off);
    if (lane >= off) {
      a = max(oa, a);
      b = min(ob, b);
    }
  }
  const long long ea = __shfl_sync(0xffffffffu, a, warp > 0 ? warp - 1 : 0);
  const long long eb = __shfl_sync(0xffffffffu, b, warp > 0 ? warp - 1 : 0);
  pa = warp > 0 ? max(lo, ea) : lo;
  pb = warp > 0 ? min(hi, eb) : hi;
  ta = max(lo, __shfl_sync(0xffffffffu, a, kWarps - 1));
  tb = min(hi, __shfl_sync(0xffffffffu, b, kWarps - 1));
}

// The cooperative walk of row t over elements [start, stop) from the carry
// `c`, rewriting the flags in `out`, until it flags an element `out` flags too
// (with `first_counts`, also its first element, which a fresh start anchors:
// RS's speculative walk leaves a knot's carry there without the flag): returns
// that element (c is then stale), or `stop` (c the carry after stop - 1).  Keys come in windows of kWindow elements
// (staged in `wbuf`, the next one copied while this one is walked); a round
// tests a span of the window under one anchor: twice the last segment's length
// after a flag (at least kMinSpan), doubled after each span without one, so
// short segments do not pay for a whole window a round.
template <int MODE>
__device__ long long walk(const Rows& R, int t, Carry& c, long long start, long long stop,
                          bool first_counts, WalkShared& sh, double* wbuf) {
  const double* k = R.keys + (long long)t * R.stride;
  unsigned char* f = R.out + (long long)t * R.length;
  const double e = R.eps[t];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int my = tid * kWalk;  // my first element, relative to the window
  if (start >= stop) return stop;
  stage_window<MODE>(k, start, min(start + (long long)kWindow, stop), wbuf);
  long long klo = lo_key(c.lo), khi = hi_key(c.hi);
  long long seg = start;  // where the current anchor's segment began
  int span = kWindow;
  int b = 0;
  for (long long w0 = start; w0 < stop; w0 += kWindow, b ^= 1) {
    const long long w1 = min(w0 + (long long)kWindow, stop);
    unsigned wf = 0;  // bit a: `out` flags my element a
#pragma unroll
    for (int a = 0; a < kWalk; ++a) wf |= (unsigned)(w0 + my + a < w1 && f[w0 + my + a] != 0) << a;
    if (w1 < stop)  // the next window's keys load under this one's walk
      stage_window<MODE>(k, w1, min(w1 + (long long)kWindow, stop), wbuf + (b ^ 1) * kWinWords);
    else
      cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const double* xs = wbuf + b * kWinWords;
    const double r0 = (double)(w0 + my + MODE);  // my first element's rank (+ a: exact)
    long long sub = w0;  // the first element the current anchor has not seen
    while (sub < w1) {
      const long long end = min(w1, sub + span);  // this round's span [sub, end)
      // the keys of the cone's bounds each of my elements adds under the anchor
      // (and, for RS, of its slope: bit a of `snan` marks a NaN slope)
      long long ta[kWalk], tb[kWalk], ts[kWalk];
      unsigned snan = 0;
      long long ia = kHiNan, ib = kLoNan;
#pragma unroll
      for (int a = 0; a < kWalk; ++a) {
        const long long j = w0 + my + a;
        ta[a] = kHiNan;
        tb[a] = kLoNan;
        ts[a] = 0;
        if (j >= sub && j < end) {
          const double dx = xs[win_word(my + a + MODE)] - c.x0;
          const double dy = (r0 + (double)a) - c.y0;
          if (MODE == 1) {
            const double slope = dy / dx;
            ts[a] = order_key(slope);
            snan |= (unsigned)(slope != slope) << a;
          }
          ta[a] = lo_key((dy - e) / dx);
          tb[a] = hi_key((dy + e) / dx);
        }
        ia = max(ia, ta[a]);
        ib = min(ib, tb[a]);
      }
      if (MODE == 0) {
        // PGM's bounds only tighten, so without a NaN the span holds a flag
        // iff its totals cross: decide on the totals first
        const long long wa = warp_max64(ia), wb = warp_min64(ib);
        if (lane == 0) {
          sh.wa[warp] = wa;
          sh.wb[warp] = wb;
        }
        __syncthreads();
        const long long Ta = max(klo, warp_max64(lane < kWarps ? sh.wa[lane] : kHiNan));
        const long long Tb = min(khi, warp_min64(lane < kWarps ? sh.wb[lane] : kLoNan));
        __syncthreads();  // sh.wa/wb are read before the scan writes them
        if (c.y0 >= 0.0 &&
            (klo == kLoNan || khi == kHiNan || (Ta != kLoNan && Tb != kHiNan && Ta <= Tb))) {
#pragma unroll
          for (int a = 0; a < kWalk; ++a) {
            const long long j = w0 + my + a;
            if (j >= sub && j < end && (wf >> a & 1u)) f[j] = 0;
          }
          if (klo != kLoNan && khi != kHiNan) {  // a NaN bound stays NaN: no flag again
            klo = Ta;
            khi = Tb;
          }
          sub = end;
          span = min(2 * span, kWindow);
          continue;
        }
      }
      // inclusive warp scan of the threads' (max, min) in element order
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const long long oa = __shfl_up_sync(0xffffffffu, ia, off);
        const long long ob = __shfl_up_sync(0xffffffffu, ib, off);
        if (lane >= off) {
          ia = max(oa, ia);
          ib = min(ob, ib);
        }
      }
      const long long ea = __shfl_up_sync(0xffffffffu, ia, 1);
      const long long eb = __shfl_up_sync(0xffffffffu, ib, 1);
      if (lane == 31) {
        sh.wa[warp] = ia;
        sh.wb[warp] = ib;
      }
      __syncthreads();
      long long lo, hi, tot_a, tot_b;
      warp_prefix(sh, lane, warp, klo, khi, lo, hi, tot_a, tot_b);
      if (lane > 0) {
        lo = max(lo, ea);
        hi = min(hi, eb);
      }
      unsigned v = kNone;
#pragma unroll
      for (int a = 0; a < kWalk; ++a) {
        const long long j = w0 + my + a;
        if (v == kNone && j >= sub && j < end) {
          if (MODE == 0) {  // the bounds after this element cross (NaN: never)
            lo = max(lo, ta[a]);
            hi = min(hi, tb[a]);
            if ((lo > hi && lo != kLoNan && hi != kHiNan) || c.y0 < 0.0) v = (unsigned)(my + a);
          } else {  // the slope leaves the bounds before this element (NaN: never)
            if (!(snan >> a & 1u) &&
                ((lo != kLoNan && ts[a] < lo) || (hi != kHiNan && ts[a] > hi)))
              v = (unsigned)(my + a);
            lo = max(lo, ta[a]);
            hi = min(hi, tb[a]);
          }
        }
      }
      v = __reduce_min_sync(0xffffffffu, v);
      if (lane == 0) sh.wv[warp] = v;
      __syncthreads();
      const unsigned vmin = __reduce_min_sync(0xffffffffu, lane < kWarps ? sh.wv[lane] : kNone);
      const long long vj = vmin == kNone ? end : w0 + vmin;
#pragma unroll
      for (int a = 0; a < kWalk; ++a) {
        const long long j = w0 + my + a;
        if (j >= sub && j < vj && (wf >> a & 1u)) f[j] = 0;
      }
      if (vmin == kNone) {
        klo = tot_a;
        khi = tot_b;
        sub = end;
        span = min(2 * span, kWindow);
        continue;
      }
      if ((int)(vmin / kWalk) == tid) {  // the owner re-anchors at vj
        const int rel = (int)vmin;
        Carry n;
        if (MODE == 0) {
          n = Carry{xs[win_word(rel)], (double)vj, 0.0, inf_d()};
        } else {
          const double r = (double)(vj + 1);
          n.x0 = xs[win_word(rel)];
          n.y0 = r - 1.0;
          const double dx = xs[win_word(rel + 1)] - n.x0;
          const double dy = r - n.y0;
          n.lo = (dy - e) / dx;
          n.hi = (dy + e) / dx;
        }
        const bool flagged = (wf >> (rel - my)) & 1u;
        sh.c = n;
        sh.met = flagged || (first_counts && vj == start);
        if (!flagged) f[vj] = 1;
      }
      __syncthreads();
      c = sh.c;
      klo = lo_key(c.lo);
      khi = hi_key(c.hi);
      if (sh.met) {
        cp_async_wait<0>();
        __syncthreads();  // everyone has read sh, and the prefetch landed, before reuse
        return vj;
      }
      span = (int)min((long long)kWindow, max((long long)kMinSpan, 2 * (vj + 1 - seg)));
      seg = vj + 1;
      sub = vj + 1;
    }
    __syncthreads();  // the window is read before the next prefetch overwrites it
  }
  c.lo = from_key(klo, kLoNan);
  c.hi = from_key(khi, kHiNan);
  cp_async_wait<0>();
  __syncthreads();
  return stop;
}

// Phase 3 for row t: walk each run of chunks that follows a chunk that did
// not sync, from the true carry, until it meets `out`'s flags.
template <int MODE>
__device__ void resolve_row(const Rows& R, int t, const double* corr, const unsigned char* synced,
                            WalkShared& sh, double* wbuf) {
  const long long live = live_of(R, t);
  const long long nc = (live + R.chunk - 1) / R.chunk;
  const long long base = (long long)t * R.n_chunks;
  const int tid = threadIdx.x;
  long long g = 1;
  while (g < nc) {
    // the first chunk >= g that did not sync
    long long u = nc;
    for (long long b = g; b < nc; b += kExactThreads) {
      if (tid == 0) sh.first = (unsigned long long)nc;
      __syncthreads();
      const long long idx = b + tid;
      if (idx < nc && !synced[base + idx]) atomicMin(&sh.first, (unsigned long long)idx);
      __syncthreads();
      u = (long long)sh.first;
      __syncthreads();
      if (u < nc) break;
    }
    if (u >= nc) return;
    Carry c = load_carry(corr + 4 * (base + u));
    g = u + 1;
    bool chain = true;
    while (chain && g < nc) {
      const long long met = walk<MODE>(R, t, c, g * R.chunk, live, false, sh, wbuf);
      if (met >= live) return;
      g = met / R.chunk;
      if (synced[base + g]) {
        chain = false;  // its end carry is the speculative one: the next chunk's start
      } else {
        c = load_carry(corr + 4 * (base + g));
      }
      g += 1;
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(kExactThreads, 1)
    corridor_exact_kernel(Rows R, double* ends, double* corr, unsigned char* synced) {
  extern __shared__ __align__(16) char smem[];
  __shared__ WalkShared sh;
  double* wbuf = reinterpret_cast<double*>(smem);
  cg::grid_group grid = cg::this_grid();
  const long long rows = (long long)R.n_tables * R.n_chunks;
  // 1. speculate: every chunk from a fresh carry, its end carry kept
  for (long long g = blockIdx.x; g < rows; g += gridDim.x) {
    const int t = (int)(g / R.n_chunks);
    const long long j0 = (g % R.n_chunks) * R.chunk;
    const long long j1 = min(j0 + R.chunk, live_of(R, t));
    if (j0 >= j1) continue;
    Carry c = fresh<MODE>(R.keys + (long long)t * R.stride, j0);
    walk<MODE>(R, t, c, j0, j1, false, sh, wbuf);
    if (threadIdx.x == 0) store_carry(ends + 4 * g, c);
  }
  grid.sync();
  // 2. correct: every chunk but a row's first from its predecessor's end
  // carry, until the two walks meet (synced) or the chunk ends
  for (long long g = blockIdx.x; g < rows; g += gridDim.x) {
    const int t = (int)(g / R.n_chunks);
    const long long j0 = (g % R.n_chunks) * R.chunk;
    const long long j1 = min(j0 + R.chunk, live_of(R, t));
    if (j0 == 0 || j0 >= j1) continue;
    Carry c = load_carry(ends + 4 * (g - 1));
    const long long met = walk<MODE>(R, t, c, j0, j1, MODE == 1, sh, wbuf);
    if (threadIdx.x == 0) {
      synced[g] = met < j1;
      if (met >= j1) store_carry(corr + 4 * g, c);
    }
  }
  grid.sync();
  // 3. resolve, one block a row
  for (int t = blockIdx.x; t < R.n_tables; t += gridDim.x) resolve_row<MODE>(R, t, corr, synced, sh, wbuf);
}

Rows make_rows(const void* keys, long long stride, int n_tables, long long length, long long chunk,
               const void* eps, const void* count, void* out) {
  return Rows{(const double*)keys, stride, n_tables, length, chunk, (length + chunk - 1) / chunk,
              (const double*)eps, (const long long*)count, (unsigned char*)out};
}

}  // namespace

// keys: (n_tables, stride) f64; out: (n_tables, length) bytes, zero-filled by
// the caller; eps: (n_tables,) f64; count: (n_tables,) int64 or null.
// RS reads keys[j + 1], so its length is at most stride - 1.  A fresh carry
// every `chunk` elements (chunk >= length: one row a table).
extern "C" int corridor_scan_launch(const void* keys, long long stride, int n_tables,
                                    long long length, long long chunk, int mode,
                                    const void* eps, const void* count, void* out,
                                    void* stream) {
  if (n_tables <= 0 || length <= 0) return 0;
  const Rows R = make_rows(keys, stride, n_tables, length, chunk, eps, count, out);
  const long long tiles = ((long long)n_tables * R.n_chunks + kBlockedThreads - 1) / kBlockedThreads;
  const unsigned grid = (unsigned)(tiles < (1LL << 20) ? tiles : (1LL << 20));
  const size_t smem = kTileSmem;
  if (mode == 0)
    corridor_blocked_kernel<0><<<grid, kBlockedThreads, smem, (cudaStream_t)stream>>>(R);
  else
    corridor_blocked_kernel<1><<<grid, kBlockedThreads, smem, (cudaStream_t)stream>>>(R);
  return (int)cudaGetLastError();
}

// The exact form: the same operands as corridor_scan_launch with `chunk` the
// speculation's chunk, and `scratch`: n_tables * ceil(length / chunk) chunks
// of two carries (8 f64) and a sync byte, 8-byte aligned, no fill needed.
// One cooperative launch: the grid holds as many blocks as fit on the card at
// once.
extern "C" int corridor_exact_launch(const void* keys, long long stride, int n_tables,
                                     long long length, long long chunk, int mode,
                                     const void* eps, const void* count, void* scratch, void* out,
                                     void* stream) {
  if (n_tables <= 0 || length <= 0) return 0;
  Rows R = make_rows(keys, stride, n_tables, length, chunk, eps, count, out);
  const long long rows = (long long)n_tables * R.n_chunks;
  double* ends = (double*)scratch;
  double* corr = ends + 4 * rows;
  unsigned char* synced = (unsigned char*)(corr + 4 * rows);
  void (*kernel)(Rows, double*, double*, unsigned char*) =
      mode == 0 ? corridor_exact_kernel<0> : corridor_exact_kernel<1>;
  const size_t smem = kExactSmem;
  cudaError_t rc = cudaFuncSetAttribute((const void*)kernel,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return (int)rc;
  int per_sm = 0, dev = 0, sms = 0;
  if ((rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kExactThreads, smem)) !=
      cudaSuccess)
    return (int)rc;
  if ((rc = cudaGetDevice(&dev)) != cudaSuccess) return (int)rc;
  if ((rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)rc;
  const long long want = rows > n_tables ? rows : n_tables;
  const long long cap = (long long)per_sm * sms;
  const unsigned grid = (unsigned)(want < cap ? want : cap);
  void* args[] = {&R, &ends, &corr, &synced};
  rc = cudaLaunchCooperativeKernel((const void*)kernel, grid, kExactThreads, args, smem,
                                   (cudaStream_t)stream);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}
