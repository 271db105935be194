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
// One thread walks one row: a whole table (exact form, chunk >= length) or
// one block of `chunk` elements (blocked form), rows in gridDim.x with a
// grid-stride loop, so a batch of tables (and 65,536 or more block rows) is
// one launch.  A row stops at its table's live count (`count`, read on the
// device, so a caller never reads it on the host); the wrapper zero-fills
// the flags, and the kernel writes only the live ones.
//
// The two recurrences, element j of a table (eps per table):
//   PGM (mode 0): x = keys[j], r = j; the carry (x0, s, lo, hi) starts at
//     (0, -1, 0, inf) in every row; lo' = max(lo, (r - s - eps) / (x - x0)),
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
// Bound on the H100: a thread's serial steps, not the bytes.  One thread of
// the exact form walks 2^22 steps in series; each takes two f64 divisions, a
// max, a min, a compare and the selects (the next step's anchor depends on
// this step's flag).  A probe that takes the divisions off that chain but
// issues four a step runs 1.57x slower (corridor_bench.py --probe), so the
// divisions a thread issues, more than the chain's latency, set the step.
// The loads do not depend on the carry, so they are double buffered in
// registers: the next kAhead keys are loaded before the chain walks the
// current kAhead, and their memory latency passes under those steps (H100
// 80GB HBM3 at 700 W, corridor_bench.py: a PGM step went from 207 to 162
// ns; an RS step from 263 to 290 ns with 8 keys a buffer, to 267 with 16).
// The blocked form runs length / chunk rows in parallel.
// The plain PyTorch twin is corridor_scan_twin in kernels/corridor_scan.py.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kAhead = 16;  // keys a register buffer holds (two buffers)

__device__ __forceinline__ double max_nan(double a, double b) {
  return (a > b || a != a) ? a : b;  // NaN in either operand gives NaN
}

__device__ __forceinline__ double min_nan(double a, double b) {
  return (a < b || a != a) ? a : b;
}

struct PgmCarry {
  double x0, s, lo, hi;
};

__device__ __forceinline__ bool pgm_step(PgmCarry& c, double x, double r, double eps) {
  const double dx = x - c.x0;
  const double dy = r - c.s;
  const double new_lo = max_nan(c.lo, (dy - eps) / dx);
  const double new_hi = min_nan(c.hi, (dy + eps) / dx);
  const bool bad = (new_lo > new_hi) || (c.s < 0.0);
  c.x0 = bad ? x : c.x0;
  c.s = bad ? r : c.s;
  c.lo = bad ? 0.0 : new_lo;
  c.hi = bad ? __longlong_as_double(0x7ff0000000000000LL) : new_hi;
  return bad;
}

struct RsCarry {
  double x0, y0, lo, hi;
};

__device__ __forceinline__ bool rs_step(RsCarry& c, double xi, double xp, double r, double eps) {
  const double slope = (r - c.y0) / (xi - c.x0);
  const bool bad = (slope < c.lo) || (slope > c.hi);
  c.x0 = bad ? xp : c.x0;
  c.y0 = bad ? r - 1.0 : c.y0;
  const double dx = xi - c.x0;
  const double dy = r - c.y0;
  const double lo_b = (dy - eps) / dx;
  const double hi_b = (dy + eps) / dx;
  c.lo = bad ? lo_b : max_nan(c.lo, lo_b);
  c.hi = bad ? hi_b : min_nan(c.hi, hi_b);
  return bad;
}

__global__ void corridor_scan_kernel(const double* __restrict__ keys, long long stride,
                                     int n_tables, long long length, long long chunk,
                                     long long n_blocks, int mode,
                                     const double* __restrict__ eps,
                                     const long long* __restrict__ count,
                                     unsigned char* __restrict__ out) {
  const double inf = __longlong_as_double(0x7ff0000000000000LL);
  const long long rows = (long long)n_tables * n_blocks;
  for (long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x; row < rows;
       row += (long long)gridDim.x * blockDim.x) {
    const long long t = row / n_blocks;
    const long long j0 = (row % n_blocks) * chunk;
    long long live = length;
    if (count != nullptr) live = min(live, max(count[t], 0LL));
    const long long j1 = min(j0 + chunk, live);
    if (j0 >= j1) continue;
    const double* k = keys + t * stride;
    unsigned char* f = out + t * length;
    const double e = eps[t];
    long long j = j0;
    // element j reads key j + lead (PGM: 0, RS: 1); the last key a row
    // may read is j1 - 1 + lead, so the next buffer's loads clamp to it
    const long long lead = mode == 0 ? 0 : 1;
    const long long top = j1 - 1 + lead;
    double x[kAhead], nx[kAhead];
    if (j + kAhead <= j1) {
#pragma unroll
      for (int a = 0; a < kAhead; ++a) x[a] = k[j + a + lead];
    }
    if (mode == 0) {
      PgmCarry c{0.0, -1.0, 0.0, inf};
      for (; j + kAhead <= j1; j += kAhead) {
#pragma unroll
        for (int a = 0; a < kAhead; ++a) nx[a] = k[min(j + kAhead + a, top)];
#pragma unroll
        for (int a = 0; a < kAhead; ++a) f[j + a] = pgm_step(c, x[a], (double)(j + a), e);
#pragma unroll
        for (int a = 0; a < kAhead; ++a) x[a] = nx[a];
      }
      for (; j < j1; ++j) f[j] = pgm_step(c, k[j], (double)j, e);
    } else {
      RsCarry c{k[j0], (double)j0, -inf, inf};
      double xp = k[j0];
      for (; j + kAhead <= j1; j += kAhead) {
#pragma unroll
        for (int a = 0; a < kAhead; ++a) nx[a] = k[min(j + kAhead + a + 1, top)];
#pragma unroll
        for (int a = 0; a < kAhead; ++a) {
          f[j + a] = rs_step(c, x[a], xp, (double)(j + a + 1), e);
          xp = x[a];
        }
#pragma unroll
        for (int a = 0; a < kAhead; ++a) x[a] = nx[a];
      }
      for (; j < j1; ++j) {
        const double xi = k[j + 1];
        f[j] = rs_step(c, xi, xp, (double)(j + 1), e);
        xp = xi;
      }
    }
  }
}

}  // namespace

// keys: (n_tables, stride) f64; out: (n_tables, length) bytes, zero-filled by
// the caller; eps: (n_tables,) f64; count: (n_tables,) int64 or null.
// RS reads keys[j + 1], so its length is at most stride - 1.
extern "C" int corridor_scan_launch(const void* keys, long long stride, int n_tables,
                                    long long length, long long chunk, int mode,
                                    const void* eps, const void* count, void* out,
                                    void* stream) {
  if (n_tables <= 0 || length <= 0) return 0;
  const long long n_blocks = (length + chunk - 1) / chunk;
  const long long rows = (long long)n_tables * n_blocks;
  const long long want = (rows + kThreads - 1) / kThreads;
  const long long grid = want < (1LL << 20) ? want : (1LL << 20);
  corridor_scan_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const double*)keys, stride, n_tables, length, chunk, n_blocks, mode,
      (const double*)eps, (const long long*)count, (unsigned char*)out);
  return (int)cudaGetLastError();
}
