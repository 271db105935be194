// Fused RadixSpline lookup: the kernel backend of the RS kind, single-table
// and batched.
//
// Replaces repro/kernels/rs_search.py:fused_rs_search_pallas and
// batched_rs_search_pallas (_rs_body).  One thread per query, from the raw
// encoded query:
//   0. u = clip((q - rk_kmin) * rk_inv_span, 0, 1) in f64, rounded once to
//      f32 (unit_f32 in search_common.cuh, bit for bit the host's
//      keys.unit_f32), and the radix prefix
//      min((max(q, kmin) - kmin) >> shift, top).  The difference is taken
//      as unsigned 64-bit: on the sign-flipped keys it is the uint64
//      difference of the keys, which reaches 2^63 when the key span does,
//      where a signed subtraction would overflow.  A shift of 64 or more
//      gives 0, as a logical shift would.  The TPU kernel took both from
//      outside; here they save the lookup ~8 eager integer kernels and an
//      f64 pass over the queries;
//   1. the radix table at the prefix bounds the knot range:
//      lo_k = max(radix[p] - 1, 0), hi_k = radix[p + 1];
//   2. an upper-bound search of that range over the knot keys finds the
//      enclosing knot j, clamped to [0, m_valid - 2]; the f32 re-anchored
//      spline predicts y1 + slope_j * max(u - u0_j, 0), clamped to +-1e9;
//   3. the prediction's floor and ceil, clamped into [0, n - 1] and widened
//      by eps, bound a search over the table whose result is the
//      predecessor rank.
// Both searches stop once the query's window is one key wide
// (bounded_ub_early): `ksteps` (from the whole knot array) and `steps`
// (from the widest eps-window) are only the caps, so a query makes
// ceil(log2) of its own radix bucket's knots and of its own window.  The
// ranks are a fixed-trip loop's, since a trip at a one-key window is a
// no-op.  Every gather index is clamped into its array: the prefix into
// [0, radix_len - 2], so radix[p + 1] exists, and j into the valid knots.
// The knot ranks, radix table and m_valid are read as the index holds them,
// int64, and narrowed in registers (the wrappers require n < 2^31), so a
// lookup casts nothing.  Every multiply and add is rounded on its own
// (-fmad=false): the re-encoded eps budgets one fused multiply-add only.
// The batched kernel takes its table from blockIdx.y (past 65,535 tables,
// every 65,535th in turn) and runs the same per-query function on that
// table's rows of the stacked leaves and its own kmin, shift, rk_kmin,
// rk_inv_span, m_valid and eps; `ksteps` and `steps` are the max over the
// tables, and r_bits (so radix_len) is common to them.
//
// Bound on the H100: the dependent loads, not the bytes.  The radix table
// (32 KB at the default r_bits 12) and the knots (114-418 KB at 2^24 keys)
// are shared by every query and stay in L2; the table search gathers from
// a window at a random place in a table that, at 2^24 keys, lives in HBM,
// and each of its trips misses L2.  With per-query trips the knot search
// makes about 2 trips (a few knots to a radix bucket) instead of 16; what
// is left is the table search's ceil(log2) of the f32-measured window,
// which on clustered data (osm) is wide.  The plain PyTorch twins are
// rs_search_plain and batched_rs_search_plain in kernels/rs_search.py.

#include "search_common.cuh"

// One table's spline: the encoded knot keys, the f32 rk_* anchors and
// slopes, and the int64 knot ranks and radix table.
struct RsLeaves {
  const long long* knots;
  const float* u0;
  const float* slope;
  const long long* ranks;
  const long long* radix;
};

// min((max(q, kmin) - kmin) >> shift, top) on the unsigned difference.
__device__ __forceinline__ int radix_prefix(long long q, long long kmin, long long shift,
                                            int top) {
  const unsigned long long d =
      (unsigned long long)(q > kmin ? q : kmin) - (unsigned long long)kmin;
  const unsigned long long s = (unsigned long long)shift;
  const unsigned long long p = s < 64ull ? d >> s : 0ull;
  return p < (unsigned long long)top ? (int)p : top;
}

__device__ __forceinline__ int rs_query(long long q, long long kmin, long long shift,
                                        double rk_kmin, double rk_inv_span,
                                        const long long* __restrict__ table, int n,
                                        const RsLeaves& g, int radix_len, int top, int m_valid,
                                        int eps, int ksteps, int steps) {
  const float x = unit_f32(q, rk_kmin, rk_inv_span);

  // stage 1: the radix table bounds the knot range
  const int p = clampi(radix_prefix(q, kmin, shift, top), 0, radix_len - 2);
  const int lo_k = max((int)__ldg(g.radix + p) - 1, 0);
  const int hi_k = (int)__ldg(g.radix + p + 1);
  const int len_k = max(hi_k - lo_k, 1);

  // stage 2: exact knot search, then f32 interpolation from knot j
  const int ub = bounded_ub_early(g.knots, q, lo_k, len_k, ksteps);
  const int j = clampi(ub - 1, 0, max(m_valid - 2, 0));
  const float du = fmaxf(__fsub_rn(x, __ldg(g.u0 + j)), 0.0f);
  const float pred =
      __fadd_rn(__int2float_rn((int)__ldg(g.ranks + j)), __fmul_rn(__ldg(g.slope + j), du));
  // clamp the centre into the table before widening
  const int p_lo = clampi(floor_to_int(pred), 0, n - 1);
  const int p_hi = clampi(ceil_to_int(pred), 0, n - 1);
  const int lo = clampi(p_lo - eps, 0, n - 1);
  const int hi = clampi(p_hi + eps, 0, n - 1);

  // stage 3: the eps-window search over the table
  return bounded_ub_early(table, q, lo, hi - lo + 1, steps) - 1;
}

extern "C" __global__ void rs_search_kernel(
    const long long* __restrict__ queries, long long nq, const long long* __restrict__ kmin,
    const long long* __restrict__ shift, const double* __restrict__ rk_kmin,
    const double* __restrict__ rk_inv_span, const long long* __restrict__ table, int n,
    RsLeaves g, int mk, int radix_len, int top, const long long* __restrict__ m_valid,
    const int* __restrict__ eps, int ksteps, int steps, int* __restrict__ out) {
  const long long i = query_slot(nq);
  if (i < 0) return;
  const int mv = (int)min(m_valid[0], (long long)mk);
  out[i] = rs_query(queries[i], kmin[0], shift[0], rk_kmin[0], rk_inv_span[0], table, n, g,
                    radix_len, top, mv, eps[0], ksteps, steps);
}

// Table t (blockIdx.y, then every gridDim.y-th table past it): row t of the
// (n_tables, n) tables, the (n_tables, mk) knot leaves and the
// (n_tables, radix_len) radix tables; element t of kmin, shift, rk_kmin,
// rk_inv_span, m_valid and eps; row t of the (n_tables, nq) out; queries
// row t at stride q_stride (0 when one batch is broadcast).
extern "C" __global__ void batched_rs_search_kernel(
    const long long* __restrict__ queries, long long q_stride, long long nq, int n_tables,
    const long long* __restrict__ kmin, const long long* __restrict__ shift,
    const double* __restrict__ rk_kmin, const double* __restrict__ rk_inv_span,
    const long long* __restrict__ tables, int n, RsLeaves g, int mk, int radix_len, int top,
    const long long* __restrict__ m_valid, const int* __restrict__ eps, int ksteps, int steps,
    int* __restrict__ out) {
  const long long i = query_slot(nq);
  if (i < 0) return;
  for (long long t = blockIdx.y; t < n_tables; t += gridDim.y) {
    const long long lk = t * mk;
    const RsLeaves mine{g.knots + lk, g.u0 + lk, g.slope + lk, g.ranks + lk,
                        g.radix + t * radix_len};
    const int mv = (int)min(m_valid[t], (long long)mk);
    out[t * nq + i] = rs_query(queries[t * q_stride + i], kmin[t], shift[t], rk_kmin[t],
                               rk_inv_span[t], tables + t * n, n, mine, radix_len, top, mv,
                               eps[t], ksteps, steps);
  }
}

extern "C" int rs_search_launch(const void* queries, long long nq, const void* kmin,
                                const void* shift, const void* rk_kmin, const void* rk_inv_span,
                                const void* table, int n, const void* knots, const void* u0,
                                const void* slope, const void* ranks, int mk, const void* radix,
                                int radix_len, int top, const void* m_valid, const void* eps,
                                int ksteps, int steps, void* out, void* stream) {
  const RsLeaves g{(const long long*)knots, (const float*)u0, (const float*)slope,
                   (const long long*)ranks, (const long long*)radix};
  rs_search_kernel<<<search_grid(nq, 1), kThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)queries, nq, (const long long*)kmin, (const long long*)shift,
      (const double*)rk_kmin, (const double*)rk_inv_span, (const long long*)table, n, g, mk,
      radix_len, top, (const long long*)m_valid, (const int*)eps, ksteps, steps, (int*)out);
  return (int)cudaGetLastError();
}

extern "C" int batched_rs_search_launch(const void* queries, long long q_stride, long long nq,
                                        int n_tables, const void* kmin, const void* shift,
                                        const void* rk_kmin, const void* rk_inv_span,
                                        const void* tables, int n, const void* knots,
                                        const void* u0, const void* slope, const void* ranks,
                                        int mk, const void* radix, int radix_len, int top,
                                        const void* m_valid, const void* eps, int ksteps,
                                        int steps, void* out, void* stream) {
  const RsLeaves g{(const long long*)knots, (const float*)u0, (const float*)slope,
                   (const long long*)ranks, (const long long*)radix};
  batched_rs_search_kernel<<<search_grid(nq, n_tables), kThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)queries, q_stride, nq, n_tables, (const long long*)kmin,
      (const long long*)shift, (const double*)rk_kmin, (const double*)rk_inv_span,
      (const long long*)tables, n, g, mk, radix_len, top, (const long long*)m_valid,
      (const int*)eps, ksteps, steps, (int*)out);
  return (int)cudaGetLastError();
}
