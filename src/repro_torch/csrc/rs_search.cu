// Fused RadixSpline lookup: the kernel backend of the RS kind, single-table
// and batched.
//
// Replaces repro/kernels/rs_search.py:fused_rs_search_pallas and
// batched_rs_search_pallas (_rs_body).  One thread per query, three
// dependent stages:
//   1. the radix table, at the query's precomputed prefix, bounds the knot
//      range: lo_k = max(radix[p] - 1, 0), hi_k = radix[p + 1];
//   2. a search of `ksteps` trips over the knot keys finds the enclosing
//      knot j, clamped to [0, m_valid - 2]; the f32 re-anchored spline
//      predicts y1 + slope_j * max(u - u0_j, 0), clamped to +-1e9;
//   3. the prediction's floor and ceil, clamped into [0, n - 1] and widened
//      by eps, bound a search of `steps` trips over the table.
// The prefix (max(q, kmin) - kmin) >> shift is an unsigned shift of the
// 64-bit difference; the dispatch computes it (and u, in f64) outside the
// kernel, as the reference does.  Every gather index is clamped into its
// array: the prefix into [0, radix_len - 2], so radix[p + 1] exists, and j
// into the valid knots.  Every multiply and add is rounded on its own
// (-fmad=false): the re-encoded eps budgets one fused multiply-add only.
// The batched kernel takes its table from blockIdx.y and runs the same
// per-query function on that table's rows; `ksteps` and `steps` are the
// max over the tables, and r_bits (so radix_len) is common to them.
//
// Bound on the H100: bytes.  The radix table and knots are small and
// shared by all queries; the last stage is dependent gathers into the
// table, which at 2^24 keys lives in HBM.  This first design does nothing
// about that.  The plain PyTorch twins are _rs_body and _batched_rs_body in
// kernels/rs_search.py.

#include "search_common.cuh"

__device__ __forceinline__ int rs_query(float x, long long q, int prefix,
                                        const long long* __restrict__ table, int n,
                                        const long long* __restrict__ knots,
                                        const float* __restrict__ u0,
                                        const float* __restrict__ slope,
                                        const int* __restrict__ ranks,
                                        const int* __restrict__ radix, int radix_len, int m_valid,
                                        int eps, int ksteps, int steps) {
  // stage 1: the radix table bounds the knot range
  const int p = clampi(prefix, 0, radix_len - 2);
  const int lo_k = max(radix[p] - 1, 0);
  const int hi_k = radix[p + 1];
  const int len_k = max(hi_k - lo_k, 1);

  // stage 2: exact knot search, then f32 interpolation from knot j
  const int ub = bounded_ub(knots, q, lo_k, len_k, ksteps);
  const int j = clampi(ub - 1, 0, max(m_valid - 2, 0));
  const float du = fmaxf(__fsub_rn(x, u0[j]), 0.0f);
  const float pred = __fadd_rn(__int2float_rn(ranks[j]), __fmul_rn(slope[j], du));
  // clamp the centre into the table before widening
  const int p_lo = clampi(floor_to_int(pred), 0, n - 1);
  const int p_hi = clampi(ceil_to_int(pred), 0, n - 1);
  const int lo = clampi(p_lo - eps, 0, n - 1);
  const int hi = clampi(p_hi + eps, 0, n - 1);

  // stage 3: the eps-window search over the table
  return bounded_ub(table, q, lo, hi - lo + 1, steps) - 1;
}

extern "C" __global__ void rs_search_kernel(
    const float* __restrict__ u, const long long* __restrict__ queries,
    const int* __restrict__ prefix, long long nq, const long long* __restrict__ table, int n,
    const long long* __restrict__ knots, const float* __restrict__ u0,
    const float* __restrict__ slope, const int* __restrict__ ranks, int mk,
    const int* __restrict__ radix, int radix_len, const int* __restrict__ m_valid,
    const int* __restrict__ eps, int ksteps, int steps, int* __restrict__ out) {
  const long long i = query_slot(nq);
  if (i < 0) return;
  out[i] = rs_query(u[i], queries[i], prefix[i], table, n, knots, u0, slope, ranks, radix,
                    radix_len, min(m_valid[0], mk), eps[0], ksteps, steps);
}

// Table t: row t of the (n_tables, n) tables, the (n_tables, mk) knot
// leaves, the (n_tables, radix_len) radix tables and the (n_tables,)
// m_valid and eps; row t of the (n_tables, nq) u, prefix and out; queries
// row t at stride q_stride (0 when one batch is broadcast).
extern "C" __global__ void batched_rs_search_kernel(
    const float* __restrict__ u, const long long* __restrict__ queries, long long q_stride,
    const int* __restrict__ prefix, long long nq, const long long* __restrict__ tables, int n,
    const long long* __restrict__ knots, const float* __restrict__ u0,
    const float* __restrict__ slope, const int* __restrict__ ranks, int mk,
    const int* __restrict__ radix, int radix_len, const int* __restrict__ m_valid,
    const int* __restrict__ eps, int ksteps, int steps, int* __restrict__ out) {
  const long long i = query_slot(nq);
  if (i < 0) return;
  const long long t = blockIdx.y;
  const long long lk = t * mk;
  out[t * nq + i] = rs_query(u[t * nq + i], queries[t * q_stride + i], prefix[t * nq + i],
                             tables + t * n, n, knots + lk, u0 + lk, slope + lk, ranks + lk,
                             radix + t * radix_len, radix_len, min(m_valid[t], mk), eps[t],
                             ksteps, steps);
}

extern "C" int rs_search_launch(const void* u, const void* queries, const void* prefix,
                                long long nq, const void* table, int n, const void* knots,
                                const void* u0, const void* slope, const void* ranks, int mk,
                                const void* radix, int radix_len, const void* m_valid,
                                const void* eps, int ksteps, int steps, void* out, void* stream) {
  rs_search_kernel<<<search_grid(nq, 1), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)u, (const long long*)queries, (const int*)prefix, nq,
      (const long long*)table, n, (const long long*)knots, (const float*)u0,
      (const float*)slope, (const int*)ranks, mk, (const int*)radix, radix_len,
      (const int*)m_valid, (const int*)eps, ksteps, steps, (int*)out);
  return (int)cudaGetLastError();
}

extern "C" int batched_rs_search_launch(const void* u, const void* queries, long long q_stride,
                                        const void* prefix, long long nq, int n_tables,
                                        const void* tables, int n, const void* knots,
                                        const void* u0, const void* slope, const void* ranks,
                                        int mk, const void* radix, int radix_len,
                                        const void* m_valid, const void* eps, int ksteps,
                                        int steps, void* out, void* stream) {
  batched_rs_search_kernel<<<search_grid(nq, n_tables), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)u, (const long long*)queries, q_stride, (const int*)prefix, nq,
      (const long long*)tables, n, (const long long*)knots, (const float*)u0,
      (const float*)slope, (const int*)ranks, mk, (const int*)radix, radix_len,
      (const int*)m_valid, (const int*)eps, ksteps, steps, (int*)out);
  return (int)cudaGetLastError();
}
