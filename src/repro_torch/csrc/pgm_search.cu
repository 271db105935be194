// Fused PGM descent: the kernel backend of the PGM and PGM_M kinds,
// single-table and batched.
//
// Replaces repro/kernels/pgm_search.py:fused_pgm_search_pallas and
// batched_pgm_search_pallas (_pgm_body, _bounded_ub_limbs).  One thread per
// query walks the levels top-down.  At each level it gathers the current
// segment's f32 anchor u0, slope and rank fences r0/r1, predicts
// r0 + slope * max(u - u0, 0) in f32 (clamped to +-1e9), clamps the centre
// into [r0 - 1, r1 - 1], widens it by eps + 1, and runs an upper-bound
// search of `steps` trips over the next level's segment keys -- or over
// the table at the last level, whose result is the predecessor rank.
// Every multiply and add is rounded on its own: the re-encoded eps budgets
// one fused multiply-add only.  `levels` and `steps` are run-time values.
// The batched kernel takes its table from blockIdx.y and runs the same
// per-query function on that table's rows of the stacked leaves; the level
// count is common (shallow tables were lifted at stack time) and `steps`
// is the max over the tables.
//
// Bound on the H100: bytes.  The segment leaves are small and shared by all
// queries; the last level's search is dependent gathers into the table,
// which at 2^24 keys lives in HBM.  This first design does nothing about
// that.  The plain PyTorch twins are _pgm_body and _batched_pgm_body in
// kernels/pgm_search.py.

#include "search_common.cuh"

__device__ __forceinline__ int pgm_query(float x, long long q, const long long* __restrict__ table,
                                         int n, const long long* __restrict__ keys,
                                         const float* __restrict__ u0,
                                         const float* __restrict__ slope,
                                         const int* __restrict__ rank0,
                                         const int* __restrict__ off,
                                         const int* __restrict__ off_r,
                                         const int* __restrict__ sizes, int eps, int levels,
                                         int steps) {
  const int widen = eps + 1;
  int seg = 0;
  for (int lvl = 0; lvl < levels; ++lvl) {
    const int k = off[lvl] + seg;
    const int r = off_r[lvl] + seg;
    const int r0 = rank0[r];
    const int r1 = rank0[r + 1];
    const float du = fmaxf(__fsub_rn(x, u0[k]), 0.0f);
    const float pred = __fadd_rn(__int2float_rn(r0), __fmul_rn(slope[k], du));
    const int b_lo = max(r0 - 1, 0);
    const int b_hi = r1 - 1;
    const int p_lo = clampi(floor_to_int(pred), b_lo, b_hi);
    const int p_hi = clampi(ceil_to_int(pred), b_lo, b_hi);
    int lo = clampi(p_lo - widen, b_lo, b_hi);
    int hi = clampi(p_hi + widen, b_lo, b_hi);
    if (lvl + 1 < levels) {
      const int base_n = off[lvl + 1];
      const int ub = bounded_ub(keys, q, base_n + lo, hi - lo + 1, steps);
      seg = min(max(ub - base_n - 1, 0), sizes[lvl + 1] - 1);
    } else {
      lo = clampi(lo, 0, n - 1);
      hi = clampi(hi, 0, n - 1);
      return bounded_ub(table, q, lo, hi - lo + 1, steps) - 1;
    }
  }
  return -1;  // unreachable: the wrappers require levels >= 1
}

extern "C" __global__ void pgm_search_kernel(
    const float* __restrict__ u, const long long* __restrict__ queries, long long nq,
    const long long* __restrict__ table, int n, const long long* __restrict__ keys,
    const float* __restrict__ u0, const float* __restrict__ slope,
    const int* __restrict__ rank0, const int* __restrict__ off, const int* __restrict__ off_r,
    const int* __restrict__ sizes, const int* __restrict__ eps, int levels, int steps,
    int* __restrict__ out) {
  const long long i = query_slot(nq);
  if (i < 0) return;
  out[i] = pgm_query(u[i], queries[i], table, n, keys, u0, slope, rank0, off, off_r, sizes, eps[0],
                     levels, steps);
}

// Table t: row t of every stacked leaf, with row lengths kn (keys, u0,
// slope), rn (rank0), levels + 1 (off, off_r), levels (sizes) and 1 (eps);
// row t of the (n_tables, nq) u and out; queries row t at stride q_stride
// (0 when one batch is broadcast).
extern "C" __global__ void batched_pgm_search_kernel(
    const float* __restrict__ u, const long long* __restrict__ queries, long long q_stride,
    long long nq, const long long* __restrict__ tables, int n, const long long* __restrict__ keys,
    const float* __restrict__ u0, const float* __restrict__ slope, int kn,
    const int* __restrict__ rank0, int rn, const int* __restrict__ off,
    const int* __restrict__ off_r, const int* __restrict__ sizes, const int* __restrict__ eps,
    int levels, int steps, int* __restrict__ out) {
  const long long i = query_slot(nq);
  if (i < 0) return;
  const long long t = blockIdx.y;
  const long long lk = t * kn;
  out[t * nq + i] = pgm_query(u[t * nq + i], queries[t * q_stride + i], tables + t * n, n,
                              keys + lk, u0 + lk, slope + lk, rank0 + t * rn,
                              off + t * (levels + 1), off_r + t * (levels + 1),
                              sizes + t * levels, eps[t], levels, steps);
}

extern "C" int pgm_search_launch(const void* u, const void* queries, long long nq,
                                 const void* table, int n, const void* keys, const void* u0,
                                 const void* slope, const void* rank0, const void* off,
                                 const void* off_r, const void* sizes, const void* eps,
                                 int levels, int steps, void* out, void* stream) {
  pgm_search_kernel<<<search_grid(nq, 1), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)u, (const long long*)queries, nq, (const long long*)table, n,
      (const long long*)keys, (const float*)u0, (const float*)slope, (const int*)rank0,
      (const int*)off, (const int*)off_r, (const int*)sizes, (const int*)eps, levels, steps,
      (int*)out);
  return (int)cudaGetLastError();
}

extern "C" int batched_pgm_search_launch(const void* u, const void* queries, long long q_stride,
                                         long long nq, int n_tables, const void* tables, int n,
                                         const void* keys, const void* u0, const void* slope,
                                         int kn, const void* rank0, int rn, const void* off,
                                         const void* off_r, const void* sizes, const void* eps,
                                         int levels, int steps, void* out, void* stream) {
  batched_pgm_search_kernel<<<search_grid(nq, n_tables), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)u, (const long long*)queries, q_stride, nq, (const long long*)tables, n,
      (const long long*)keys, (const float*)u0, (const float*)slope, kn, (const int*)rank0, rn,
      (const int*)off, (const int*)off_r, (const int*)sizes, (const int*)eps, levels, steps,
      (int*)out);
  return (int)cudaGetLastError();
}
