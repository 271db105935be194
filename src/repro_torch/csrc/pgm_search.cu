// Fused PGM descent: the kernel backend of the PGM and PGM_M kinds,
// single-table and batched.
//
// Replaces repro/kernels/pgm_search.py:fused_pgm_search_pallas and
// batched_pgm_search_pallas (_pgm_body, _bounded_ub_limbs).  One thread a
// query:
//   0. u = clip((q - kmin) * inv_span, 0, 1) from the encoded query, in f64
//      and rounded once to f32 (unit_f32 in search_common.cuh, bit for bit
//      the host's keys.unit_f32).  The TPU kernel took u from outside,
//      having neither u64 nor f64; here it saves the lookup a pass of ~11
//      eager kernels over f64 temporaries;
//   1. top-down over `levels`: the current segment's f32 anchor u0, slope
//      and rank fences r0/r1; r0 + slope * max(u - u0, 0) in f32 (clamped
//      to +-1e9), its floor and ceil clamped into [r0 - 1, r1 - 1], widened
//      by eps + 1 and clamped again;
//   2. an upper-bound search of that window over the next level's segment
//      keys -- or over the table at the last level, whose result is the
//      predecessor rank -- that stops once the window is one key wide,
//      `steps` (bucketed from the widest window of the index) only the cap
//      (bounded_ub_early).
// Every multiply and add is rounded on its own: the re-encoded eps budgets
// one fused multiply-add only.  The level directories (rank0, off, off_r,
// sizes) are read as the index holds them, int64, and narrowed in
// registers (the wrappers require n < 2^31), so a lookup casts nothing.
// `levels` and `steps` are run-time values.
//
// Bound on the H100: the dependent loads, not the bytes.  At 2^24 keys the
// table lives in HBM, and each trip of the table search gathers from a
// window at a random place, which misses L2.  A fixed `steps` made every
// query pay for the widest window of every level: at 2-3 levels, more
// dependent loads than binary search.  Here each query makes its own
// window's trips.  The upper levels are a few hundred bytes read by every
// query and stay in L1: staging them in shared memory was measured and
// gained nothing, while the carve-out took L1 from the last level's
// arrays (PERF.md).  The batched kernel takes its table from
// blockIdx.y and runs the same per-query function on that table's rows of
// the stacked leaves, its own kmin/inv_span and eps; the blocks start in
// order, so the grid works on one table (at a tier's shard size, one that
// fits in L2) at a time; past 65,535 tables a grid row takes every
// 65,535th table in turn (search_grid).  The level count is common
// (shallow tables were lifted at stack time) and `steps` is the max over
// the tables.  The plain PyTorch twins are pgm_search_plain and
// batched_pgm_search_plain in kernels/pgm_search.py.

#include "search_common.cuh"

// One table's leaves: the level-concatenated segment keys, f32 u0/slope
// (pk_*), and the int64 level directories.
struct PgmLeaves {
  const long long* keys;
  const float* u0;
  const float* slope;
  const long long* rank0;
  const long long* off;
  const long long* off_r;
  const long long* sizes;
};

__device__ __forceinline__ int pgm_query(long long q, double kmin, double inv_span,
                                         const long long* __restrict__ table, int n,
                                         const PgmLeaves& g, int eps, int levels, int steps) {
  const float x = unit_f32(q, kmin, inv_span);
  const int widen = eps + 1;
  int seg = 0;
  for (int lvl = 0; lvl < levels; ++lvl) {
    const int k = (int)__ldg(g.off + lvl) + seg;
    const int r = (int)__ldg(g.off_r + lvl) + seg;
    const int r0 = (int)__ldg(g.rank0 + r);
    const int r1 = (int)__ldg(g.rank0 + r + 1);
    const float du = fmaxf(__fsub_rn(x, __ldg(g.u0 + k)), 0.0f);
    const float pred = __fadd_rn(__int2float_rn(r0), __fmul_rn(__ldg(g.slope + k), du));
    const int b_lo = max(r0 - 1, 0);
    const int b_hi = r1 - 1;
    const int p_lo = clampi(floor_to_int(pred), b_lo, b_hi);
    const int p_hi = clampi(ceil_to_int(pred), b_lo, b_hi);
    int lo = clampi(p_lo - widen, b_lo, b_hi);
    int hi = clampi(p_hi + widen, b_lo, b_hi);
    if (lvl + 1 < levels) {
      const int base_n = (int)__ldg(g.off + lvl + 1);
      const int ub = bounded_ub_early(g.keys, q, base_n + lo, hi - lo + 1, steps);
      seg = min(max(ub - base_n - 1, 0), (int)__ldg(g.sizes + lvl + 1) - 1);
    } else {
      lo = clampi(lo, 0, n - 1);
      hi = clampi(hi, 0, n - 1);
      return bounded_ub_early(table, q, lo, hi - lo + 1, steps) - 1;
    }
  }
  return -1;  // unreachable: the wrappers require levels >= 1
}

extern "C" __global__ void pgm_search_kernel(const long long* __restrict__ queries, long long nq,
                                             const double* __restrict__ kmin,
                                             const double* __restrict__ inv_span,
                                             const long long* __restrict__ table, int n,
                                             PgmLeaves g, const int* __restrict__ eps, int levels,
                                             int steps, int* __restrict__ out) {
  const long long i = query_slot(nq);
  if (i < 0) return;
  out[i] = pgm_query(queries[i], kmin[0], inv_span[0], table, n, g, eps[0], levels, steps);
}

// Table t (blockIdx.y, then every gridDim.y-th table past it): row t of
// every stacked leaf, with row lengths kn (keys, u0, slope), rn (rank0),
// levels + 1 (off, off_r) and levels (sizes); element t of kmin, inv_span
// and eps; row t of the (n_tables, nq) out; queries row t at stride
// q_stride (0 when one batch is broadcast).
extern "C" __global__ void batched_pgm_search_kernel(
    const long long* __restrict__ queries, long long q_stride, long long nq, int n_tables,
    const double* __restrict__ kmin, const double* __restrict__ inv_span,
    const long long* __restrict__ tables, int n, PgmLeaves g, int kn, int rn,
    const int* __restrict__ eps, int levels, int steps, int* __restrict__ out) {
  const long long i = query_slot(nq);
  if (i < 0) return;
  for (long long t = blockIdx.y; t < n_tables; t += gridDim.y) {
    const long long lk = t * kn;
    const PgmLeaves mine{g.keys + lk, g.u0 + lk, g.slope + lk, g.rank0 + t * rn,
                         g.off + t * (levels + 1), g.off_r + t * (levels + 1),
                         g.sizes + t * levels};
    out[t * nq + i] = pgm_query(queries[t * q_stride + i], kmin[t], inv_span[t], tables + t * n,
                                n, mine, eps[t], levels, steps);
  }
}

extern "C" int pgm_search_launch(const void* queries, long long nq, const void* kmin,
                                 const void* inv_span, const void* table, int n, const void* keys,
                                 const void* u0, const void* slope, const void* rank0,
                                 const void* off, const void* off_r, const void* sizes,
                                 const void* eps, int levels, int steps, void* out, void* stream) {
  const PgmLeaves g{(const long long*)keys, (const float*)u0, (const float*)slope,
                    (const long long*)rank0, (const long long*)off, (const long long*)off_r,
                    (const long long*)sizes};
  pgm_search_kernel<<<search_grid(nq, 1), kThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)queries, nq, (const double*)kmin, (const double*)inv_span,
      (const long long*)table, n, g, (const int*)eps, levels, steps, (int*)out);
  return (int)cudaGetLastError();
}

extern "C" int batched_pgm_search_launch(const void* queries, long long q_stride, long long nq,
                                         int n_tables, const void* kmin, const void* inv_span,
                                         const void* tables, int n, const void* keys,
                                         const void* u0, const void* slope, int kn,
                                         const void* rank0, int rn, const void* off,
                                         const void* off_r, const void* sizes, const void* eps,
                                         int levels, int steps, void* out, void* stream) {
  const PgmLeaves g{(const long long*)keys, (const float*)u0, (const float*)slope,
                    (const long long*)rank0, (const long long*)off, (const long long*)off_r,
                    (const long long*)sizes};
  batched_pgm_search_kernel<<<search_grid(nq, n_tables), kThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)queries, q_stride, nq, n_tables, (const double*)kmin,
      (const double*)inv_span, (const long long*)tables, n, g, kn, rn, (const int*)eps, levels, steps, (int*)out);
  return (int)cudaGetLastError();
}
