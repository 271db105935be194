// Fused RMI predict + eps-bounded search: the kernel backend of the RMI and
// SY-RMI kinds, single-table and batched.
//
// Replaces repro/kernels/rmi_search.py:fused_rmi_search_pallas and
// batched_rmi_search_pallas (_rmi_body).  One thread per query:
//   0. u = clip((q - kmin) * inv_span, 0, 1) from the encoded query, in f64
//      and rounded once to f32 (unit_f32 in search_common.cuh, bit for bit
//      the host's keys.unit_f32).  The TPU kernel took u from outside,
//      having neither u64 nor f64; here it costs the thread two f64
//      operations and saves the lookup a pass of ~11 eager kernels over
//      f64 temporaries;
//   1. f32 cubic root in Horner form on u, clamped to +-1e9, times b/n in
//      f64, floored -> leaf in [0, b-1];
//   2. the leaf's f32 line slope*u + icept, clamped to +-1e9; its floor and
//      ceil clamped into the leaf fences [rlo, rhi], widened by the leaf's
//      eps and clamped again;
//   3. a Khuong-Morin search over that window that stops once the window
//      is one key wide, capped at `steps` (bounded_ub_early).
// Every multiply and add is rounded on its own (__fmul_rn / __fadd_rn, and
// the library builds with -fmad=false): the re-encoded eps budgets one
// fused multiply-add only.  The leaf product is the one f64 operation of
// the model: the re-encoder (kernels/ops.py:rmi_kernel_arrays) assigns
// leaves with floor(f64(p) * (b/n)), and the reference's f32 product can
// land one leaf past that near a leaf boundary, whose fences then exclude
// the true rank.  With the same f64 product the kernel's leaf is the
// re-encoder's leaf, and the window is a guarantee again.  The batched
// kernel takes its table from blockIdx.y and runs the same per-query
// function on that table's rows of the stacked leaves and its own kmin and
// inv_span; `steps` is the max over the tables.  A grid row takes more
// than one table only past 65,535 tables (search_grid).
//
// Bound on the H100: bytes.  The leaf gathers read a few KB shared by all
// queries; each search trip is a dependent gather into the table, which at
// 2^24 keys lives in HBM.  `steps` is bucketed from the widest leaf window
// of the whole index, so a fixed-trip loop made every query pay for the
// worst leaf; stopping at a one-key window makes each query pay for its
// own.  The plain PyTorch twins are rmi_search_plain and
// batched_rmi_search_plain in kernels/rmi_search.py.

#include "search_common.cuh"

__device__ __forceinline__ int rmi_query(long long q, double kmin, double inv_span,
                                         const long long* __restrict__ table,
                                         const float* __restrict__ root,
                                         const float* __restrict__ slope,
                                         const float* __restrict__ icept,
                                         const int* __restrict__ eps, const int* __restrict__ rlo,
                                         const int* __restrict__ rhi, int b, double b_over_n,
                                         int steps) {
  const float x = unit_f32(q, kmin, inv_span);

  // root -> leaf
  float p = __fadd_rn(__fmul_rn(root[3], x), root[2]);
  p = __fadd_rn(__fmul_rn(p, x), root[1]);
  p = __fadd_rn(__fmul_rn(p, x), root[0]);
  p = clampf(p, -1.0e9f, 1.0e9f);
  const int leaf = clampi((int)floor(__dmul_rn((double)p, b_over_n)), 0, b - 1);

  // leaf predict + guaranteed window
  const int f_lo = rlo[leaf];
  const int f_hi = rhi[leaf];
  const int e = eps[leaf];
  const float pr = __fadd_rn(__fmul_rn(slope[leaf], x), icept[leaf]);
  const int p_lo = clampi(floor_to_int(pr), f_lo, f_hi);
  const int p_hi = clampi(ceil_to_int(pr), f_lo, f_hi);
  const int lo = clampi(p_lo - e, f_lo, f_hi);
  const int hi = clampi(p_hi + e, f_lo, f_hi);

  // bounded search, each query's own trip count
  return bounded_ub_early(table, q, lo, hi - lo + 1, steps) - 1;
}

extern "C" __global__ void rmi_search_kernel(
    const long long* __restrict__ queries, long long nq, const double* __restrict__ kmin,
    const double* __restrict__ inv_span, const long long* __restrict__ table,
    const float* __restrict__ root, const float* __restrict__ slope,
    const float* __restrict__ icept, const int* __restrict__ eps, const int* __restrict__ rlo,
    const int* __restrict__ rhi, int b,
    double b_over_n, int steps, int* __restrict__ out) {
  const long long i = query_slot(nq);
  if (i < 0) return;
  out[i] = rmi_query(queries[i], kmin[0], inv_span[0], table, root, slope, icept, eps, rlo, rhi, b,
                     b_over_n, steps);
}

// Table t (blockIdx.y, then every gridDim.y-th table past it): row t of the
// (n_tables, n) tables, the (n_tables, 4) roots and the (n_tables, b)
// leaves, element t of the (n_tables,) kmin and inv_span; row t of the
// (n_tables, nq) out; queries row t at stride q_stride (0 when one batch
// is broadcast).
extern "C" __global__ void batched_rmi_search_kernel(
    const long long* __restrict__ queries, long long q_stride, long long nq, int n_tables,
    const double* __restrict__ kmin, const double* __restrict__ inv_span,
    const long long* __restrict__ tables, int n, const float* __restrict__ root,
    const float* __restrict__ slope, const float* __restrict__ icept,
    const int* __restrict__ eps, const int* __restrict__ rlo, const int* __restrict__ rhi, int b,
    double b_over_n, int steps, int* __restrict__ out) {
  const long long i = query_slot(nq);
  if (i < 0) return;
  for (long long t = blockIdx.y; t < n_tables; t += gridDim.y) {
    const long long lb = t * b;
    out[t * nq + i] = rmi_query(queries[t * q_stride + i], kmin[t], inv_span[t], tables + t * n,
                                root + t * 4, slope + lb, icept + lb, eps + lb, rlo + lb,
                                rhi + lb, b, b_over_n, steps);
  }
}

extern "C" int rmi_search_launch(const void* queries, long long nq, const void* kmin,
                                 const void* inv_span, const void* table, const void* root,
                                 const void* slope, const void* icept, const void* eps,
                                 const void* rlo, const void* rhi, int b, double b_over_n,
                                 int steps, void* out, void* stream) {
  rmi_search_kernel<<<search_grid(nq, 1), kThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)queries, nq, (const double*)kmin, (const double*)inv_span,
      (const long long*)table, (const float*)root, (const float*)slope, (const float*)icept,
      (const int*)eps, (const int*)rlo, (const int*)rhi, b, b_over_n, steps, (int*)out);
  return (int)cudaGetLastError();
}

extern "C" int batched_rmi_search_launch(const void* queries, long long q_stride, long long nq,
                                         int n_tables, const void* kmin, const void* inv_span,
                                         const void* tables, int n, const void* root,
                                         const void* slope, const void* icept, const void* eps,
                                         const void* rlo, const void* rhi, int b, double b_over_n,
                                         int steps, void* out, void* stream) {
  batched_rmi_search_kernel<<<search_grid(nq, n_tables), kThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)queries, q_stride, nq, n_tables, (const double*)kmin,
      (const double*)inv_span, (const long long*)tables, n, (const float*)root, (const float*)slope, (const float*)icept,
      (const int*)eps, (const int*)rlo, (const int*)rhi, b, b_over_n, steps, (int*)out);
  return (int)cudaGetLastError();
}
