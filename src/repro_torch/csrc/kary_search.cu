// Model-free predecessor search over a sorted table: the kernel backend of
// the L, Q, C, KO and BTREE kinds, and the batched backend of every kind
// without a fused batched kernel.
//
// Replaces repro/kernels/kary_search.py:kary_search_pallas and
// batched_kary_search_pallas (a lane-wide k = 128 fence compare for a TPU
// vector unit).  Here one thread answers one query with a branch-free
// binary search (k = 2); predecessor ranks do not depend on k.  The
// batched kernel takes its table from blockIdx.y and runs the same
// per-query function on that table's row.
//
// Bound on the H100: bytes.  Each of the ceil(log2 n) trips is a dependent
// gather into the table, which at 2^24 keys lives in HBM.  This first
// design does nothing about that: the table stays in global memory and
// each trip waits on its load.  The plain PyTorch twins are _kary_body and
// _batched_kary_body in kernels/kary_search.py.

#include "search_common.cuh"

__device__ __forceinline__ int kary_query(const long long* __restrict__ table, int n, long long q,
                                          int steps) {
  return bounded_ub(table, q, 0, n, steps) - 1;
}

extern "C" __global__ void kary_search_kernel(const long long* __restrict__ table, int n,
                                              const long long* __restrict__ queries,
                                              long long nq, int steps, int* __restrict__ out) {
  const long long i = query_slot(nq);
  if (i < 0) return;
  out[i] = kary_query(table, n, queries[i], steps);
}

// Table t of `n_tables`: row t of `tables` (n keys each), row t of
// `queries` (stride q_stride, 0 when one batch is broadcast to every table)
// and row t of `out` (nq ranks).
extern "C" __global__ void batched_kary_search_kernel(const long long* __restrict__ tables, int n,
                                                      const long long* __restrict__ queries,
                                                      long long q_stride, long long nq, int steps,
                                                      int* __restrict__ out) {
  const long long i = query_slot(nq);
  if (i < 0) return;
  const long long t = blockIdx.y;
  out[t * nq + i] = kary_query(tables + t * n, n, queries[t * q_stride + i], steps);
}

extern "C" int kary_search_launch(const void* table, int n, const void* queries, long long nq,
                                  int steps, void* out, void* stream) {
  kary_search_kernel<<<search_grid(nq, 1), kThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)table, n, (const long long*)queries, nq, steps, (int*)out);
  return (int)cudaGetLastError();
}

extern "C" int batched_kary_search_launch(const void* tables, int n_tables, int n,
                                          const void* queries, long long q_stride, long long nq,
                                          int steps, void* out, void* stream) {
  batched_kary_search_kernel<<<search_grid(nq, n_tables), kThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)tables, n, (const long long*)queries, q_stride, nq, steps, (int*)out);
  return (int)cudaGetLastError();
}
