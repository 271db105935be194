// Model-free predecessor search over a sorted table: the kernel backend of
// the L, Q, C and KO kinds.
//
// Replaces repro/kernels/kary_search.py:kary_search_pallas (a lane-wide
// k = 128 fence compare for a TPU vector unit).  Here one thread answers
// one query with a branch-free binary search (k = 2); predecessor ranks do
// not depend on k.  Keys are uint64 stored as int64 with the sign bit
// flipped, so one signed 64-bit compare orders them.
//
// Bound on the H100: bytes.  Each of the ceil(log2 n) trips is a dependent
// gather into the table, which at 2^24 keys lives in HBM.  This first
// design does nothing about that: the table stays in global memory and
// each trip waits on its load.  The plain PyTorch twin is _kary_body in
// kernels/kary_search.py.

#include <cuda_runtime.h>

extern "C" __global__ void kary_search_kernel(const long long* __restrict__ table, int n,
                                              const long long* __restrict__ queries,
                                              long long nq, int steps, int* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nq) return;  // ragged tail: masked, not padded
  const long long q = queries[i];
  int base = 0;
  int len = n;
  for (int s = 0; s < steps; ++s) {
    const int half = len >> 1;
    const int mid = base + half;
    const bool go_right = (__ldg(table + mid) <= q) && (len > 1);
    base = go_right ? mid : base;
    len -= (len > 1) ? half : 0;
  }
  out[i] = base + (__ldg(table + base) <= q ? 1 : 0) - 1;
}

extern "C" int kary_search_launch(const void* table, int n, const void* queries, long long nq,
                                  int steps, void* out, void* stream) {
  const int threads = 256;
  const long long blocks = (nq + threads - 1) / threads;
  kary_search_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const long long*)table, n, (const long long*)queries, nq, steps, (int*)out);
  return (int)cudaGetLastError();
}
