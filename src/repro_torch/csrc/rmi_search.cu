// Fused RMI predict + eps-bounded search: the kernel backend of the RMI and
// SY-RMI kinds.
//
// Replaces repro/kernels/rmi_search.py:fused_rmi_search_pallas (_rmi_body).
// One thread per query:
//   1. f32 cubic root in Horner form on the pre-normalised u, clamped to
//      +-1e9, times b/n in f64, floored -> leaf in [0, b-1];
//   2. the leaf's f32 line slope*u + icept, clamped to +-1e9; its floor and
//      ceil clamped into the leaf fences [rlo, rhi], widened by the leaf's
//      eps and clamped again;
//   3. a Khuong-Morin search of `steps` trips over that window.
// Every multiply and add is rounded on its own (__fmul_rn / __fadd_rn, and
// the library builds with -fmad=false): the re-encoded eps budgets one
// fused multiply-add only.  The leaf product is the one f64 operation: the
// re-encoder (kernels/ops.py:rmi_kernel_arrays) assigns leaves with
// floor(f64(p) * (b/n)), and the reference's f32 product can land one leaf
// past that near a leaf boundary, whose fences then exclude the true rank.
// With the same f64 product the kernel's leaf is the re-encoder's leaf, and
// the window is a guarantee again.  Keys are uint64 stored as int64 with
// the sign bit flipped, compared with one signed 64-bit compare.
//
// Bound on the H100: bytes.  The leaf gathers read a few KB shared by all
// queries; each search trip is a dependent gather into the table, which at
// 2^24 keys lives in HBM.  This first design does nothing about that.  The
// plain PyTorch twin is _rmi_body in kernels/rmi_search.py.

#include <cuda_runtime.h>

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) { return min(max(x, lo), hi); }

extern "C" __global__ void rmi_search_kernel(
    const float* __restrict__ u, const long long* __restrict__ queries, long long nq,
    const long long* __restrict__ table, int n, const float* __restrict__ root,
    const float* __restrict__ slope, const float* __restrict__ icept,
    const int* __restrict__ eps, const int* __restrict__ rlo, const int* __restrict__ rhi, int b,
    double b_over_n, int steps, int* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nq) return;  // ragged tail: masked, not padded
  const float x = u[i];
  const long long q = queries[i];

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
  const float pr = clampf(__fadd_rn(__fmul_rn(slope[leaf], x), icept[leaf]), -1.0e9f, 1.0e9f);
  const int p_lo = clampi((int)floorf(pr), f_lo, f_hi);
  const int p_hi = clampi((int)ceilf(pr), f_lo, f_hi);
  const int lo = clampi(p_lo - e, f_lo, f_hi);
  const int hi = clampi(p_hi + e, f_lo, f_hi);

  // fixed-trip branch-free bounded search
  int base = lo;
  int len = hi - lo + 1;
  for (int s = 0; s < steps; ++s) {
    const int half = len >> 1;
    const int mid = base + half;
    const bool go_right = (__ldg(table + mid) <= q) && (len > 1);
    base = go_right ? mid : base;
    len -= (len > 1) ? half : 0;
  }
  out[i] = base + (__ldg(table + base) <= q ? 1 : 0) - 1;
}

extern "C" int rmi_search_launch(const void* u, const void* queries, long long nq,
                                 const void* table, int n, const void* root, const void* slope,
                                 const void* icept, const void* eps, const void* rlo,
                                 const void* rhi, int b, double b_over_n, int steps, void* out,
                                 void* stream) {
  const int threads = 256;
  const long long blocks = (nq + threads - 1) / threads;
  rmi_search_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)u, (const long long*)queries, nq, (const long long*)table, n,
      (const float*)root, (const float*)slope, (const float*)icept, (const int*)eps,
      (const int*)rlo, (const int*)rhi, b, b_over_n, steps, (int*)out);
  return (int)cudaGetLastError();
}
