// Fused PGM descent: the kernel backend of the PGM and PGM_M kinds.
//
// Replaces repro/kernels/pgm_search.py:fused_pgm_search_pallas (_pgm_body,
// _bounded_ub_limbs).  One thread per query walks the levels top-down.  At
// each level it gathers the current segment's f32 anchor u0, slope and rank
// fences r0/r1, predicts r0 + slope * max(u - u0, 0) in f32 (clamped to
// +-1e9), clamps the centre into [r0 - 1, r1 - 1], widens it by eps + 1,
// and runs an upper-bound search of `steps` trips over the next level's
// segment keys -- or over the table at the last level, whose result is the
// predecessor rank.  Every multiply and add is rounded on its own: the
// re-encoded eps budgets one fused multiply-add only.  Keys are uint64
// stored as int64 with the sign bit flipped; `levels` and `steps` are
// run-time values.
//
// Bound on the H100: bytes.  The segment leaves are small and shared by all
// queries; the last level's search is dependent gathers into the table,
// which at 2^24 keys lives in HBM.  This first design does nothing about
// that.  The plain PyTorch twin is _pgm_body in kernels/pgm_search.py.

#include <cuda_runtime.h>

__device__ __forceinline__ int clampi(int x, int lo, int hi) { return min(max(x, lo), hi); }

// First index in [base, base + len) whose key is > q (base + len if none).
__device__ __forceinline__ int bounded_ub(const long long* __restrict__ keys, long long q,
                                          int base, int len, int steps) {
  for (int s = 0; s < steps; ++s) {
    const int half = len >> 1;
    const int mid = base + half;
    const bool go_right = (__ldg(keys + mid) <= q) && (len > 1);
    base = go_right ? mid : base;
    len -= (len > 1) ? half : 0;
  }
  return base + (__ldg(keys + base) <= q ? 1 : 0);
}

extern "C" __global__ void pgm_search_kernel(
    const float* __restrict__ u, const long long* __restrict__ queries, long long nq,
    const long long* __restrict__ table, int n, const long long* __restrict__ keys,
    const float* __restrict__ u0, const float* __restrict__ slope,
    const int* __restrict__ rank0, const int* __restrict__ off, const int* __restrict__ off_r,
    const int* __restrict__ sizes, const int* __restrict__ eps, int levels, int steps,
    int* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nq) return;  // ragged tail: masked, not padded
  const float x = u[i];
  const long long q = queries[i];
  const int widen = eps[0] + 1;
  int seg = 0;
  for (int lvl = 0; lvl < levels; ++lvl) {
    const int k = off[lvl] + seg;
    const int r = off_r[lvl] + seg;
    const int r0 = rank0[r];
    const int r1 = rank0[r + 1];
    const float du = fmaxf(__fsub_rn(x, u0[k]), 0.0f);
    float pred = __fadd_rn(__int2float_rn(r0), __fmul_rn(slope[k], du));
    pred = fminf(fmaxf(pred, -1.0e9f), 1.0e9f);
    const int b_lo = max(r0 - 1, 0);
    const int b_hi = r1 - 1;
    const int p_lo = clampi((int)floorf(pred), b_lo, b_hi);
    const int p_hi = clampi((int)ceilf(pred), b_lo, b_hi);
    int lo = clampi(p_lo - widen, b_lo, b_hi);
    int hi = clampi(p_hi + widen, b_lo, b_hi);
    if (lvl + 1 < levels) {
      const int base_n = off[lvl + 1];
      const int ub = bounded_ub(keys, q, base_n + lo, hi - lo + 1, steps);
      seg = min(max(ub - base_n - 1, 0), sizes[lvl + 1] - 1);
    } else {
      lo = clampi(lo, 0, n - 1);
      hi = clampi(hi, 0, n - 1);
      out[i] = bounded_ub(table, q, lo, hi - lo + 1, steps) - 1;
    }
  }
}

extern "C" int pgm_search_launch(const void* u, const void* queries, long long nq,
                                 const void* table, int n, const void* keys, const void* u0,
                                 const void* slope, const void* rank0, const void* off,
                                 const void* off_r, const void* sizes, const void* eps,
                                 int levels, int steps, void* out, void* stream) {
  const int threads = 256;
  const long long blocks = (nq + threads - 1) / threads;
  pgm_search_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)u, (const long long*)queries, nq, (const long long*)table, n,
      (const long long*)keys, (const float*)u0, (const float*)slope, (const int*)rank0,
      (const int*)off, (const int*)off_r, (const int*)sizes, (const int*)eps, levels, steps,
      (int*)out);
  return (int)cudaGetLastError();
}
