// Pieces every search kernel of this library shares.
//
// Keys are uint64 stored as int64 with the sign bit flipped, so one signed
// 64-bit compare orders them.  Each kernel answers one query per thread;
// the batched kernels take the tables blockIdx.y, blockIdx.y + gridDim.y,
// ... in turn and step their pointers by the row strides they are given.

#pragma once

#include <cuda_runtime.h>

// The thread's query slot, or -1 past the last query: the ragged tail is
// masked, not padded.
__device__ __forceinline__ long long query_slot(long long nq) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  return i < nq ? i : -1;
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) { return min(max(x, lo), hi); }

// floor / ceil of a prediction as int32.  The clamp to +-1e9 comes before
// the cast: an out-of-range float-to-int conversion is garbage that later
// integer clamps cannot repair.
__device__ __forceinline__ int floor_to_int(float x) {
  return (int)floorf(clampf(x, -1.0e9f, 1.0e9f));
}
__device__ __forceinline__ int ceil_to_int(float x) {
  return (int)ceilf(clampf(x, -1.0e9f, 1.0e9f));
}

// First index in [base, base + len) whose key is > q (base + len if none):
// a Khuong-Morin loop that halves the window until it is one key wide, so
// each query makes ceil(log2 len) trips for its own window.  `steps` is
// only the cap (bucketed from the widest window of the index); a trip at
// len == 1 would be a no-op, so the ranks are a fixed `steps`-trip loop's.
__device__ __forceinline__ int bounded_ub_early(const long long* __restrict__ keys, long long q,
                                                int base, int len, int steps) {
  for (int s = 0; s < steps && len > 1; ++s) {
    const int half = len >> 1;
    const int mid = base + half;
    base = (__ldg(keys + mid) <= q) ? mid : base;
    len -= half;
  }
  return base + (__ldg(keys + base) <= q ? 1 : 0);
}

// The kernels' CDF coordinate of an encoded key, bit for bit the host's
// keys.unit_f32: un-flip the sign, the uint64 rounded once to f64, then
// (x - kmin) * inv_span in f64 (each rounded on its own), clamped to
// [0, 1] and rounded once to f32.
__device__ __forceinline__ float unit_f32(long long key, double kmin, double inv_span) {
  const unsigned long long k = (unsigned long long)key ^ 0x8000000000000000ull;
  const double u = __dmul_rn(__dsub_rn(__ull2double_rn(k), kmin), inv_span);
  return __double2float_rn(fmin(fmax(u, 0.0), 1.0));
}

// Launch shape shared by every launcher: 256 threads a block, blocks over
// the queries in x and over the tables in y.  gridDim.y is capped at its
// hardware limit, 65,535: past it a grid row takes the tables row,
// row + 65,535, ... in turn (each batched kernel loops
// for (t = blockIdx.y; t < n_tables; t += gridDim.y)).  Below the cap one
// row is one table, and the blocks still start table by table.
constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

inline dim3 search_grid(long long nq, int n_tables) {
  return dim3((unsigned)((nq + kThreads - 1) / kThreads),
              (unsigned)(n_tables < kMaxGridY ? n_tables : kMaxGridY));
}
