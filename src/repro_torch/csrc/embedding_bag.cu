// EmbeddingBag: out[bag] = sum over items i with seg[i] == bag of
// w[i] * table[ids[i]], a row gather plus a segmented weighted sum.
//
// Replaces repro/kernels/embedding_bag.py:embedding_bag_pallas (_bag_kernel),
// which walks vocabulary tiles and forms each bag's sum as two one-hot
// matrix products on the TPU's matrix unit, because row gathers from VMEM
// are serialised there.  The H100 gathers rows directly.  seg need not be
// sorted, as on the TPU.  An id outside [0, V) or a bag outside
// [0, num_bags) adds nothing (the one-hot products give such an item no
// row), and the launcher zeroes out before the kernel runs.
//
// Bound on the H100: bytes.  Each item reads one table row (4 D bytes) and
// 12 bytes of id, bag and weight; each bag writes one row.  One multiply-add
// per value read is far below the f32 rate.  What the design does:
//   - a warp takes a contiguous chunk of 32 items: each lane loads one
//     item's id, bag and weight (coalesced), and the warp walks the chunk
//     with the three passed by __shfl_sync, so every branch on them is
//     warp-uniform;
//   - rows come in 16-byte loads: each lane holds 4 columns (a float4), a
//     pass over 128 columns, more passes for D > 128, whenever D % 4 == 0
//     and the table's pointer is 16-byte aligned.  Otherwise the launcher
//     picks the same kernel with one column a lane (VEC = 1);
//   - 8 rows are loaded before any is added, so a lane has 8 gathers in
//     flight;
//   - a run of items with the same bag sums in registers and is flushed
//     with one atomic a column when the bag changes and at the chunk's
//     end: on the float4 path one vector atomicAdd a lane, which sm_90
//     runs as one 16-byte reduction (REDG.E.ADD.F32x4; CUDA 12.1 and
//     later), else four scalar ones.  Sorted bags (the common case, and
//     the only one F.embedding_bag takes) pay one flush a run and a chunk
//     edge instead of one atomic a value; unsorted bags degrade to runs
//     of one item.
// The atomics make the order of each bag's sum run-dependent: results
// agree with the plain version to a tolerance, not bit for bit.  The plain
// PyTorch twin is _bag_body in kernels/embedding_bag.py.

#include <cuda_runtime.h>

#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900 && CUDART_VERSION >= 12010
#define BAG_VECTOR_ATOMICS 1
#else
#define BAG_VECTOR_ATOMICS 0
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;  // items a warp: one a lane
constexpr int kInFlight = 8;  // rows loaded before the first is added
constexpr unsigned kFull = 0xffffffffu;

template <int VEC>
__device__ __forceinline__ void load_row(const float* __restrict__ src, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(src));
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else {
    v[0] = __ldg(src);
  }
}

template <int VEC>
__device__ __forceinline__ void flush(float* dst, const float (&acc)[VEC]) {
  if constexpr (VEC == 4) {
#if BAG_VECTOR_ATOMICS
    atomicAdd(reinterpret_cast<float4*>(dst), make_float4(acc[0], acc[1], acc[2], acc[3]));
#else
#pragma unroll
    for (int j = 0; j < 4; ++j) atomicAdd(dst + j, acc[j]);
#endif
  } else {
    atomicAdd(dst, acc[0]);
  }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
    embedding_bag_kernel(const float* __restrict__ table, int V, int D,
                         const int* __restrict__ ids, const int* __restrict__ seg,
                         const float* __restrict__ w, long long n, int num_bags,
                         float* __restrict__ out) {
  const long long first = ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * kChunk;
  if (first >= n) return;  // warp-uniform
  const int lane = threadIdx.x & 31;

  // this lane's item; past n, or with an id or bag out of range, bag -1
  const long long item = first + lane;
  int my_id = 0, my_bag = -1;
  float my_w = 0.0f;
  if (item < n) {
    my_id = __ldg(ids + item);
    my_bag = __ldg(seg + item);
    my_w = __ldg(w + item);
    if (my_id < 0 || my_id >= V || my_bag < 0 || my_bag >= num_bags) my_bag = -1;
  }

  for (int c0 = 0; c0 < D; c0 += 32 * VEC) {
    const int c = c0 + lane * VEC;
    const bool mine = c < D;  // with VEC 4, D % 4 == 0: the whole float4
    float acc[VEC] = {};
    int run = -1;
    for (int k0 = 0; k0 < kChunk; k0 += kInFlight) {
      float v[kInFlight][VEC];
      int bag[kInFlight];
      float wk[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        bag[u] = __shfl_sync(kFull, my_bag, k0 + u);
        wk[u] = __shfl_sync(kFull, my_w, k0 + u);
        const int id = __shfl_sync(kFull, my_id, k0 + u);
        if (bag[u] >= 0 && mine) {
          load_row<VEC>(table + (long long)id * D + c, v[u]);
        } else {
#pragma unroll
          for (int j = 0; j < VEC; ++j) v[u][j] = 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        if (bag[u] < 0) continue;
        if (bag[u] != run) {
          if (run >= 0 && mine) flush<VEC>(out + (long long)run * D + c, acc);
          run = bag[u];
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[j] = 0.0f;
        }
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(wk[u], v[u][j]));
      }
    }
    if (run >= 0 && mine) flush<VEC>(out + (long long)run * D + c, acc);
  }
}

}  // namespace

// table (V, D) f32; ids, seg (n,) int32; w (n,) f32; out (num_bags, D) f32.
// The float4 path needs D % 4 == 0 and a 16-byte aligned table; out comes
// from the caching allocator, aligned to far more.
extern "C" int embedding_bag_launch(const void* table, int V, int D, const void* ids,
                                    const void* seg, const void* w, long long n, int num_bags,
                                    void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t rc = cudaMemsetAsync(out, 0, sizeof(float) * (size_t)num_bags * D, st);
  if (rc != cudaSuccess) return (int)rc;
  if (n > 0) {
    const long long per_block = (long long)kWarps * kChunk;
    const unsigned blocks = (unsigned)((n + per_block - 1) / per_block);
    const bool vec = D % 4 == 0 && ((size_t)table % 16) == 0 && ((size_t)out % 16) == 0;
    if (vec) {
      embedding_bag_kernel<4><<<blocks, kThreads, 0, st>>>(
          (const float*)table, V, D, (const int*)ids, (const int*)seg, (const float*)w, n,
          num_bags, (float*)out);
    } else {
      embedding_bag_kernel<1><<<blocks, kThreads, 0, st>>>(
          (const float*)table, V, D, (const int*)ids, (const int*)seg, (const float*)w, n,
          num_bags, (float*)out);
    }
  }
  return (int)cudaGetLastError();
}
