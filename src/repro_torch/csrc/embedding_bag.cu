// EmbeddingBag: out[bag] = sum over items i with seg[i] == bag of
// w[i] * table[ids[i]], a row gather plus a segmented weighted sum.
//
// Replaces repro/kernels/embedding_bag.py:embedding_bag_pallas (_bag_kernel),
// which walks vocabulary tiles and forms each bag's sum as two one-hot
// matrix products on the TPU's matrix unit, because row gathers from VMEM
// are serialised there.  The H100 gathers rows directly, so here one warp
// takes one item: it reads the item's id, bag and weight once, then its
// lanes stride over the D columns of the table row and add w * row into
// the bag's output row with f32 atomics.  seg need not be sorted, as on
// the TPU.  An id outside [0, V) or a bag outside [0, num_bags) adds
// nothing (the one-hot products give such an item no row), and the
// launcher zeroes out before the kernel runs.  The atomics make the order
// of each bag's sum run-dependent: results agree with the plain version to
// a tolerance, not bit for bit.
//
// Bound on the H100: bytes.  Each item reads one table row (4 D bytes) and
// 12 bytes of id, bag and weight; each bag writes one row.  One multiply-add
// per value read is far below the f32 rate.  This first design does one
// atomic per value and no reduction of a sorted run of items in registers;
// the plain form comes first, speed is later work.  The plain PyTorch twin
// is _bag_body in kernels/embedding_bag.py.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItemsPerBlock = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
    embedding_bag_kernel(const float* __restrict__ table, int V, int D,
                         const int* __restrict__ ids, const int* __restrict__ seg,
                         const float* __restrict__ w, long long n, int num_bags,
                         float* __restrict__ out) {
  const long long item = (long long)blockIdx.x * kItemsPerBlock + (threadIdx.x >> 5);
  if (item >= n) return;
  const int lane = threadIdx.x & 31;
  const int id = __ldg(ids + item);
  const int bag = __ldg(seg + item);
  if (id < 0 || id >= V || bag < 0 || bag >= num_bags) return;
  const float wi = __ldg(w + item);
  const float* __restrict__ src = table + (long long)id * D;
  float* dst = out + (long long)bag * D;
  for (int c = lane; c < D; c += 32) atomicAdd(dst + c, wi * __ldg(src + c));
}

}  // namespace

// table (V, D) f32; ids, seg (n,) int32; w (n,) f32; out (num_bags, D) f32.
extern "C" int embedding_bag_launch(const void* table, int V, int D, const void* ids,
                                    const void* seg, const void* w, long long n, int num_bags,
                                    void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t rc = cudaMemsetAsync(out, 0, sizeof(float) * (size_t)num_bags * D, st);
  if (rc != cudaSuccess) return (int)rc;
  if (n > 0) {
    const long long blocks = (n + kItemsPerBlock - 1) / kItemsPerBlock;
    embedding_bag_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
        (const float*)table, V, D, (const int*)ids, (const int*)seg, (const float*)w, n, num_bags,
        (float*)out);
  }
  return (int)cudaGetLastError();
}
