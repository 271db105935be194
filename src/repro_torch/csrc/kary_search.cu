// Model-free predecessor search over a sorted table: the kernel backend of
// the L, Q, C, KO and BTREE kinds, and the batched backend of every kind
// without a fused batched kernel.
//
// Replaces repro/kernels/kary_search.py:kary_search_pallas and
// batched_kary_search_pallas: a lane-wide k = 128 fence compare for a TPU
// vector unit, ending in one lane-wide sweep over <= k keys.  Predecessor
// ranks do not depend on k; here each query runs the trips of a binary
// (Khuong-Morin) search, k = 2, and ends, as the TPU kernel does, in a
// sweep (of <= kSweep keys).
//
// Bound on the H100: the dependent loads, not the bytes.  At 2^24 keys the
// table (128 MiB) is larger than the 50 MB L2, and a one-thread-a-query
// binary search makes ceil(log2 n) + 1 gathers, each waiting on the last:
// the upper levels hit L1/L2, the last few miss to HBM.  The design:
//   1. The first T = min(kTreeLevels, ceil(log2 n)) trips probe positions
//      that depend only on n and the comparisons so far: a complete tree of
//      2^T - 1 keys.  Each block of a persistent grid stages those keys
//      once in shared memory, in Eytzinger order (node i's children are 2i
//      and 2i + 1), and every query walks node = 2 node + (key <= q) for T
//      trips with no global load.  The window holds ceil(n / 2^j) keys
//      before trip j whatever the path, so `base` is rebuilt on the way.
//   2. Global trips follow until the window holds <= kSweep keys; their
//      count depends on n only, the same for every query.
//   3. The last log2(kSweep) + 1 dependent gathers become one sweep
//      (sweep_rank): the warp loads each of its queries' windows whole, a
//      coalesced 256-byte load a window, and counts the keys <= q; the
//      rank is base + count - 1.
// The persistent grid (SMs x resident blocks, grid-stride over the queries)
// keeps the staging to one 8 KB copy a block; a launch of one block a
// 512 queries would restage it 8,192 times at 2^22 queries.  In the batched
// kernel, while one table's queries fill the resident blocks, the blocks
// take the tables in turn, restaging the tree for each: blocks spread over
// every table at once would keep the whole tier's keys in use at once, and
// a tier of 4 shards of 2^22 keys then misses L2 as a single 2^24-key table
// does.  A smaller batch leaves resident blocks idle, so the grid's rows
// (blockIdx.y) take that many tables side by side.  The plain PyTorch twins
// are _kary_body and _batched_kary_body in kernels/kary_search.py, whose
// TREE_LEVELS and SWEEP are these constants.

#include "search_common.cuh"

// T: 1,023 staged keys, 8 KB.  At 2^24 keys T = 12 (32 KB) is level with
// it (within 1.5%), but a block then stages four times the keys, which
// at a few queries a table is most of the launch (PERF.md, kary_bench.py).
constexpr int kTreeLevels = 10;
constexpr int kSweep = 32;  // W: 256 bytes, two or three 128-byte lines
constexpr int kKaryThreads = 512;
constexpr int kWarp = 32;
static_assert(kSweep >= 1 && kSweep <= kWarp, "a window is loaded by one warp, a key a lane");

// The persistent grid: as many blocks as the device holds at once (SMs x
// resident blocks of `kernel`), and no more than one table's queries need;
// the blocks left idle by a small batch hold further tables side by side,
// one row of the grid (blockIdx.y) each.
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, long long nq, int n_tables, dim3* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kKaryThreads, 0);
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long need = nq > 0 ? (nq + kKaryThreads - 1) / kKaryThreads : 1;
  const long long x = need < resident ? need : resident;
  const long long y = resident / x < n_tables ? resident / x : n_tables;
  *grid = dim3((unsigned)x, (unsigned)(y > 1 ? y : 1));
  return e;
}

// Trips served by the staged tree: ceil(log2 n) capped at kTreeLevels, so
// the window is still wider than one key at every staged trip (n >= 1).
__device__ __forceinline__ int tree_levels(int n) {
  return min(kTreeLevels, 32 - __clz((unsigned)(n - 1)));
}

// Stage the keys the first tree_levels(n) trips probe: node i (1-based, at
// depth d = floor(log2 i)) is the probe reached by the path of i's bits
// below the leading one, MSB first, 1 = right.  Every thread of the block
// must call it.
__device__ __forceinline__ void stage_tree(const long long* __restrict__ table, int n,
                                           long long* tree) {
  const int levels = tree_levels(n);
  for (int node = 1 + threadIdx.x; node < (1 << levels); node += blockDim.x) {
    const int d = 31 - __clz((unsigned)node);
    int base = 0, len = n;
    for (int j = d - 1; j >= 0; --j) {
      const int half = len >> 1;
      base += ((node >> j) & 1) ? half : 0;
      len -= half;
    }
    tree[node] = __ldg(table + base + (len >> 1));
  }
  __syncthreads();
}

// Predecessor rank of q in the window [base, base + len), len <= kSweep and
// the same for every lane: lane p's window is loaded whole by the warp in
// pass p (one pass a lane), one key a lane, all loads issued before the
// first ballot, and the count of its keys <= q is the popcount of the
// pass's ballot.  The window's keys before `base` are <= q (or base is 0),
// those after its end > q.  Every lane of the warp must call it.
__device__ __forceinline__ int sweep_rank(const long long* __restrict__ table, int base, int len,
                                          long long q) {
  const int lane = threadIdx.x & 31;
  unsigned le = 0;  // bit p: this lane's key of lane p's window is <= lane p's query
#pragma unroll
  for (int p = 0; p < kWarp; ++p) {
    const int ob = __shfl_sync(0xffffffffu, base, p);
    const long long oq = __shfl_sync(0xffffffffu, q, p);
    if (lane < len && __ldg(table + ob + lane) <= oq) le |= 1u << p;
  }
  int count = 0;
#pragma unroll
  for (int p = 0; p < kWarp; ++p) {
    const unsigned m = __ballot_sync(0xffffffffu, (le >> p) & 1u);
    if (lane == p) count = __popc(m);
  }
  return base + count - 1;
}

// Predecessor ranks of queries[0, nq) over table[0, n) (tree staged), one
// warp-aligned slice of 32 queries at a time: the tail's missing queries
// run as dummies (q = 0) so every lane joins the sweep, and are not stored.
__device__ __forceinline__ void kary_queries(const long long* __restrict__ table, int n,
                                             const long long* tree,
                                             const long long* __restrict__ queries, long long nq,
                                             int* __restrict__ out) {
  const int levels = tree_levels(n);
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i0 = (long long)blockIdx.x * blockDim.x + (threadIdx.x - lane); i0 < nq;
       i0 += stride) {
    const long long i = i0 + lane;
    const bool live = i < nq;
    const long long q = live ? queries[i] : 0;
    int node = 1, base = 0, len = n;
    for (int j = 0; j < levels; ++j) {
      const int half = len >> 1;
      const int right = tree[node] <= q;
      base += right ? half : 0;
      node = 2 * node + right;
      len -= half;
    }
    while (len > kSweep) {  // len depends on n only: the same trips for every lane
      const int half = len >> 1;
      base = __ldg(table + base + half) <= q ? base + half : base;
      len -= half;
    }
    const int rank = sweep_rank(table, base, len, q);
    if (live) out[i] = rank;
  }
}

extern "C" __global__ void __launch_bounds__(kKaryThreads)
    kary_search_kernel(const long long* __restrict__ table, int n,
                       const long long* __restrict__ queries, long long nq,
                       int* __restrict__ out) {
  __shared__ long long tree[1 << kTreeLevels];
  stage_tree(table, n, tree);
  kary_queries(table, n, tree, queries, nq, out);
}

// Table t of `n_tables`: row t of `tables` (n keys each), row t of
// `queries` (stride q_stride, 0 when one batch is broadcast to every
// table) and row t of `out` (nq ranks).  The blocks of grid row y take the
// tables y, y + gridDim.y, ... in turn; with one row, the grid works on one
// table (at a tier's shard size, one that fits in L2) at a time.
extern "C" __global__ void __launch_bounds__(kKaryThreads)
    batched_kary_search_kernel(const long long* __restrict__ tables, int n_tables, int n,
                               const long long* __restrict__ queries, long long q_stride,
                               long long nq, int* __restrict__ out) {
  __shared__ long long tree[1 << kTreeLevels];
  for (long long t = blockIdx.y; t < n_tables; t += gridDim.y) {
    if (t != blockIdx.y) __syncthreads();  // every warp is done with the last table's tree
    stage_tree(tables + t * n, n, tree);
    kary_queries(tables + t * n, n, tree, queries + t * q_stride, nq, out + t * nq);
  }
}

extern "C" int kary_search_launch(const void* table, int n, const void* queries, long long nq,
                                  void* out, void* stream) {
  dim3 grid;
  const cudaError_t e = persistent_grid(kary_search_kernel, nq, 1, &grid);
  if (e != cudaSuccess) return (int)e;
  kary_search_kernel<<<grid, kKaryThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)table, n, (const long long*)queries, nq, (int*)out);
  return (int)cudaGetLastError();
}

extern "C" int batched_kary_search_launch(const void* tables, int n_tables, int n,
                                          const void* queries, long long q_stride, long long nq,
                                          void* out, void* stream) {
  dim3 grid;
  const cudaError_t e = persistent_grid(batched_kary_search_kernel, nq, n_tables, &grid);
  if (e != cudaSuccess) return (int)e;
  batched_kary_search_kernel<<<grid, kKaryThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)tables, n_tables, n, (const long long*)queries, q_stride, nq, (int*)out);
  return (int)cudaGetLastError();
}
