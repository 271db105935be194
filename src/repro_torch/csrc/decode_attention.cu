// Flash-decode GQA attention: one new token per row attends over its KV
// cache, with an online softmax over tiles of positions, the sequence split
// over blocks (flash-decoding) and K/V tiles streamed through cp.async
// rings.
//
// Replaces repro/kernels/decode_attention.py:decode_attention_pallas
// (_decode_kernel), whose grid walks (row, KV tile) in order and carries the
// running max m, sum l and accumulator acc in VMEM scratch.  The TPU walks
// one row's tiles in order on one core; the H100 has 132 SMs that must all
// stream, so here:
//
// * Grid (B * Hkv, n_split).  Block (b, h, sp) takes the sp-th tile-aligned
//   share of row b's own length kv_len[b] (read on the device): the row's
//   ceil(kv_len / tile) tiles are cut into n_split runs of
//   ceil(n_tiles / n_split); a share may be empty.  The wrapper picks
//   n_split from B * Hkv and the SM count, so a short serving cache and a
//   few long rows fill the card alike.
// * Within a block, the TPU kernel's per-tile online softmax for the
//   `group = Hq / Hkv` query heads of the KV head, f32 state, in one of two
//   kernels:
//   - bf16 at D in {16, 32, 64, 128} (the serving path): tensor cores
//     (decode_attention_mma_kernel, below), each of 4 warps on its own
//     tiles with its own ring, no block barrier in the tile loop;
//   - f32, and bf16 at D 8 or 256: CUDA cores (decode_attention_kernel),
//     the block's 256 threads on one tile at a time:
//     A. logits: thread (position, head run) forms q . k / sqrt(D) from the
//        K tile in shared memory, q in shared memory as f32 (16-byte loads
//        of 8 dimensions, four partial sums a head); positions >= kv_len
//        get -1e30;
//     B. softmax update: one warp a head takes the tile's max, rescales
//        (alpha = exp(m_prev - m_new)), turns logits into p (0 past kv_len)
//        and adds their sum into l;
//     C. PV: thread (slot, 4 dimensions) keeps acc for all heads in
//        registers and adds p * V over its slot's positions, 4 heads' p in
//        one 16-byte load, rescaled by alpha first.
// * K/V tiles arrive through rings of kStages shared-memory stages filled
//   by 16-byte cp.async copies (coalesced: a position's head row is D
//   contiguous values); while tile i is computed, tiles i+1 and i+2 are in
//   flight.  Rows are padded by 16 bytes so the 16-byte reads (and
//   ldmatrix) hit distinct banks.
// * One launch combines the shares (finish): each block writes its (m, l,
//   acc) to an f32 scratch (an empty share writes m = -1e30, l = 0,
//   acc = 0), fences, and takes a ticket from a per-(b, h) counter; the
//   block that takes the last ticket reads every share through L2 and
//   writes sum_s e^(m_s - M) acc_s / max(sum_s e^(m_s - M) l_s, 1e-30) with
//   M = max_s m_s, then resets the counter to 0 for the next launch, so no
//   memset is needed.  With n_split == 1 the block writes the output
//   itself.  A row with kv_len = 0 gives 0, as acc / max(l, 1e-30) does.
// * On request (lse != nullptr) the block that writes a row's output also
//   writes its log-sum-exp m + log(l) (-1e30 for a row with no valid
//   position) from the (m, l) it already holds, and the output in f32:
//   a caller that holds one sequence block of the cache (a rank of a
//   mesh) combines the blocks' outputs with these weights, rounding once.
// * K and V may be a slice of a larger cache's KV heads: a position holds
//   kv_heads >= Hkv heads (positions kv_heads * D elements apart, rows S
//   positions apart).
// * Both are a compile-time variant (kExt, a rank's call): the default
//   call (no lse, contiguous K/V) builds the plain address arithmetic and
//   stores.
//
// Bound on the H100: bytes.  The K and V rows up to kv_len are read once
// (4 B a value pair per position and dimension in bf16) against 2 * group
// multiply-adds a value pair.  The design spends its effort on bytes in
// flight, on filling the SMs, and, for bf16, on taking the arithmetic off
// the CUDA cores: there the per-tile barriers and shared-memory loads of
// the CUDA-core kernel, not bytes, bound it (3.8x the byte bound at qwen2's
// decode_32k cell on an H100).  The plain PyTorch twins are _decode_body
// (one pass) and _decode_split_body (this split and combine) in
// kernels/decode_attention.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;       // K/V tiles in the ring
constexpr int kMaxGroup = 16;    // query heads a KV head
constexpr int kMaxTile = 64;     // positions a tile
constexpr float kNegInf = -1e30f;
constexpr int kMaxDevices = 64;  // devices a process may launch on

struct Args {
  const void* q;        // (B, Hq, D)
  const void* k;        // (B, S, Hkv, D)
  const void* v;        // (B, S, Hkv, D)
  const int* kv_len;    // (B,)
  void* out;            // (B, Hq, D): T, or f32 when lse is set
  float* part_acc;      // (B * Hkv, n_split, group, D), n_split > 1 only
  float* part_ml;       // (B * Hkv, n_split, group, 2): m, l
  int* counter;         // (B * Hkv,), 0 between launches
  int S, hkv, D, group, tile, n_split;
  unsigned q_off;       // bytes of shared memory before q_s
  // a rank's call (kExt) only, after the default call's fields:
  float* lse;           // (B, Hq) or nullptr
  int kv_heads;         // KV heads a position of K and V holds (>= hkv)
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Eight consecutive values as f32 (16-byte aligned shared-memory loads).
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
// Four consecutive values as f32 (16- or 8-byte aligned).
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Element i of the block's (group, D) output (out = a.out + qo): T, or
// f32 with the lse.
template <typename T, bool kExt>
__device__ __forceinline__ void put(const Args& a, T* out, long long qo, int i, float x) {
  if (kExt && a.lse != nullptr) {
    static_cast<float*>(a.out)[qo + i] = x;
  } else {
    store(out + i, x);
  }
}
// Head j's log-sum-exp from its (m, l): -1e30 where no position was valid.
template <bool kExt>
__device__ __forceinline__ void put_lse(const Args& a, long long qo, int j, float m, float l) {
  if (kExt && a.lse != nullptr) a.lse[qo / a.D + j] = l > 0.0f ? m + logf(l) : kNegInf;
}

// The block's (m, l, acc) over its share are in shared memory: m_s, l_s
// (group each) and acc_s (group, D).  With n_split == 1 the block writes
// acc / max(l, 1e-30).  Otherwise it writes its share to the scratch and
// takes a ticket; the block with the last ticket of (b, h) reads every
// share through L2, writes sum_s e^(m_s - M) acc_s / max(sum_s e^(m_s - M)
// l_s, 1e-30) with M = max_s m_s, and resets the counter.  The block that
// writes the output writes the lse too, when asked.
template <typename T, bool kExt>
__device__ void finish(const Args& a, float* m_s, float* l_s, const float* acc_s, int bh, int sp,
                       long long qo) {
  __shared__ int s_last;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int group = a.group, D = a.D;
  T* out = static_cast<T*>(a.out) + qo;
  if (a.n_split == 1) {
    for (int i = tid; i < group * D; i += nt) {
      put<T, kExt>(a, out, qo, i, acc_s[i] / fmaxf(l_s[i / D], 1e-30f));
    }
    if (tid < group) put_lse<kExt>(a, qo, tid, m_s[tid], l_s[tid]);
    return;
  }
  const long long share = (long long)bh * a.n_split + sp;
  float* pacc = a.part_acc + share * group * D;
  for (int i = tid; i < group * D; i += nt) pacc[i] = acc_s[i];
  if (tid < group) {
    a.part_ml[(share * group + tid) * 2] = m_s[tid];
    a.part_ml[(share * group + tid) * 2 + 1] = l_s[tid];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(a.counter + bh, 1) == a.n_split - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // the loops over shares are unrolled so that several L2 reads are in
  // flight at once
  const long long first = (long long)bh * a.n_split;
  if (tid < group) {
    float mx = kNegInf;
#pragma unroll 8
    for (int s = 0; s < a.n_split; ++s) {
      mx = fmaxf(mx, __ldcg(a.part_ml + ((first + s) * group + tid) * 2));
    }
    float l = 0.0f;
#pragma unroll 8
    for (int s = 0; s < a.n_split; ++s) {
      const float* ml = a.part_ml + ((first + s) * group + tid) * 2;
      l += expf(__ldcg(ml) - mx) * __ldcg(ml + 1);
    }
    m_s[tid] = mx;
    l_s[tid] = l;
    put_lse<kExt>(a, qo, tid, mx, l);
  }
  __syncthreads();
  for (int i = tid; i < group * D; i += nt) {
    const int j = i / D;
    const float mx = m_s[j];
    float sum = 0.0f;
#pragma unroll 8
    for (int s = 0; s < a.n_split; ++s) {
      const float w = expf(__ldcg(a.part_ml + ((first + s) * group + j) * 2) - mx);
      sum += w * __ldcg(a.part_acc + (first + s) * group * D + i);
    }
    put<T, kExt>(a, out, qo, i, sum / fmaxf(l_s[j], 1e-30f));
  }
  if (tid == 0) a.counter[bh] = 0;
}

// Shared memory, in order: the K/V ring (kStages x {K, V} x tile rows of
// D + 16 bytes; after the loop it holds the slots' accumulators), then at
// a.q_off q_s (group, D), p_s (tile, gp), m_s, l_s, alpha_s (kMaxGroup each).
// kG (4, 8 or 16) bounds the group, so phase C's accumulators take 4 * kG
// registers: groups up to 8 fit three blocks on an SM (85 registers).
template <typename T, int kG, bool kExt>
__global__ void __launch_bounds__(kThreads, kG <= 8 ? 3 : 2) decode_attention_kernel(Args a) {
  constexpr int kMaxRun = (kG + 3) / 4;  // phase A heads a thread: kG / (kThreads / kMaxTile)
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = a.D, group = a.group, tile = a.tile;
  const int rs = D + 16 / (int)sizeof(T);  // ring row stride, elements
  const int gp = (group + 3) & ~3;
  T* ring = reinterpret_cast<T*>(smem);
  float* q_s = reinterpret_cast<float*>(smem + a.q_off);
  float* p_s = q_s + group * D;
  float* m_s = p_s + tile * gp;
  float* l_s = m_s + kMaxGroup;
  float* alpha_s = l_s + kMaxGroup;

  const int bh = blockIdx.x, sp = blockIdx.y;
  const int b = bh / a.hkv, h = bh % a.hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hq = a.hkv * group;
  const long long row = (long long)(kExt ? a.kv_heads : a.hkv) * D;  // elements between positions
  const T* kb = static_cast<const T*>(a.k) + (long long)b * a.S * row + (long long)h * D;
  const T* vb = static_cast<const T*>(a.v) + (long long)b * a.S * row + (long long)h * D;
  const long long qo = ((long long)b * hq + (long long)h * group) * D;  // q / out offset

  // this block's share: tiles [t_begin, t_end) of the row's own length
  const int n = min(max(a.kv_len[b], 0), a.S);
  const int n_tiles = (n + tile - 1) / tile;
  const int per = (n_tiles + a.n_split - 1) / a.n_split;
  const int t_begin = min(n_tiles, sp * per);
  const int my_tiles = min(n_tiles, t_begin + per) - t_begin;

  const int cpr = D * (int)sizeof(T) / 16;  // 16-byte chunks a row
  const int epc = 16 / (int)sizeof(T);      // elements a chunk
  auto load_tile = [&](int i, int stage) {
    const int s0 = (t_begin + i) * tile;
    const int chunks = min(tile, n - s0) * cpr;
    T* ks = ring + (size_t)stage * 2 * tile * rs;
    T* vs = ks + (size_t)tile * rs;
    for (int c = tid; c < 2 * chunks; c += kThreads) {
      const bool is_v = c >= chunks;
      const int cc = is_v ? c - chunks : c;
      const int r = cc / cpr, e = (cc % cpr) * epc;
      const long long src = (long long)(s0 + r) * row + e;
      cp_async16((is_v ? vs : ks) + r * rs + e, (is_v ? vb : kb) + src);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < my_tiles) load_tile(s, s);
    cp_async_commit();
  }

  const T* qg = static_cast<const T*>(a.q) + qo;
  for (int i = tid; i < group * D; i += kThreads) q_s[i] = to_f32(qg[i]);
  for (int j = tid; j < kMaxGroup; j += kThreads) {
    m_s[j] = kNegInf;
    l_s[j] = 0.0f;
  }

  // phase A: position pa, heads [j0, j0 + run)
  const int tpp = kThreads / tile;
  const int run = (group + tpp - 1) / tpp;
  const int pa = tid % tile;
  const int j0 = (tid / tile) * run;
  const float sqrt_d = sqrtf((float)D);
  // phase C: dimensions [d0, d0 + 4), positions slot, slot + slots, ...
  const int slots = kThreads / (D / 4);
  const int d0 = (tid % (D / 4)) * 4;
  const int slot = tid / (D / 4);
  float acc[kG][4];
#pragma unroll
  for (int j = 0; j < kG; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  }

  for (int it = 0; it < my_tiles; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile it is in; every thread is past tile it - 1
    if (it + kStages - 1 < my_tiles) load_tile(it + kStages - 1, (it + kStages - 1) % kStages);
    cp_async_commit();
    const T* ks = ring + (size_t)(it % kStages) * 2 * tile * rs;
    const T* vs = ks + (size_t)tile * rs;
    const int valid = min(tile, n - (t_begin + it) * tile);

    // A. logits, four partial sums a head so the multiply-adds do not wait
    // on each other
    {
      float dot[kMaxRun][4];
#pragma unroll
      for (int r = 0; r < kMaxRun; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) dot[r][c] = 0.0f;
      }
      if (pa < valid) {
        const T* kr = ks + pa * rs;
        for (int e0 = 0; e0 < D; e0 += 8) {
          float x[8];
          load8(kr + e0, x);
#pragma unroll
          for (int r = 0; r < kMaxRun; ++r) {
            if (r < run && j0 + r < group) {
              float qv[8];
              load8(q_s + (j0 + r) * D + e0, qv);
#pragma unroll
              for (int e = 0; e < 8; ++e) dot[r][e & 3] = fmaf(qv[e], x[e], dot[r][e & 3]);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kMaxRun; ++r) {
        if (r < run && j0 + r < group) {
          const float dr = (dot[r][0] + dot[r][1]) + (dot[r][2] + dot[r][3]);
          p_s[pa * gp + j0 + r] = pa < valid ? dr / sqrt_d : kNegInf;
        }
      }
    }
    __syncthreads();

    // B. online softmax update, one warp a head
    for (int j = warp; j < group; j += kWarps) {
      float mx = kNegInf;
      for (int t = lane; t < tile; t += 32) mx = fmaxf(mx, p_s[t * gp + j]);
      mx = warp_max(mx);
      const float m_prev = m_s[j];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int t = lane; t < tile; t += 32) {
        const float p = t < valid ? expf(p_s[t * gp + j] - m_new) : 0.0f;
        p_s[t * gp + j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[j] = alpha;
        m_s[j] = m_new;
        l_s[j] = l_s[j] * alpha + sum;
      }
    }
    __syncthreads();

    // C. acc = acc * alpha + p . V over this slot's positions
#pragma unroll
    for (int j = 0; j < kG; ++j) {
      if (j < group) {
        const float al = alpha_s[j];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] *= al;
      }
    }
    for (int t = slot; t < valid; t += slots) {
      float x[4];
      load4(vs + t * rs + d0, x);
      const float* pt = p_s + t * gp;
#pragma unroll
      for (int j4 = 0; j4 < kG; j4 += 4) {
        if (j4 < group) {
          const float4 p4 = *reinterpret_cast<const float4*>(pt + j4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[j4][e] = fmaf(p4.x, x[e], acc[j4][e]);
            acc[j4 + 1][e] = fmaf(p4.y, x[e], acc[j4 + 1][e]);
            acc[j4 + 2][e] = fmaf(p4.z, x[e], acc[j4 + 2][e]);
            acc[j4 + 3][e] = fmaf(p4.w, x[e], acc[j4 + 3][e]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: sum the slots' accumulators there

  float* red = reinterpret_cast<float*>(smem);  // (slots, group, D)
#pragma unroll
  for (int j = 0; j < kG; ++j) {
    if (j < group) {
      *reinterpret_cast<float4*>(red + (slot * group + j) * D + d0) =
          make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
    }
  }
  __syncthreads();
  for (int i = tid; i < group * D; i += kThreads) {
    float sum = red[i];
    for (int sl = 1; sl < slots; ++sl) sum += red[sl * group * D + i];
    red[i] = sum;  // slot 0's row holds the block's acc
  }
  __syncthreads();
  finish<T, kExt>(a, m_s, l_s, red, bh, sp, qo);
}

// ---- bf16 on the tensor cores ----------------------------------------------
//
// For bf16 and D in {16, 32, 64, 128}: each warp of the block runs its own
// online softmax over every fourth 16-position tile of the block's share,
// with its own cp.async ring, so the tile loop needs no block barrier.
//   QK:  S (16 query heads, zero-padded past the group, x 16 positions) by
//        mma.m16n8k16 with f32 accumulators: q fragments stay in
//        registers, K fragments come by ldmatrix.  bf16 x bf16 products
//        are exact in f32, so only the order of the sums differs.
//   softmax on the accumulator fragments: each thread holds 4 logits of
//        rows g and g + 8; row maxima across the quad by two shuffles.
//   PV:  p split into p_hi + p_lo, both bf16 (p_hi = bf16(p), p_lo =
//        bf16(p - p_hi)), two MMAs against V fragments from ldmatrix.trans:
//        p is never rounded to bf16 once, which the bf16 check's one
//        rounding of an f32 result would not absorb.
// Rows past a tile's valid positions are zero-filled by the copy, so no
// stale value meets a zero p.  The four warps' states are combined in
// shared memory, then as a share (finish).

constexpr int kMmaWarps = 4;
constexpr int kMmaTile = 16;  // positions a warp tile

__device__ __forceinline__ void cp_async16_zfill(unsigned dst, const void* src, bool full) {
  const int n = full ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned& r0, unsigned& r1, unsigned& r2,
                                        unsigned& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned addr, unsigned& r0, unsigned& r1, unsigned& r2,
                                          unsigned& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&x)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ unsigned as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned*>(&v);
}
// p0, p1 (adjacent columns) as bf16 pairs hi and lo with hi + lo ~ p.
__device__ __forceinline__ void split_bf16(float p0, float p1, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(p0 - __low2float(h), p1 - __high2float(h)));
}

// Shared memory: each warp's ring (kStages x {K, V} x 16 rows of 2 D + 16
// bytes); after the loop, the warps' (m, l, acc) and the block's.
template <int D, bool kExt>
__global__ void __launch_bounds__(kMmaWarps * 32) decode_attention_mma_kernel(Args a) {
  constexpr int kSteps = D / 16;       // k-steps of QK
  constexpr int kBlocks = D / 8;       // n-blocks of PV
  constexpr int kRow = D * 2 + 16;     // ring row stride, bytes
  constexpr int kStage = 2 * kMmaTile * kRow;
  constexpr int kChunks = D * 2 / 16;  // 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char smem[];
  const int group = a.group;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const unsigned ring =
      (unsigned)__cvta_generic_to_shared(smem) + (unsigned)(warp * kStages * kStage);

  const int bh = blockIdx.x, sp = blockIdx.y;
  const int b = bh / a.hkv, h = bh % a.hkv;
  const int hq = a.hkv * group;
  const long long row = (long long)(kExt ? a.kv_heads : a.hkv) * D;
  const __nv_bfloat16* kb =
      static_cast<const __nv_bfloat16*>(a.k) + (long long)b * a.S * row + (long long)h * D;
  const __nv_bfloat16* vb =
      static_cast<const __nv_bfloat16*>(a.v) + (long long)b * a.S * row + (long long)h * D;
  const long long qo = ((long long)b * hq + (long long)h * group) * D;

  const int n = min(max(a.kv_len[b], 0), a.S);
  const int n_tiles = (n + kMmaTile - 1) / kMmaTile;
  const int per = (n_tiles + a.n_split - 1) / a.n_split;
  const int t_begin = min(n_tiles, sp * per);
  const int my_tiles = min(n_tiles, t_begin + per) - t_begin;
  // this warp's tiles: warp, warp + 4, ... of the share
  const int w_tiles = my_tiles > warp ? (my_tiles - warp + kMmaWarps - 1) / kMmaWarps : 0;

  auto load = [&](int i, int stage) {
    const int s0 = (t_begin + warp + i * kMmaWarps) * kMmaTile;
    const int valid = min(kMmaTile, n - s0);
    const unsigned st = ring + stage * kStage;
    for (int c = lane; c < 2 * kMmaTile * kChunks; c += 32) {
      const bool is_v = c >= kMmaTile * kChunks;
      const int cc = is_v ? c - kMmaTile * kChunks : c;
      const int r = cc / kChunks, e = (cc % kChunks) * 8;
      const bool full = r < valid;
      const __nv_bfloat16* src = (is_v ? vb : kb) + (long long)(s0 + (full ? r : 0)) * row + e;
      cp_async16_zfill(st + (is_v ? kMmaTile * kRow : 0) + r * kRow + e * 2, src, full);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < w_tiles) load(s, s);
    cp_async_commit();
  }

  // q fragments (rows g and g + 8 of the group, zero past it)
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(a.q) + qo;
  unsigned qa[kSteps][4];
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int hr = g + (r & 1) * 8;
      const int col = ks * 16 + c2 + (r >> 1) * 8;
      qa[ks][r] = hr < group ? *reinterpret_cast<const unsigned*>(qg + hr * D + col) : 0u;
    }
  }
  const float sqrt_d = sqrtf((float)D);
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.0f, 0.0f};
  float acc[kBlocks][4];
#pragma unroll
  for (int nb = 0; nb < kBlocks; ++nb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.0f;
  }
  // ldmatrix row addresses: K (positions x dims) plain, V transposed
  const int k_row = (lane & 7) + ((lane >> 4) & 1) * 8, k_col = ((lane >> 3) & 1) * 8;
  const int v_row = (lane & 7) + ((lane >> 3) & 1) * 8, v_col = ((lane >> 4) & 1) * 8;

  for (int i = 0; i < w_tiles; ++i) {
    cp_async_wait<kStages - 2>();
    __syncwarp();  // tile i is in; every lane is past tile i - 1
    if (i + kStages - 1 < w_tiles) load(i + kStages - 1, (i + kStages - 1) % kStages);
    cp_async_commit();
    const int valid = min(kMmaTile, n - (t_begin + warp + i * kMmaWarps) * kMmaTile);
    const unsigned ks_s = ring + (i % kStages) * kStage;
    const unsigned vs_s = ks_s + kMmaTile * kRow;

    // QK: sc[nb] holds positions nb * 8 + c2 (+1) of rows g (0, 1), g + 8 (2, 3)
    float sc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      unsigned b0, b1, b2, b3;
      ldsm_x4(ks_s + k_row * kRow + (ks * 16 + k_col) * 2, b0, b1, b2, b3);
      mma_bf16(sc[0], qa[ks], b0, b1);
      mma_bf16(sc[1], qa[ks], b2, b3);
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = nb * 8 + c2 + (e & 1) < valid;
        sc[nb][e] = ok ? sc[nb][e] / sqrt_d : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[nb][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);
      alpha[r] = expf(m_r[r] - m_new);
      m_r[r] = m_new;
    }
    float ps[2] = {0.0f, 0.0f};
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = nb * 8 + c2 + (e & 1) < valid;
        const float p = ok ? expf(sc[nb][e] - m_r[e >> 1]) : 0.0f;
        sc[nb][e] = p;
        ps[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + ps[r];
#pragma unroll
    for (int nb = 0; nb < kBlocks; ++nb) {
      acc[nb][0] *= alpha[0];
      acc[nb][1] *= alpha[0];
      acc[nb][2] *= alpha[1];
      acc[nb][3] *= alpha[1];
    }

    // PV: P (16 rows x 16 positions) as the A operand, hi and lo
    unsigned ph[4], pl[4];
    split_bf16(sc[0][0], sc[0][1], ph[0], pl[0]);
    split_bf16(sc[0][2], sc[0][3], ph[1], pl[1]);
    split_bf16(sc[1][0], sc[1][1], ph[2], pl[2]);
    split_bf16(sc[1][2], sc[1][3], ph[3], pl[3]);
#pragma unroll
    for (int n0 = 0; n0 < D; n0 += 16) {
      unsigned b0, b1, b2, b3;
      ldsm_x4_t(vs_s + v_row * kRow + (n0 + v_col) * 2, b0, b1, b2, b3);
      mma_bf16(acc[n0 / 8], ph, b0, b1);
      mma_bf16(acc[n0 / 8], pl, b0, b1);
      mma_bf16(acc[n0 / 8 + 1], ph, b2, b3);
      mma_bf16(acc[n0 / 8 + 1], pl, b2, b3);
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
  __syncthreads();  // every warp is out of its ring

  // the warps' states, then the block's: wm, wl (4, 16), wacc (4, 16, D)
  float* wm = reinterpret_cast<float*>(smem);
  float* wl = wm + kMmaWarps * 16;
  float* wacc = wl + kMmaWarps * 16;
  float* m_s = wacc + kMmaWarps * 16 * D;
  float* l_s = m_s + 16;
  float* acc_s = l_s + 16;  // (group, D)
  if ((lane & 3) == 0) {
    wm[warp * 16 + g] = m_r[0];
    wm[warp * 16 + g + 8] = m_r[1];
    wl[warp * 16 + g] = l_r[0];
    wl[warp * 16 + g + 8] = l_r[1];
  }
#pragma unroll
  for (int nb = 0; nb < kBlocks; ++nb) {
    float* lo = wacc + (warp * 16 + g) * D + nb * 8 + c2;
    *reinterpret_cast<float2*>(lo) = make_float2(acc[nb][0], acc[nb][1]);
    *reinterpret_cast<float2*>(lo + 8 * D) = make_float2(acc[nb][2], acc[nb][3]);
  }
  __syncthreads();
  if (tid < group) {
    float mxb = kNegInf;
    for (int w = 0; w < kMmaWarps; ++w) mxb = fmaxf(mxb, wm[w * 16 + tid]);
    float l = 0.0f;
    for (int w = 0; w < kMmaWarps; ++w) l += expf(wm[w * 16 + tid] - mxb) * wl[w * 16 + tid];
    m_s[tid] = mxb;
    l_s[tid] = l;
  }
  __syncthreads();
  for (int i = tid; i < group * D; i += kMmaWarps * 32) {
    const int j = i / D, d = i % D;
    float sum = 0.0f;
    for (int w = 0; w < kMmaWarps; ++w) {
      sum += expf(wm[w * 16 + j] - m_s[j]) * wacc[(w * 16 + j) * D + d];
    }
    acc_s[i] = sum;
  }
  __syncthreads();
  finish<__nv_bfloat16, kExt>(a, m_s, l_s, acc_s, bh, sp, qo);
}

// Raises kernel's dynamic shared-memory limit to smem on the current
// device when above what was set there before: the opt-in above 48 KB is
// a property of (kernel, device), so allowed holds one size a device.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem, size_t* allowed) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (smem <= allowed[dev]) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  allowed[dev] = smem;
  return 0;
}

template <int D, bool kExt>
int launch_mma(Args a, int B, void* stream) {
  const size_t ring = (size_t)kMmaWarps * kStages * 2 * kMmaTile * (D * 2 + 16);
  const size_t state = sizeof(float) * ((size_t)kMmaWarps * 16 * (D + 2) + 32 + 16 * (size_t)D);
  const size_t smem = ring > state ? ring : state;
  static size_t allowed[kMaxDevices] = {};
  const int e = allow_smem(decode_attention_mma_kernel<D, kExt>, smem, allowed);
  if (e != 0) return e;
  const dim3 grid((unsigned)(B * a.hkv), (unsigned)a.n_split);
  decode_attention_mma_kernel<D, kExt><<<grid, kMmaWarps * 32, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int kG, bool kExt>
int launch(Args a, int B, void* stream) {
  const size_t rs_bytes = (size_t)a.D * sizeof(T) + 16;
  const size_t ring = (size_t)kStages * 2 * a.tile * rs_bytes;
  const size_t red = (size_t)4 * kThreads * a.group * sizeof(float);  // slots * group * D floats
  a.q_off = (unsigned)(ring > red ? ring : red);
  const int gp = (a.group + 3) & ~3;
  const size_t smem =
      a.q_off + sizeof(float) * ((size_t)a.group * a.D + (size_t)a.tile * gp + 3 * kMaxGroup);
  static size_t allowed[kMaxDevices] = {};
  const int e = allow_smem(decode_attention_kernel<T, kG, kExt>, smem, allowed);
  if (e != 0) return e;
  const dim3 grid((unsigned)(B * a.hkv), (unsigned)a.n_split);
  decode_attention_kernel<T, kG, kExt><<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool kExt>
int dispatch(Args a, int B, int dtype, void* stream) {
  if (dtype == 1 && a.D >= 16 && a.D <= 128) {  // the tensor-core kernel, 16-position tiles
    if (a.tile != kMmaTile) return (int)cudaErrorInvalidValue;
    if (a.D == 16) return launch_mma<16, kExt>(a, B, stream);
    if (a.D == 32) return launch_mma<32, kExt>(a, B, stream);
    if (a.D == 64) return launch_mma<64, kExt>(a, B, stream);
    return launch_mma<128, kExt>(a, B, stream);
  }
  if (dtype == 1) {
    if (a.group <= 4) return launch<__nv_bfloat16, 4, kExt>(a, B, stream);
    if (a.group <= 8) return launch<__nv_bfloat16, 8, kExt>(a, B, stream);
    return launch<__nv_bfloat16, 16, kExt>(a, B, stream);
  }
  if (a.group <= 4) return launch<float, 4, kExt>(a, B, stream);
  if (a.group <= 8) return launch<float, 8, kExt>(a, B, stream);
  return launch<float, 16, kExt>(a, B, stream);
}

}  // namespace

// dtype 0: float, 1: bf16.  The wrapper checks shapes, D (a power of two in
// [8, 256]), group <= 16, tile (a power of two in [8, 64] with tile * D *
// itemsize <= 8 KiB), 16-byte alignment, K/V's strides (kv_heads), picks
// n_split (>= 1), and allocates the output (f32 when lse is not null), the
// lse, the scratch (part_acc, part_ml: n_split > 1 only) and the zeroed
// per-(b, h) counter of the stream.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* kv_len, void* out, void* lse, void* part_acc,
                                       void* part_ml, void* counter, int B, int S, int hkv, int D,
                                       int kv_heads, int group, int tile, int n_split,
                                       int dtype, void* stream) {
  Args a{q, k, v, static_cast<const int*>(kv_len), out, static_cast<float*>(part_acc),
         static_cast<float*>(part_ml), static_cast<int*>(counter), S, hkv, D, group, tile,
         n_split, 0u, static_cast<float*>(lse), kv_heads};
  if (tile < 8 || tile > kMaxTile || group < 1 || group > kMaxGroup ||
      kv_heads < hkv) {
    return (int)cudaErrorInvalidValue;
  }
  if (lse != nullptr || kv_heads != hkv) return dispatch<true>(a, B, dtype, stream);
  return dispatch<false>(a, B, dtype, stream);
}
