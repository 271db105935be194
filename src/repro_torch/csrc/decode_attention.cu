// Flash-decode GQA attention: one new token per row attends over its KV
// cache, with an online softmax over tiles of positions.
//
// Replaces repro/kernels/decode_attention.py:decode_attention_pallas
// (_decode_kernel), whose grid walks (row, KV tile) in order and carries the
// running max m, sum l and accumulator acc in VMEM scratch.  Here one block
// owns one (row b, KV head) pair and walks the tiles itself, so the state
// stays in shared memory and registers; the `group = Hq / Hkv` query heads
// of that KV head share every K/V tile, as the TPU kernel folds q into
// (Hkv, group).  Per tile of kTile positions:
//   A. logits: thread t takes position s0 + t, reads its K row and forms
//      q . k / sqrt(D) for each of the group's heads (q in shared memory,
//      read by every thread at one address); positions >= kv_len get -1e30;
//   B. softmax update: one warp a head takes the tile's max, rescales
//      (alpha = exp(m_prev - m_new)), turns logits into p (0 past kv_len)
//      and adds their sum into l;
//   C. PV: thread (slot, d) adds p * V[s][d] over the positions of its slot
//      into a register accumulator per head, rescaled by alpha first.
// The slots' accumulators are summed at the end and divided by
// max(l, 1e-30), which gives 0 for a row with kv_len = 0.  Tiles wholly at
// or past kv_len are skipped: there alpha = 1 and p = 0, so skipping them
// changes no bit.  Everything is f32 inside; K/V/q/out are float (the TPU
// kernel's interface) or bf16 (the model's cache).
//
// Bound on the H100: bytes.  The K and V rows up to kv_len are read once
// (4 B a value pair per position and dimension in bf16) against 2 * group
// multiply-adds per value pair, far below the tensor-core line.  This first
// design reads each tile straight from global memory with no prefetch and
// one block per (row, KV head), so a long row's block walks its tiles alone
// (no split over the sequence); the plain form comes first, speed is later
// work.  The plain PyTorch twin is _decode_body in
// kernels/decode_attention.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;  // positions a tile = threads a block
constexpr int kWarps = kTile / 32;
constexpr int kMaxGroup = 16;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Eight consecutive values of a row as f32 (16-byte aligned loads).
__device__ __forceinline__ void load8(const float* __restrict__ p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* __restrict__ p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
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

// Block (b, h) of a (B * Hkv) grid, kTile threads.  q (B, Hq, D); k, v
// (B, S, Hkv, D); out (B, Hq, D); all contiguous.  D is a power of two in
// [8, kTile]; group <= kMaxGroup.  Shared memory: q_s (group, D), p_s
// (group, kTile), and m, l, alpha (group each).
template <typename T>
__global__ void __launch_bounds__(kTile)
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const int* __restrict__ kv_len,
                            T* __restrict__ out, int S, int hkv, int D, int group) {
  extern __shared__ float smem[];
  float* q_s = smem;
  float* p_s = q_s + group * D;
  float* m_s = p_s + group * kTile;
  float* l_s = m_s + group;
  float* alpha_s = l_s + group;

  const int b = blockIdx.x / hkv;
  const int h = blockIdx.x % hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int hq = hkv * group;
  const long long row = (long long)hkv * D;  // elements between positions
  const T* kb = k + (long long)b * S * row + (long long)h * D;
  const T* vb = v + (long long)b * S * row + (long long)h * D;
  const float sqrt_d = sqrtf((float)D);
  const int n_valid = min(max(kv_len[b], 0), S);

  for (int i = tid; i < group * D; i += kTile) {
    q_s[i] = to_f32(q[((long long)b * hq + (long long)h * group) * D + i]);
  }
  for (int j = tid; j < group; j += kTile) {
    m_s[j] = kNegInf;
    l_s[j] = 0.0f;
  }

  // PV mapping: `slots` threads share each dimension d, splitting positions.
  const int slots = kTile / D;
  const int d = tid % D;
  const int slot = tid / D;
  float acc[kMaxGroup];
#pragma unroll
  for (int j = 0; j < kMaxGroup; ++j) acc[j] = 0.0f;
  __syncthreads();

  for (int s0 = 0; s0 < n_valid; s0 += kTile) {
    // A. logits for position s0 + tid
    const int s = s0 + tid;
    if (s < n_valid) {
      float dot[kMaxGroup];
#pragma unroll
      for (int j = 0; j < kMaxGroup; ++j) dot[j] = 0.0f;
      const T* kr = kb + (long long)s * row;
      for (int e0 = 0; e0 < D; e0 += 8) {
        float x[8];
        load8(kr + e0, x);
#pragma unroll
        for (int j = 0; j < kMaxGroup; ++j) {
          if (j < group) {
            const float* qj = q_s + j * D + e0;
#pragma unroll
            for (int e = 0; e < 8; ++e) dot[j] = fmaf(qj[e], x[e], dot[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kMaxGroup; ++j) {
        if (j < group) p_s[j * kTile + tid] = dot[j] / sqrt_d;
      }
    } else {
      for (int j = 0; j < group; ++j) p_s[j * kTile + tid] = kNegInf;
    }
    __syncthreads();

    // B. online softmax update, one warp a head
    for (int j = warp; j < group; j += kWarps) {
      float* pj = p_s + j * kTile;
      float m_cur = kNegInf;
      for (int t = lane; t < kTile; t += 32) m_cur = fmaxf(m_cur, pj[t]);
      m_cur = warp_max(m_cur);
      const float m_prev = m_s[j];
      const float m_new = fmaxf(m_prev, m_cur);
      float sum = 0.0f;
      for (int t = lane; t < kTile; t += 32) {
        const float p = (s0 + t < n_valid) ? expf(pj[t] - m_new) : 0.0f;
        pj[t] = p;
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
    for (int j = 0; j < kMaxGroup; ++j) {
      if (j < group) acc[j] *= alpha_s[j];
    }
    const int t_end = min(kTile, n_valid - s0);
    for (int t = slot; t < t_end; t += slots) {
      const float x = to_f32(vb[(long long)(s0 + t) * row + d]);
#pragma unroll
      for (int j = 0; j < kMaxGroup; ++j) {
        if (j < group) acc[j] = fmaf(p_s[j * kTile + t], x, acc[j]);
      }
    }
    __syncthreads();
  }

  // Sum the slots' accumulators (p_s holds group * kTile = slots * group * D
  // floats) and write acc / max(l, 1e-30).
#pragma unroll
  for (int j = 0; j < kMaxGroup; ++j) {
    if (j < group) p_s[(slot * group + j) * D + d] = acc[j];
  }
  __syncthreads();
  for (int i = tid; i < group * D; i += kTile) {
    const int j = i / D;
    float sum = 0.0f;
    for (int sl = 0; sl < slots; ++sl) sum += p_s[sl * group * D + i];
    store(out + ((long long)b * hq + (long long)h * group) * D + i, sum / fmaxf(l_s[j], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* kv_len, void* out, int B,
           int S, int hkv, int D, int group, void* stream) {
  const size_t smem = sizeof(float) * ((size_t)group * D + (size_t)group * kTile + 3 * group);
  decode_attention_kernel<T><<<(unsigned)(B * hkv), kTile, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)kv_len, (T*)out, S, hkv, D, group);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype 0: float, 1: bf16.  The wrapper checks shapes, D (a power of two in
// [8, 256]), group <= 16 and 16-byte alignment.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* kv_len, void* out, int B, int S, int hkv, int D,
                                       int group, int dtype, void* stream) {
  if (dtype == 1) {
    return launch<__nv_bfloat16>(q, k, v, kv_len, out, B, S, hkv, D, group, stream);
  }
  return launch<float>(q, k, v, kv_len, out, B, S, hkv, D, group, stream);
}
