// Single-token GQA decode attention against a KV cache, split over the
// sequence (flash decoding).
//
// Replaces src/repro/kernels/flash_decode/kernel.py :: flash_decode_gqa
// (pallas_call at kernel.py:82, body _kernel). The TPU kernel walks S in
// 512-key blocks along a sequential grid axis per (b, kv head), carrying
// the online-softmax state (m, l, acc) in VMEM scratch; at decode batch
// sizes that is B·K programs, which would fill 4 of the H100's 132 SMs at
// RecurrentGemma-9B's shape. Here S is split into 128-key chunks that run
// as independent blocks, each writing a partial (m, l, acc) in fp32, and a
// second kernel merges the partials with their log-sum-exp weights.
//
// q: (B, H, hd); k, v: (B, S, K, hd) in fp32 or bf16; length: (B,) int32;
// window ≤ 0 means none. Key t of batch b is valid when
// t < min(length[b], S) and, with a window, t ≥ length[b] − window.
// Masked scores are −1e30 and l is clamped at 1e−30, as in the TPU kernel;
// scale 1/√hd; all arithmetic in fp32. G = H/K ≤ 16, hd ≤ 256 and a
// multiple of 8; the S tail is masked, nothing is padded.
//
// Bound: memory. The valid keys' rows of K and V are read once
// (2·B·S·K·hd·2 bytes in bf16: 8.39 MB, 2.5 µs at 3.35 TB/s at B = 4,
// S = 2048, K = 1, hd = 256), against 4·B·H·S·hd flops (2.0 µs at the fp32
// 67 TFLOP/s the kernel's CUDA-core arithmetic runs at).
//
// Design, split kernel: grid (ceil(S/128), B·K), 128 threads. q's G rows
// go to shared memory as fp32. Score pass: thread i takes key c0 + i,
// reads its K row with 16-byte loads and dots it with all G query rows
// (broadcast reads of shared memory); invalid keys load nothing. Softmax:
// warp w reduces heads w, w+4, ... over the chunk. Value pass: thread i
// owns dimensions 2i and 2i+1 and walks the chunk's valid keys, so each
// V row is read once, coalesced; masked keys (weight exactly 0) load
// nothing. Both passes unroll by 4 to keep loads in flight. A chunk that
// holds no valid key while some other chunk does writes m = −1e30, l = 0
// and returns before loading anything. Only when no key of a row is valid
// at all does every chunk compute, and the result is then the mean of V
// over S, as the masked full softmax gives.
// Combine kernel: one block per (b, h) row, thread i merges dimensions 2i
// and 2i+1 over the splits. No wgmma or TMA: a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;     // threads per block and keys per split
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 16;     // G = H / K
constexpr int kMaxHeadDim = 256;  // hd; 2 dimensions per thread
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Eight consecutive elements, 16-byte aligned.
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  out[0] = lo.x; out[1] = lo.y; out[2] = lo.z; out[3] = lo.w;
  out[4] = hi.x; out[5] = hi.y; out[6] = hi.z; out[7] = hi.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* pair = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(pair[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// Two consecutive elements.
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One 128-key chunk (blockIdx.x) of one (b, kv head) (blockIdx.y = b·K + kh)
// → partial (m, l, acc) for its G heads at part row
// (blockIdx.x·B·K + blockIdx.y)·G + g.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_decode_split(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ length,
                   float* __restrict__ part_m, float* __restrict__ part_l,
                   float* __restrict__ part_acc, int seq, int kv_heads,
                   int group, int head_dim, int window, float scale) {
  __shared__ float q_s[kMaxGroup * kMaxHeadDim];
  __shared__ float p_s[kMaxGroup][kThreads];
  __shared__ float m_s[kMaxGroup], l_s[kMaxGroup];

  const int tid = threadIdx.x;
  const int bk = blockIdx.y;
  const int bi = bk / kv_heads;
  const int c0 = blockIdx.x * kThreads;
  const int c1 = min(c0 + kThreads, seq);
  const int len = length[bi];
  const int hi = min(len, seq);
  const int lo = window > 0 ? max(len - window, 0) : 0;
  const long long row0 = ((long long)blockIdx.x * gridDim.y + bk) * group;

  if (lo < hi && (c1 <= lo || c0 >= hi)) {
    for (int g = tid; g < group; g += kThreads) {
      part_m[row0 + g] = kMasked;
      part_l[row0 + g] = 0.0f;
    }
    for (int i = tid; i < group * head_dim; i += kThreads)
      part_acc[row0 * head_dim + i] = 0.0f;
    return;
  }

  const T* qb = q + (long long)bk * group * head_dim;
  for (int i = tid; i < group * head_dim; i += kThreads)
    q_s[i] = to_float(qb[i]);
  __syncthreads();

  const long long key_stride = (long long)kv_heads * head_dim;
  const long long kv0 = (long long)bi * seq * key_stride +
                        (long long)(bk % kv_heads) * head_dim;
  const int t = c0 + tid;
  float s[kMaxGroup];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) s[g] = 0.0f;
  if (t >= lo && t < hi) {
    const T* kr = k + kv0 + (long long)t * key_stride;
#pragma unroll 4
    for (int d = 0; d < head_dim; d += 8) {
      float kv8[8];
      load8(kr + d, kv8);
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g < group) {
          const float* qg = q_s + g * head_dim + d;
#pragma unroll
          for (int j = 0; j < 8; ++j) s[g] += qg[j] * kv8[j];
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) s[g] *= scale;
  } else {
    // A masked key scores −1e30; a position past S does not exist.
    const float fill = t < c1 ? kMasked : -INFINITY;
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) s[g] = fill;
  }
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g)
    if (g < group) p_s[g][tid] = s[g];
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  for (int g = warp; g < group; g += kWarps) {
    float m = -INFINITY;
    for (int j = lane; j < kThreads; j += 32) m = fmaxf(m, p_s[g][j]);
    m = warp_max(m);
    float l = 0.0f;
    for (int j = lane; j < kThreads; j += 32) {
      const float p = expf(p_s[g][j] - m);
      p_s[g][j] = p;
      l += p;
    }
    l = warp_sum(l);
    if (lane == 0) {
      m_s[g] = m;
      l_s[g] = l;
    }
  }
  __syncthreads();

  const int d0 = 2 * tid;
  float acc[kMaxGroup][2];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) acc[g][0] = acc[g][1] = 0.0f;
  // Keys outside [lo, hi) have weight exactly 0 here unless no key of the
  // row is valid, so only the valid ones are read.
  const int j0 = lo < hi ? max(c0, lo) : c0;
  const int j1 = lo < hi ? min(c1, hi) : c1;
  if (d0 < head_dim) {
#pragma unroll 4
    for (int j = j0; j < j1; ++j) {
      const float2 vv = load2(v + kv0 + (long long)j * key_stride + d0);
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g < group) {
          const float p = p_s[g][j - c0];
          acc[g][0] += p * vv.x;
          acc[g][1] += p * vv.y;
        }
      }
    }
  }

  if (tid < group) {
    part_m[row0 + tid] = m_s[tid];
    part_l[row0 + tid] = l_s[tid];
  }
  if (d0 < head_dim) {
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g)
      if (g < group)
        *reinterpret_cast<float2*>(part_acc + (row0 + g) * head_dim + d0) =
            make_float2(acc[g][0], acc[g][1]);
  }
}

// One (b, h) row (blockIdx.x = b·H + h) merged over the splits.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_decode_combine(const float* __restrict__ part_m,
                     const float* __restrict__ part_l,
                     const float* __restrict__ part_acc, T* __restrict__ out,
                     int n_splits, long long rows, int head_dim) {
  const long long row = blockIdx.x;
  float m = -INFINITY;
  for (int i = 0; i < n_splits; ++i) m = fmaxf(m, part_m[i * rows + row]);
  const int d0 = 2 * threadIdx.x;
  float l = 0.0f, acc0 = 0.0f, acc1 = 0.0f;
  for (int i = 0; i < n_splits; ++i) {
    const long long r = i * rows + row;
    const float w = expf(part_m[r] - m);
    l += w * part_l[r];
    if (d0 < head_dim) {
      const float2 a = *reinterpret_cast<const float2*>(part_acc + r * head_dim + d0);
      acc0 += w * a.x;
      acc1 += w * a.y;
    }
  }
  if (d0 < head_dim) {
    const float denom = fmaxf(l, 1e-30f);
    store(out + row * head_dim + d0, acc0 / denom);
    store(out + row * head_dim + d0 + 1, acc1 / denom);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* length,
           void* part_m, void* part_l, void* part_acc, void* out, int batch,
           int seq, int heads, int kv_heads, int head_dim, int window,
           float scale, cudaStream_t stream) {
  const int group = heads / kv_heads;
  const int n_splits = (seq + kThreads - 1) / kThreads;
  const dim3 grid(n_splits, batch * kv_heads);
  flash_decode_split<T><<<grid, kThreads, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)length,
      (float*)part_m, (float*)part_l, (float*)part_acc, seq, kv_heads, group,
      head_dim, window, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_decode_combine<T><<<(unsigned)(batch * heads), kThreads, 0, stream>>>(
      (const float*)part_m, (const float*)part_l, (const float*)part_acc,
      (T*)out, n_splits, (long long)batch * heads, head_dim);
  return (int)cudaGetLastError();
}

}  // namespace

// Pointers on the device, contiguous: q (B, H, hd), k, v (B, S, K, hd),
// length (B,) int32, out (B, H, hd) in q's type; part_m, part_l
// (ceil(S/128), B·H) and part_acc (ceil(S/128), B·H, hd) fp32 scratch.
// bf16 != 0 selects bfloat16 inputs, else fp32. Launches both kernels on
// `stream` and returns cudaGetLastError().
extern "C" int flash_decode(const void* q, const void* k, const void* v,
                            const void* length, void* part_m, void* part_l,
                            void* part_acc, void* out, int batch, int seq,
                            int heads, int kv_heads, int head_dim, int window,
                            float scale, int bf16, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, length, part_m, part_l, part_acc,
                                 out, batch, seq, heads, kv_heads, head_dim,
                                 window, scale, s);
  return launch<float>(q, k, v, length, part_m, part_l, part_acc, out, batch,
                       seq, heads, kv_heads, head_dim, window, scale, s);
}
