// Single-token GQA decode attention against a KV cache, split over the
// sequence (flash decoding).
//
// Replaces src/repro/kernels/flash_decode/kernel.py :: flash_decode_gqa
// (pallas_call at kernel.py:82, body _kernel). The TPU kernel walks S in
// 512-key blocks along a sequential grid axis per (b, kv head), carrying
// the online-softmax state (m, l, acc) in VMEM scratch; at decode batch
// sizes that is B·K programs, which would fill 4 of the H100's 132 SMs at
// RecurrentGemma-9B's shape. Here S is split into C-key chunks that run
// as independent blocks, each writing a partial (m, l, acc) in fp32, and a
// second kernel merges the partials with their log-sum-exp weights.
//
// q: (B, H, hd); k, v: (B, S, K, hd) in fp32 or bf16; length: (B,) int32;
// window ≤ 0 means none. Key t of batch b is valid when
// t < min(length[b], S) and, with a window, t ≥ length[b] − window.
// Masked scores are −1e30 and l is clamped at 1e−30, as in the TPU kernel;
// scale 1/√hd; the softmax and P·V in fp32. G = H/K ≤ 16, hd ≤ 256 and a
// multiple of 8; the S tail is masked, nothing is padded. A chunk that
// holds no valid key while some other chunk of the row does writes
// m = −1e30, l = 0 and returns before loading anything. Only when no key
// of a row is valid does every chunk load its V rows, and the result is
// then the mean of V over S, as the masked full softmax gives.
//
// Bound: memory. The valid keys' rows of K and V are read once
// (2·B·S·K·hd·2 bytes in bf16: 8.39 MB, 2.52 µs at 3.35 TB/s on the SXM
// card at B = 4, S = 2048, K = 1, hd = 256), against 4·B·H·S·hd flops.
// What stood between the first version and that bound was latency: 64
// blocks of 4 warps, each thread walking its own rows with dependent
// loads, kept ~130 KB in flight where the card needs ~2.3 MB.
//
// Design, split kernel: grid (ceil(S/C), B·K) of 256 threads, C = 64 keys
// per block (128 blocks at the serving shape; of C ∈ {32, 64, 128}, 64
// measured fastest: 32 doubles the combine's reads, 128 leaves half the
// SMs idle; scripts/kernel_ab.py --keys-per-block rebuilds with another C
// through -DKEYS_PER_BLOCK to time it). At 8.4 MB the read is one wave,
// so the time is the load latency plus what each block computes after its
// tile lands; the design puts every byte in flight at entry and keeps the
// compute after it short.
// 1. On entry one lane of each warp issues bulk copies (cp.async.bulk,
//    the Tensor Memory Accelerator's path: no tensor map, no registers
//    per byte) of its share of q's rows and the chunk's valid K rows,
//    then V rows, into dynamic shared memory: the whole tile (32 KB
//    apiece in bf16 at C = 64) is in flight at once. One lane per warp,
//    because the copy takes warp-uniform operands: 32 lanes with distinct
//    rows compile to a loop over the lanes. Each 8-row group of K and of
//    V completes on its own mbarrier, q on another. Rows carry 16 bytes
//    of padding, which spreads a column over all banks.
// 2. Scores, each 8-key group as soon as its K rows have landed. bf16:
//    tensor cores, mma.sync.m16n8k16 (bf16 × bf16 → fp32); q is the A
//    operand, its rows G..15 zeroed in shared memory so no lane branches,
//    warp w takes 8 keys at a time as the B operand. Products of bf16
//    values are exact in fp32, so only the order of the sums differs
//    from the plain version. fp32: CUDA cores, 256/C threads per key,
//    each dotting every (256/C)-th 16-byte piece of the row with all G
//    query rows, then a shuffle sum; no TF32.
// 3. Scale, mask and softmax of each head over the chunk in fp32 in one
//    pass (warp w: heads w and w + 8, interleaved).
// 4. P·V on CUDA cores in fp32, as the TPU kernel's jnp.dot(p, v): warp
//    w owns heads w and w + 8, lane i dimensions 8i..8i+7. Each whole
//    8-key group of the chunk's valid keys waits once on its barrier and
//    issues its 8 16-byte V loads together; the ragged ends go key by
//    key (keys outside [j0, j1) have weight exactly 0 and their rows are
//    not loaded). Each warp writes its heads' partial acc to global
//    memory, 32 bytes a lane.
// Combine kernel: one block per (b, h) row and 128 dimensions, its 256
// threads as 8 groups of splits × 32 float4 columns, every load of a
// partial independent of the others. It stays a second kernel: merging
// in the last split block would pull 512 KB of partials per (b, kv head)
// through one SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;     // threads per split block
constexpr int kWarps = kThreads / 32;
#ifndef KEYS_PER_BLOCK
#define KEYS_PER_BLOCK 64
#endif
constexpr int kSplit = KEYS_PER_BLOCK;   // C, keys per split block
static_assert(kSplit % 32 == 0 && kThreads % kSplit == 0,
              "C is 32, 64, 128 or 256");
constexpr int kMaxGroup = 16;     // G = H / K
constexpr int kMaxHeadDim = 256;  // hd; 8 dimensions per lane
static_assert(kMaxHeadDim == 8 * 32, "one warp's lanes span hd");
constexpr int kRowPad = 16;       // bytes after each K, V and q row
constexpr int kCombineThreads = 256;
constexpr int kCombineDims = 128;    // dimensions per combine block
constexpr int kCombineGroups = kCombineThreads / (kCombineDims / 4);
constexpr float kMasked = -1e30f;

__host__ __device__ constexpr int row_bytes(int head_dim, int elem) {
  return head_dim * elem + kRowPad;
}

// Dynamic shared memory of one split block: K and V tiles (C rows each),
// q (G rows), the chunk's scores (kMaxGroup × C fp32), m and l.
__host__ __device__ constexpr int split_smem_bytes(int split, int head_dim,
                                                   int elem) {
  return (2 * split + kMaxGroup) * row_bytes(head_dim, elem) +
         kMaxGroup * split * 4 + 2 * kMaxGroup * 4;
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
// Each barrier completes one phase per launch: wait for parity 0.
__device__ __forceinline__ void mbar_wait(uint64_t* bar) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar))
        : "memory");
  }
}
// One contiguous row of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from global to shared memory through the bulk-copy engine,
// completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Eight consecutive elements from shared memory, 16-byte aligned.
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

__device__ __forceinline__ uint32_t lds32(const char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D += A · B for one 16-dimension step at byte offset `off` of the rows:
// A = q rows gid and gid + 8 (16 × 16), B = K row gid (16 × 8, as K^T).
// `hi` is false only for the half step of hd % 16 == 8, whose upper 8
// dimensions are then zero.
__device__ __forceinline__ void mma_step(float* d, const char* qa,
                                         const char* qb, const char* kr,
                                         int off, bool hi) {
  const uint32_t a0 = lds32(qa + off), a1 = lds32(qb + off);
  const uint32_t a2 = hi ? lds32(qa + off + 16) : 0u;
  const uint32_t a3 = hi ? lds32(qb + off + 16) : 0u;
  const uint32_t b0 = lds32(kr + off);
  const uint32_t b1 = hi ? lds32(kr + off + 16) : 0u;
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Raw scores (before scale and mask) of the chunk's keys [0, C) for every
// head, into p_s[g][j], each 8-key group as soon as its K rows (barrier
// k_bar[j / 8]) have landed. A key whose K row was not loaded scores
// garbage, which the softmax's mask overwrites.
template <typename T, int C>
struct Scores;

// bf16: D (16 × 8) += A (16 × 16, q) · B (16 × 8, K^T), fp32 sums, on
// tensor cores. q's rows G..15 are zero in shared memory, so every lane
// loads its A fragment without a branch; two accumulator chains take the
// even and odd 16-dimension steps.
template <int C>
struct Scores<__nv_bfloat16, C> {
  static __device__ __forceinline__ void run(const char* q_s, const char* k_s,
                                             float* p_s, uint64_t* k_bar,
                                             int group, int head_dim) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int gid = lane / 4, tig = lane % 4;
    const int pitch = row_bytes(head_dim, 2);
    const char* qa = q_s + gid * pitch + 4 * tig;
    const char* qb = qa + 8 * pitch;
    for (int nt = warp; nt < C / 8; nt += kWarps) {
      mbar_wait(&k_bar[nt]);
      const char* kr = k_s + (nt * 8 + gid) * pitch + 4 * tig;
      float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float e[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      int k0 = 0;
#pragma unroll 2
      for (; k0 + 32 <= head_dim; k0 += 32) {
        mma_step(d, qa, qb, kr, 2 * k0, true);
        mma_step(e, qa, qb, kr, 2 * k0 + 32, true);
      }
      for (; k0 < head_dim; k0 += 16)
        mma_step(d, qa, qb, kr, 2 * k0, k0 + 8 < head_dim);
      const int j = nt * 8 + 2 * tig;
      *reinterpret_cast<float2*>(&p_s[gid * C + j]) =
          make_float2(d[0] + e[0], d[1] + e[1]);
      *reinterpret_cast<float2*>(&p_s[(gid + 8) * C + j]) =
          make_float2(d[2] + e[2], d[3] + e[3]);
    }
  }
};

// fp32: kThreads / C threads per key, each over every (kThreads/C)-th
// 16-byte piece of the row, then summed across them with shuffles.
template <int C>
struct Scores<float, C> {
  static __device__ __forceinline__ void run(const char* q_s, const char* k_s,
                                             float* p_s, uint64_t* k_bar,
                                             int group, int head_dim) {
    constexpr int kPer = kThreads / C;   // 2, 4 or 8 lanes per key
    const int j = threadIdx.x / kPer, part = threadIdx.x % kPer;
    mbar_wait(&k_bar[j / 8]);
    const int pitch = row_bytes(head_dim, 4);
    const float* krow = reinterpret_cast<const float*>(k_s + j * pitch);
    float s[kMaxGroup];
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) s[g] = 0.0f;
    for (int d = 4 * part; d < head_dim; d += 4 * kPer) {
      const float4 kv = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g < group) {
          const float4 qv =
              *reinterpret_cast<const float4*>(q_s + g * pitch + d * 4);
          s[g] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
#pragma unroll
      for (int o = kPer / 2; o > 0; o >>= 1)
        s[g] += __shfl_xor_sync(0xffffffffu, s[g], o);
      if (g < group && part == 0) p_s[g * C + j] = s[g];
    }
  }
};

// One C-key chunk (blockIdx.x) of one (b, kv head) (blockIdx.y = b·K + kh)
// → partial (m, l, acc) for its G heads at part row
// (blockIdx.x·B·K + blockIdx.y)·G + g.
template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
flash_decode_split(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ length,
                   float* __restrict__ part_m, float* __restrict__ part_l,
                   float* __restrict__ part_acc, int seq, int kv_heads,
                   int group, int head_dim, int window, float scale) {
  constexpr int kHeadsPerWarp = kMaxGroup / kWarps;   // heads w, w + 8
  static_assert(kHeadsPerWarp == 2, "P·V keeps two heads a warp");
  constexpr int kKeysPerLane = C / 32;
  extern __shared__ __align__(16) char smem[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * (C / 8)];
  const int pitch = row_bytes(head_dim, sizeof(T));
  char* k_s = smem;
  char* v_s = k_s + C * pitch;
  char* q_s = v_s + C * pitch;
  float* p_s = reinterpret_cast<float*>(q_s + kMaxGroup * pitch);
  float* m_s = p_s + kMaxGroup * C;
  float* l_s = m_s + kMaxGroup;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int bk = blockIdx.y;
  const int bi = bk / kv_heads;
  const int c0 = blockIdx.x * C;
  const int c1 = min(c0 + C, seq);
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

  // The chunk's valid keys [j0, j1); with no valid key in the row, every
  // key of the chunk (each weighs the same).
  const int j0 = lo < hi ? max(c0, lo) : c0;
  const int j1 = lo < hi ? min(c1, hi) : c1;
  const int n_k = lo < hi ? j1 - j0 : 0;   // K rows to score
  const long long key_stride = (long long)kv_heads * head_dim;
  const T* kb = k + (long long)bi * seq * key_stride +
                (long long)(bk % kv_heads) * head_dim;
  const T* vb = v + (kb - k);
  const T* qb = q + (long long)bk * group * head_dim;
  const uint32_t row_len = head_dim * sizeof(T);
  // Barriers: q, then one per 8 keys of K, then one per 8 keys of V.
  // Thread 0 posts every barrier's byte count before any copy starts.
  uint64_t* q_bar = bars;
  uint64_t* k_bar = bars + 1;
  uint64_t* v_bar = k_bar + C / 8;
  if (tid == 0) {
    for (int i = 0; i < 1 + 2 * (C / 8); ++i) mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(q_bar, group * row_len);
    for (int i = 0; i < C / 8; ++i) {
      const int rows = max(0, min(j1, c0 + 8 * i + 8) - max(j0, c0 + 8 * i));
      mbar_expect_tx(&k_bar[i], n_k > 0 ? rows * row_len : 0u);
      mbar_expect_tx(&v_bar[i], rows * row_len);
    }
  }
  // q's rows G..15 are zero: the mma's A operand reads all 16.
  for (int i = group * pitch / 16 + tid; i < kMaxGroup * pitch / 16;
       i += kThreads)
    reinterpret_cast<uint4*>(q_s)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  // q rows, K rows, then V rows; lane 0 of warp w issues copies w, w + 8,
  // ... (a bulk copy takes warp-uniform operands: one lane issuing keeps
  // the compiler from looping over the lanes' distinct rows).
  if (lane == 0)
    for (int i = warp; i < group + n_k + (j1 - j0); i += kWarps) {
      if (i < group) {
        bulk_copy(q_s + i * pitch, qb + i * head_dim, row_len, q_bar);
      } else if (i < group + n_k) {
        const int r = j0 + i - group;
        bulk_copy(k_s + (r - c0) * pitch, kb + r * key_stride, row_len,
                  &k_bar[(r - c0) / 8]);
      } else {
        const int r = j0 + i - group - n_k;
        bulk_copy(v_s + (r - c0) * pitch, vb + r * key_stride, row_len,
                  &v_bar[(r - c0) / 8]);
      }
    }
  mbar_wait(q_bar);
  if (n_k > 0) Scores<T, C>::run(q_s, k_s, p_s, k_bar, group, head_dim);
  __syncthreads();

  // Scale, mask (a masked key scores −1e30, a position past S −inf) and
  // softmax of heads w and w + 8 over the chunk, the two interleaved.
  if (warp < group) {
    float sv[kHeadsPerWarp][kKeysPerLane], m[kHeadsPerWarp];
#pragma unroll
    for (int u = 0; u < kHeadsPerWarp; ++u) {
      m[u] = -INFINITY;
#pragma unroll
      for (int i = 0; i < kKeysPerLane; ++i) {
        const int j = lane + 32 * i, t = c0 + j;
        sv[u][i] = (t >= lo && t < hi)
                       ? p_s[(warp + u * kWarps) * C + j] * scale
                       : (t < c1 ? kMasked : -INFINITY);
        m[u] = fmaxf(m[u], sv[u][i]);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < kHeadsPerWarp; ++u)
        m[u] = fmaxf(m[u], __shfl_xor_sync(0xffffffffu, m[u], o));
    float l[kHeadsPerWarp];
#pragma unroll
    for (int u = 0; u < kHeadsPerWarp; ++u) {
      l[u] = 0.0f;
#pragma unroll
      for (int i = 0; i < kKeysPerLane; ++i) {
        const float p = expf(sv[u][i] - m[u]);
        p_s[(warp + u * kWarps) * C + lane + 32 * i] = p;
        l[u] += p;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < kHeadsPerWarp; ++u)
        l[u] += __shfl_xor_sync(0xffffffffu, l[u], o);
    if (lane == 0)
#pragma unroll
      for (int u = 0; u < kHeadsPerWarp; ++u) {
        m_s[warp + u * kWarps] = m[u];
        l_s[warp + u * kWarps] = l[u];
      }
  }
  __syncthreads();

  // P·V: warp w, heads w and w + 8 (a head ≥ G computes what is never
  // stored), lane i dimensions 8i..8i+7. Keys in 8-row groups: a whole
  // group issues its 8 row loads at once; the ragged ends of [j0, j1)
  // go key by key.
  const int d0 = 8 * lane;
  float acc[kHeadsPerWarp][8];
#pragma unroll
  for (int u = 0; u < kHeadsPerWarp; ++u)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[u][i] = 0.0f;
  if (warp < group && d0 < head_dim) {
    const int jb = j0 - c0, je = j1 - c0;
    const char* vcol = v_s + d0 * sizeof(T);
    const float* p0 = p_s + warp * C;
    const float* p1 = p0 + kWarps * C;
    for (int g8 = jb & ~7; g8 < je; g8 += 8) {
      mbar_wait(&v_bar[g8 / 8]);
      if (g8 >= jb && g8 + 8 <= je) {
        float vv[8][8];
#pragma unroll
        for (int r = 0; r < 8; ++r)
          load8(reinterpret_cast<const T*>(vcol + (g8 + r) * pitch), vv[r]);
        const float4 pa = *reinterpret_cast<const float4*>(p0 + g8);
        const float4 pb = *reinterpret_cast<const float4*>(p0 + g8 + 4);
        const float4 qa = *reinterpret_cast<const float4*>(p1 + g8);
        const float4 qb4 = *reinterpret_cast<const float4*>(p1 + g8 + 4);
        const float w0[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
        const float w1[8] = {qa.x, qa.y, qa.z, qa.w,
                             qb4.x, qb4.y, qb4.z, qb4.w};
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            acc[0][i] += w0[r] * vv[r][i];
            acc[1][i] += w1[r] * vv[r][i];
          }
      } else {
        for (int j = max(g8, jb); j < min(g8 + 8, je); ++j) {
          float vv[8];
          load8(reinterpret_cast<const T*>(vcol + j * pitch), vv);
          const float w0 = p0[j], w1 = p1[j];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            acc[0][i] += w0 * vv[i];
            acc[1][i] += w1 * vv[i];
          }
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
    for (int u = 0; u < kHeadsPerWarp; ++u) {
      const int g = warp + u * kWarps;
      if (g < group) {
        float4* dst =
            reinterpret_cast<float4*>(part_acc + (row0 + g) * head_dim + d0);
        dst[0] = make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
        dst[1] = make_float4(acc[u][4], acc[u][5], acc[u][6], acc[u][7]);
      }
    }
  }
}

// One (b, h) row (blockIdx.x = b·H + h) merged over the splits, 128
// dimensions a block (blockIdx.y). Warp 0 takes the row's max M, each
// split's weight e^{m_i − M} and l = Σ e^{m_i − M} l_i; then thread t sums
// 4 dimensions (column t mod 32) of every 8th split's acc (split group
// t / 32, its loads independent of each other), and the groups are added
// in shared memory.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
flash_decode_combine(const float* __restrict__ part_m,
                     const float* __restrict__ part_l,
                     const float* __restrict__ part_acc, T* __restrict__ out,
                     int n_splits, long long rows, int head_dim) {
  extern __shared__ float w_s[];                 // n_splits weights
  __shared__ __align__(16) float acc_s[kCombineGroups - 1][kCombineDims];
  __shared__ float l_s;
  const long long row = blockIdx.x;
  const int tid = threadIdx.x;
  if (tid < 32) {
    float m = -INFINITY;
    for (int i = tid; i < n_splits; i += 32)
      m = fmaxf(m, part_m[i * rows + row]);
    m = warp_max(m);
    float l = 0.0f;
    for (int i = tid; i < n_splits; i += 32) {
      const float w = expf(part_m[i * rows + row] - m);
      w_s[i] = w;
      l += w * part_l[i * rows + row];
    }
    l = warp_sum(l);
    if (tid == 0) l_s = l;
  }
  __syncthreads();
  const int col = 4 * (tid % (kCombineDims / 4));
  const int d0 = blockIdx.y * kCombineDims + col;
  const int group = tid / (kCombineDims / 4);
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (d0 < head_dim) {
#pragma unroll 4
    for (int i = group; i < n_splits; i += kCombineGroups) {
      const float w = w_s[i];
      const float4 a = *reinterpret_cast<const float4*>(
          part_acc + (i * rows + row) * head_dim + d0);
      acc.x += w * a.x;
      acc.y += w * a.y;
      acc.z += w * a.z;
      acc.w += w * a.w;
    }
    if (group > 0)
      *reinterpret_cast<float4*>(&acc_s[group - 1][col]) = acc;
  }
  __syncthreads();
  if (group == 0 && d0 < head_dim) {
#pragma unroll
    for (int g = 0; g < kCombineGroups - 1; ++g) {
      const float4 a = *reinterpret_cast<const float4*>(&acc_s[g][col]);
      acc.x += a.x;
      acc.y += a.y;
      acc.z += a.z;
      acc.w += a.w;
    }
    const float denom = fmaxf(l_s, 1e-30f);
    T* o = out + row * head_dim + d0;
    store(o, acc.x / denom);
    store(o + 1, acc.y / denom);
    store(o + 2, acc.z / denom);
    store(o + 3, acc.w / denom);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* length,
           void* part_m, void* part_l, void* part_acc, void* out, int batch,
           int seq, int heads, int kv_heads, int head_dim, int window,
           float scale, cudaStream_t stream) {
  const int group = heads / kv_heads;
  const int n_splits = (seq + kSplit - 1) / kSplit;
  const int smem = split_smem_bytes(kSplit, head_dim, sizeof(T));
  // Raise the kernel's dynamic shared-memory limit once per size above
  // what was set (a host call, not a stream operation).
  static int allowed = 48 * 1024;
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_decode_split<T, kSplit>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    allowed = smem;
  }
  const dim3 grid(n_splits, batch * kv_heads);
  flash_decode_split<T, kSplit><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)length,
      (float*)part_m, (float*)part_l, (float*)part_acc, seq, kv_heads, group,
      head_dim, window, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 combine_grid(batch * heads,
                          (head_dim + kCombineDims - 1) / kCombineDims);
  flash_decode_combine<T><<<combine_grid, kCombineThreads,
                             n_splits * sizeof(float), stream>>>(
          (const float*)part_m, (const float*)part_l, (const float*)part_acc,
          (T*)out, n_splits, (long long)batch * heads, head_dim);
  return (int)cudaGetLastError();
}

}  // namespace

// Pointers on the device, contiguous, 16-byte aligned: q (B, H, hd), k, v
// (B, S, K, hd), length (B,) int32, out (B, H, hd) in q's type; part_m,
// part_l (ceil(S/C), B·H) and part_acc (ceil(S/C), B·H, hd) fp32 scratch,
// C = flash_decode_keys_per_block(). bf16 != 0 selects bfloat16 inputs,
// else fp32. Launches both kernels on `stream` and returns
// cudaGetLastError().
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

// C, the keys per split block the source was built with.
extern "C" int flash_decode_keys_per_block() { return kSplit; }

// Dynamic shared memory of one split block at this hd and element size.
extern "C" int flash_decode_smem_bytes(int head_dim, int elem) {
  return split_smem_bytes(kSplit, head_dim, elem);
}
