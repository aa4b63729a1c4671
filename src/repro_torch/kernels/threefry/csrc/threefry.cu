// JAX's threefry2x32 sampler, as jax.random draws with
// jax_threefry_partitionable on (jax/_src/prng.py: _threefry2x32_lowering,
// iota_2x32_shape, _threefry_split_foldlike; jax/_src/random.py: _uniform,
// _bernoulli, _randint). It replaces jax.random in the reference's round:
// sample_batch's randint (src/repro/fl/base.py:110) and the CNN's dropout,
// bernoulli(fold_in(rng, i), p, shape) (src/repro/models/small.py:112,
// :120). No Pallas kernel of the JAX package corresponds: XLA fuses those
// draws into the reference's compiled round. The keys are device tensors,
// so a captured CUDA graph draws anew on every replay, and a seed draws the
// reference's batches on the card and on the CPU alike.
//
// A counter i under key (k0, k1) is the word pair (i >> 32, i) hashed by
// 20 Threefry rounds. Two entries:
//
//   threefry_bits   counters offset .. offset + n − 1 under every key row:
//                   both words (split's and fold_in's new keys) or their
//                   xor (random_bits), int64. Grid (counter chunk, row).
//   threefry_draws  a round's draws in one launch. Parent keys (R, 2) are
//                   the leaves, or with a fan-out Z the leaves are
//                   split(parent, Z), fan-out-major (leaf j·R + r is
//                   split(keys[r], Z)[j]). Each leaf draws B batch indices,
//                   randint(leaf, (B,), minval, spans[client]) with the
//                   leaf's client read from a device table, and up to two
//                   keep masks, bernoulli(fold_in(leaf, i + 1), p, shape)
//                   (or under the leaf itself), each stored in the layout
//                   the model applies it in.
//
// randint: minval + (hi % s · ((2^16 % s)^2 % s) + lo % s) % s in uint32,
// s = maxval − minval (1 when ≤ 0), hi and lo drawn under the two halves of
// split(leaf). bernoulli: the top 23 bits as the mantissa of [1, 2), minus
// 1, below float32(p).
//
// Bound of threefry_draws at one CNN zone round (8 leaves, 160 indices,
// 655,360 + 81,920 keep bytes): ~53 M 32-bit integer instructions (68 a
// 32-bit draw in the SASS besides the key's own, DRAW_OPS in
// chip_smoke.py as scripts/threefry_sass.py counts it, and 4 more a keep
// byte) against
// 0.74 MB written. At the SM's issue rate, 128 instructions a clock (the
// ALU pipe's 64 and the FMA pipe's 64, which takes ptxas's IMAD adds) ×
// 132 SMs × 1,980 MHz, 33.5 T/s, that is ~1.6 µs; the bytes take 0.22 µs
// at 3.35 TB/s. So the work is on the integer pipes, and the design keeps
// every other cost off them:
//
//   * one launch a round for what took six (split, randint, two fold_ins,
//     two bernoullis) and the spans' gather: each of those cost ~2 µs, most
//     of it launch and tail;
//   * grid (chunk, leaf): a block serves one leaf, and its first threads
//     hash the leaf's derived keys (split's halves for randint, each
//     mask's fold_in) once into shared memory, so a keep byte costs one
//     hash and the compare;
//   * 32-bit counters and offsets (the wrapper raises at 2^31 a leaf) and
//     no division per element: a thread decomposes its first output
//     position once and steps the counter across its run;
//   * a thread hashes 16 independent counters in one branch-free block (16
//     add-rotate-xor chains in flight hide their latency) and writes its 16
//     keep bytes with one 128-bit store, in the model's layout: NCHW for
//     the conv block, whose counter is the reference's NHWC index, so the
//     mask is contiguous where the model reads it;
//   * the indices and each mask start on a warp of their own, and an index
//     thread hashes its two indices' four words branch-free, so no warp
//     runs two parts one after the other or a chain of hashes alone.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxRowBlocks = 65535;   // grid.y; more rows loop
constexpr long long kMaxChunkBlocks = 4096;
constexpr int kIdxPerThread = 2;       // batch indices a thread draws
constexpr int kBytesPerThread = 16;    // keep bytes a thread writes at once
constexpr int kMaxMasks = 2;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// Threefry-2x32, 20 rounds: key (k0, k1) hashes counter (x0, x1) in place.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
#define TF_ROUND(r) \
  x0 += x1;         \
  x1 = rotl(x1, r) ^ x0;
  x0 += k0;
  x1 += k1;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k1;
  x1 += k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k2;
  x1 += k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k0;
  x1 += k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k1;
  x1 += k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k2;
  x1 += k0 + 5u;
#undef TF_ROUND
}

// The 32-bit draw at a counter below 2^32 under key (k0, k1): w0 ^ w1.
__device__ __forceinline__ uint32_t draw(uint32_t k0, uint32_t k1,
                                         uint32_t c) {
  uint32_t x0 = 0u, x1 = c;
  threefry2x32(k0, k1, x0, x1);
  return x0 ^ x1;
}

__global__ void __launch_bounds__(kThreads)
threefry_bits_kernel(const long long* __restrict__ keys, int rows,
                     long long n, unsigned long long offset, int pair,
                     long long* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const uint32_t k0 = static_cast<uint32_t>(__ldg(keys + 2 * r));
    const uint32_t k1 = static_cast<uint32_t>(__ldg(keys + 2 * r + 1));
    long long* row = out + static_cast<long long>(r) * n * (pair ? 2 : 1);
    for (long long i = blockIdx.x * static_cast<long long>(kThreads)
                       + threadIdx.x; i < n; i += stride) {
      const unsigned long long c = offset + i;
      uint32_t x0 = static_cast<uint32_t>(c >> 32);
      uint32_t x1 = static_cast<uint32_t>(c);
      threefry2x32(k0, k1, x0, x1);
      if (pair) {
        row[2 * i] = x0;
        row[2 * i + 1] = x1;
      } else {
        row[i] = x0 ^ x1;
      }
    }
  }
}

// A keep mask: count = N · C · S bytes a leaf, stored (N, C, S) and drawn
// at counter (n · S + s) · C + c, the reference's (N, S, C) index; C = 1
// stores the reference's own order.
struct Mask {
  uint32_t count, channels, inner;
  float p;
  bool* out;
};

struct Draws {
  const long long* keys;      // (rows, 2) parent keys
  int rows, fan, leaves;      // leaves = rows · fan, or rows when fan is 0
  const long long* spans;     // maxval by client
  const long long* clients;   // leaf l's client: clients[l % n_clients]
  int n_spans, n_clients;     // (no clients: spans[l % n_spans])
  long long minval;
  int batch;                  // indices a leaf draws
  long long* idx;             // (leaves, batch)
  int n_masks, fold;          // fold: mask i under fold_in(leaf, i + 1)
  Mask mask[kMaxMasks];
  int first[kMaxMasks + 1];   // a leaf's threads: indices, then each mask,
                              // each part from a warp of its own
};

__device__ __forceinline__ void leaf_key(const Draws& d, int leaf,
                                         uint32_t& k0, uint32_t& k1) {
  const int r = d.fan ? leaf % d.rows : leaf;
  k0 = static_cast<uint32_t>(__ldg(d.keys + 2 * r));
  k1 = static_cast<uint32_t>(__ldg(d.keys + 2 * r + 1));
  if (d.fan) {
    uint32_t x0 = 0u, x1 = static_cast<uint32_t>(leaf / d.rows);
    threefry2x32(k0, k1, x0, x1);
    k0 = x0;
    k1 = x1;
  }
}

__device__ __forceinline__ void draw_indices(const Draws& d, int leaf, int t,
                                             const uint32_t* key,
                                             uint32_t span, uint32_t mult) {
  long long* out = d.idx + static_cast<long long>(leaf) * d.batch;
  uint32_t hi[kIdxPerThread], lo[kIdxPerThread];
#pragma unroll
  for (int k = 0; k < kIdxPerThread; ++k) {   // branch-free, all in flight
    hi[k] = draw(key[0], key[1], t * kIdxPerThread + k);
    lo[k] = draw(key[2], key[3], t * kIdxPerThread + k);
  }
#pragma unroll
  for (int k = 0; k < kIdxPerThread; ++k) {
    const int i = t * kIdxPerThread + k;
    if (i < d.batch)
      out[i] = d.minval + ((hi[k] % span) * mult + lo[k] % span) % span;
  }
}

__device__ __forceinline__ void draw_mask(const Mask& m, int leaf, int t,
                                          uint32_t k0, uint32_t k1) {
  const uint32_t o0 = static_cast<uint32_t>(t) * kBytesPerThread;
  if (o0 >= m.count) return;   // the part's last warp, past its end
  // o0's place (n, c, s) in the stored order, then its counter.
  const uint32_t q = o0 / m.inner;
  uint32_t s = o0 - q * m.inner;
  uint32_t n = q / m.channels, c = q - n * m.channels;
  uint32_t ctr[kBytesPerThread];
  ctr[0] = (n * m.inner + s) * m.channels + c;
  if (s + kBytesPerThread <= m.inner) {   // one run of s: counters step C
#pragma unroll
    for (int k = 1; k < kBytesPerThread; ++k)
      ctr[k] = ctr[0] + k * m.channels;
  } else {
#pragma unroll
    for (int k = 1; k < kBytesPerThread; ++k) {
      if (++s == m.inner) {
        s = 0;
        if (++c == m.channels) {
          c = 0;
          ++n;
        }
      }
      ctr[k] = (n * m.inner + s) * m.channels + c;
    }
  }
  uint32_t word[kBytesPerThread / 4] = {};
#pragma unroll
  for (int k = 0; k < kBytesPerThread; ++k) {
    const uint32_t bits = draw(k0, k1, ctr[k]);
    const float u = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u),
                              1.0f);
    word[k / 4] |= static_cast<uint32_t>(u < m.p) << (8 * (k % 4));
  }
  bool* out = m.out + static_cast<long long>(leaf) * m.count + o0;
  if (m.count % kBytesPerThread == 0) {   // 16-byte aligned, whole run
    *reinterpret_cast<uint4*>(out) =
        make_uint4(word[0], word[1], word[2], word[3]);
  } else {
#pragma unroll
    for (int k = 0; k < kBytesPerThread; ++k)
      if (o0 + k < m.count) out[k] = (word[k / 4] >> (8 * (k % 4))) & 1u;
  }
}

__global__ void __launch_bounds__(kThreads)
threefry_draws_kernel(const Draws d) {
  // The block's leaf: split's halves (randint), then each mask's key.
  __shared__ uint32_t key[2 * (2 + kMaxMasks)];
  __shared__ uint32_t span_mult[2];
  const int t = blockIdx.x * kThreads + threadIdx.x;
  for (int leaf = blockIdx.y; leaf < d.leaves; leaf += gridDim.y) {
    const int slot = threadIdx.x;
    if (slot < 2 + d.n_masks) {
      uint32_t x0, x1;
      leaf_key(d, leaf, x0, x1);
      if (slot < 2 || d.fold) {   // split halves: counters 0, 1; fold i + 1
        const uint32_t k0 = x0, k1 = x1;
        x0 = 0u;
        x1 = slot < 2 ? slot : slot - 1;
        threefry2x32(k0, k1, x0, x1);
      }
      key[2 * slot] = x0;
      key[2 * slot + 1] = x1;
    }
    if (slot == 0 && d.batch > 0) {
      const long long client = d.clients
          ? __ldg(d.clients + leaf % d.n_clients) : leaf % d.n_spans;
      const long long mx = __ldg(d.spans + client);
      const uint32_t span = mx <= d.minval
          ? 1u : static_cast<uint32_t>(mx - d.minval);
      const uint32_t m = 65536u % span;
      span_mult[0] = span;
      span_mult[1] = (m * m) % span;   // wraps mod 2^32, as in JAX
    }
    __syncthreads();
    if (t < d.first[0]) {
      draw_indices(d, leaf, t, key, span_mult[0], span_mult[1]);
    } else {
#pragma unroll
      for (int i = 0; i < kMaxMasks; ++i) {
        if (i < d.n_masks && t >= d.first[i] && t < d.first[i + 1])
          draw_mask(d.mask[i], leaf, t - d.first[i], key[4 + 2 * i],
                    key[5 + 2 * i]);
      }
    }
    __syncthreads();   // the next leaf rewrites the keys
  }
}

int capped(long long blocks, long long cap) {
  return static_cast<int>(blocks < cap ? blocks : cap);
}

}  // namespace

extern "C" {

int threefry_bits(const long long* keys, int rows, long long n,
                  unsigned long long offset, int pair, long long* out,
                  cudaStream_t stream) {
  if (rows == 0 || n == 0) return 0;
  const dim3 grid(capped((n + kThreads - 1) / kThreads, kMaxChunkBlocks),
                  capped(rows, kMaxRowBlocks));
  threefry_bits_kernel<<<grid, kThreads, 0, stream>>>(keys, rows, n, offset,
                                                       pair, out);
  return static_cast<int>(cudaGetLastError());
}

// dims: (count, channels, inner) of each mask; probs: float32(p) of each;
// outs: each mask's (leaves, count) bool output.
int threefry_draws(const long long* keys, int rows, int fan,
                   const long long* spans, int n_spans,
                   const long long* clients, int n_clients, long long minval,
                   int batch, long long* idx, int n_masks, const int* dims,
                   const float* probs, void* const* outs, int fold,
                   cudaStream_t stream) {
  if (n_masks < 0 || n_masks > kMaxMasks)
    return static_cast<int>(cudaErrorInvalidValue);
  Draws d = {};
  d.keys = keys;
  d.rows = rows;
  d.fan = fan;
  d.leaves = fan ? rows * fan : rows;
  d.spans = spans;
  d.clients = clients;
  d.n_spans = n_spans;
  d.n_clients = n_clients;
  d.minval = minval;
  d.batch = batch;
  d.idx = idx;
  d.n_masks = n_masks;
  d.fold = fold;
  // Each part starts on a warp, so no warp splits between two of them.
  const auto warps = [](int threads) { return (threads + 31) / 32 * 32; };
  d.first[0] = warps((batch + kIdxPerThread - 1) / kIdxPerThread);
  for (int i = 0; i < n_masks; ++i) {
    d.mask[i] = {static_cast<uint32_t>(dims[3 * i]),
                 static_cast<uint32_t>(dims[3 * i + 1]),
                 static_cast<uint32_t>(dims[3 * i + 2]), probs[i],
                 static_cast<bool*>(outs[i])};
    d.first[i + 1] = d.first[i]
        + warps((dims[3 * i] + kBytesPerThread - 1) / kBytesPerThread);
  }
  const int threads = d.first[n_masks];
  if (d.leaves == 0 || threads == 0) return 0;
  const dim3 grid((threads + kThreads - 1) / kThreads,
                  capped(d.leaves, kMaxRowBlocks));
  threefry_draws_kernel<<<grid, kThreads, 0, stream>>>(d);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
