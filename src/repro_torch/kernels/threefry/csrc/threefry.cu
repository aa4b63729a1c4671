// JAX's threefry2x32 sampler, as jax.random draws with
// jax_threefry_partitionable on (jax/_src/prng.py: _threefry2x32_lowering,
// iota_2x32_shape, _threefry_split_foldlike; jax/_src/random.py: _uniform,
// _bernoulli, _randint). No Pallas kernel of the JAX package corresponds:
// XLA fuses jax.random into the reference's compiled round. The trainers'
// minibatch indices and dropout keep masks come from here, so a seed
// draws the reference's batches on the card and on the CPU alike, and the
// keys are device tensors that a captured CUDA graph reads anew on every
// replay.
//
// One thread per (key row r, counter i): the counter is the flat index
// i + offset split into (hi, lo) 32-bit words and hashed under the row's
// key (k0, k1) by 20 Threefry rounds. Three entries:
//
//   threefry_bits       both output words (a split's new keys) or their
//                       xor (random_bits), int64;
//   threefry_bernoulli  uniform(bits) < p as bool, uniform being the top
//                       23 bits as the mantissa of [1, 2) minus 1;
//   threefry_randint    minval + (hi % s · ((2^16 % s)^2 % s) + lo % s) % s
//                       in uint32, with s = maxval[r] − minval per row and
//                       hi, lo drawn under the two halves of split(key).
//
// Bound: a round's draws write ~0.74 MB (the CIFAR CNN's zone of 8 × 20:
// 655,360 + 81,920 keep bits as bool, 160 int64 indices), 0.2 µs at
// 3.35 TB/s; the hash is ~100 32-bit integer operations an element, ~74 M
// a round, ~1 µs. So a launch costs its launch latency; the design keeps
// the work to one pass (no intermediate words in device memory, which is
// what the plain version's ~160 elementwise int64 passes cost) and reads
// the keys and spans from device memory so that nothing syncs the host.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 32;

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

// The 32-bit draw at counter c under key (k0, k1): w0 ^ w1.
__device__ __forceinline__ uint32_t draw(uint32_t k0, uint32_t k1,
                                         unsigned long long c) {
  uint32_t x0 = static_cast<uint32_t>(c >> 32);
  uint32_t x1 = static_cast<uint32_t>(c);
  threefry2x32(k0, k1, x0, x1);
  return x0 ^ x1;
}

__device__ __forceinline__ void row_key(const long long* keys, long long r,
                                        uint32_t& k0, uint32_t& k1) {
  k0 = static_cast<uint32_t>(__ldg(keys + 2 * r));
  k1 = static_cast<uint32_t>(__ldg(keys + 2 * r + 1));
}

__global__ void threefry_bits_kernel(const long long* __restrict__ keys,
                            long long rows, long long n, long long offset,
                            int pair, long long* __restrict__ out) {
  const long long total = rows * n;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x)
                     + threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long r = e / n;
    const unsigned long long c = offset + (e - r * n);
    uint32_t k0, k1;
    row_key(keys, r, k0, k1);
    uint32_t x0 = static_cast<uint32_t>(c >> 32);
    uint32_t x1 = static_cast<uint32_t>(c);
    threefry2x32(k0, k1, x0, x1);
    if (pair) {
      out[2 * e] = x0;
      out[2 * e + 1] = x1;
    } else {
      out[e] = x0 ^ x1;
    }
  }
}

__global__ void threefry_bernoulli_kernel(const long long* __restrict__ keys,
                                 long long rows, long long n, float p,
                                 bool* __restrict__ out) {
  const long long total = rows * n;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x)
                     + threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long r = e / n;
    uint32_t k0, k1;
    row_key(keys, r, k0, k1);
    const uint32_t bits = draw(k0, k1, e - r * n);
    const float u = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u),
                              1.0f);
    out[e] = u < p;
  }
}

__global__ void threefry_randint_kernel(const long long* __restrict__ keys,
                               long long rows, long long n,
                               const long long* __restrict__ maxval,
                               long long minval, long long* __restrict__ out) {
  const long long total = rows * n;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x)
                     + threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long r = e / n;
    uint32_t k0, k1;
    row_key(keys, r, k0, k1);
    // split(key): the halves are the hashes of counters 0 and 1.
    uint32_t a0 = 0u, a1 = 0u, b0 = 0u, b1 = 1u;
    threefry2x32(k0, k1, a0, a1);
    threefry2x32(k0, k1, b0, b1);
    const unsigned long long c = e - r * n;
    const uint32_t hi = draw(a0, a1, c);
    const uint32_t lo = draw(b0, b1, c);
    const long long mx = __ldg(maxval + r);
    const uint32_t span = mx <= minval ? 1u
                                       : static_cast<uint32_t>(mx - minval);
    uint32_t mult = 65536u % span;
    mult = (mult * mult) % span;            // wraps mod 2^32, as in JAX
    const uint32_t off = ((hi % span) * mult + lo % span) % span;
    out[e] = minval + off;
  }
}

int blocks_for(long long total) {
  const long long b = (total + kThreads - 1) / kThreads;
  return static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace

extern "C" {

int threefry_bits(const long long* keys, long long rows, long long n,
                  long long offset, int pair, long long* out,
                  cudaStream_t stream) {
  if (rows * n == 0) return 0;
  threefry_bits_kernel<<<blocks_for(rows * n), kThreads, 0, stream>>>(
      keys, rows, n, offset, pair, out);
  return static_cast<int>(cudaGetLastError());
}

int threefry_bernoulli(const long long* keys, long long rows, long long n,
                       float p, bool* out, cudaStream_t stream) {
  if (rows * n == 0) return 0;
  threefry_bernoulli_kernel<<<blocks_for(rows * n), kThreads, 0, stream>>>(
      keys, rows, n, p, out);
  return static_cast<int>(cudaGetLastError());
}

int threefry_randint(const long long* keys, long long rows, long long n,
                     const long long* maxval, long long minval,
                     long long* out, cudaStream_t stream) {
  if (rows * n == 0) return 0;
  threefry_randint_kernel<<<blocks_for(rows * n), kThreads, 0, stream>>>(
      keys, rows, n, maxval, minval, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
