// Eq. 31 RWSADMM updates, one pass over device memory each. Two entries
// share one per-slot device function:
//
//   rwsadmm_multizone_update  K walkers' masked zone rounds in one launch.
//     Replaces src/repro/kernels/rwsadmm_update/kernel.py ::
//     multizone_fused_update_flat (pallas_call at kernel.py:147, body
//     _multizone_kernel). Its K = 1 launch is the single masked zone
//     round and replaces kernel.py :: zone_fused_update_flat (pallas_call
//     at kernel.py:176, body _zone_kernel).
//   rwsadmm_fused_update  one client, no mask. Replaces kernel.py ::
//     fused_update_flat (pallas_call at kernel.py:51, body _kernel).
//
// Per parameter index p and zone slot j (mask m_j) against token y:
//   s'    = sgn(y − x_j)
//   x⁺_j  = y − g_j/β + s'(z_j − βε)/β
//   z⁺_j  = z_j + κβ(x⁺_j − y − ε)
//   c_j   = x_j − (z_j/β + ε)s'
//   c⁺_j  = x⁺_j − (z⁺_j/β + ε)·sgn(y − x⁺_j)
//   y⁺    = y + (Σ_j m_j(c⁺_j − c_j))/n          (j = 0..Z−1 in order)
// Padded slots (m_j = 0) write m·x⁺ + (1 − m)·x = x and fold zero; a walker
// whose zone is all padding passes its rows and its token through. The
// single-client entry writes x⁺, z⁺ and y⁺ = y + (c⁺ − c)/n.
//
// Bound: memory; the arithmetic (~25 flops per element and slot) is far
// below the compute roofline. Per launch:
//   multi-zone: reads x, z, g (K·Z rows) and y (K rows), writes x⁺, z⁺
//     (K·Z rows) and y⁺ (K rows): K·(5Z + 2)·N·4 bytes. At K = 3, Z = 8
//     and the paper's CIFAR CNN (N = 1,068,266) that is 538.4 MB, 0.161 ms
//     at the H100 SXM's 3.35 TB/s; K = 1 is the zone round, 179.5 MB,
//     0.054 ms.
//   single client: reads x, z, y, g, writes x⁺, z⁺, y⁺: 7·N·4 bytes,
//     29.9 MB and 8.9 µs at the CNN's N.
//
// Design: one thread per (walker k, index p) on a 2-D grid, blockIdx.x
// over N (tail masked, no padding) and blockIdx.y over the K walkers. Each
// thread reads y_k[p] once, loops over its walker's Z slots at run time
// keeping the fold in a register (summed in slot order, like the TPU
// kernel's loop), and writes y⁺_k[p] once: no atomics, since the thread
// owns its token element. Neighbouring threads touch neighbouring
// addresses of each row, so every access is coalesced. κ and the mask are
// read from device memory: κ decays every round and must not force a host
// sync.
//
// Build with -fmad=false: the plain PyTorch version rounds after every
// operation, and a contracted a·b + c would move x⁺ by an ulp and flip
// sgn(y − x⁺) where x⁺ sits within an ulp of y.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float sgn(float v) {
  // sgn(0) = 0: under warm init x = y exactly on a client's first visit.
  return static_cast<float>((v > 0.0f) - (v < 0.0f));
}

// One slot at one index: writes x⁺ and z⁺, returns c⁺ − c.
__device__ __forceinline__ float slot_update(
    float yp, float xj, float zj, float gj, float kb, float beta,
    float beta_eps, float eps_half, float* xn, float* zn) {
  const float s = sgn(yp - xj);
  *xn = yp - gj / beta + s * (zj - beta_eps) / beta;
  *zn = zj + kb * (*xn - yp - eps_half);
  const float co = xj - (zj / beta + eps_half) * s;
  const float cn = *xn - (*zn / beta + eps_half) * sgn(yp - *xn);
  return cn - co;
}

__global__ void multizone_update_kernel(
    const float* __restrict__ x, const float* __restrict__ z,
    const float* __restrict__ y, const float* __restrict__ g,
    const float* __restrict__ mask, const float* __restrict__ kappa,
    float* __restrict__ x_out, float* __restrict__ z_out,
    float* __restrict__ y_out, int zone, long long n, float beta,
    float beta_eps, float eps_half, float n_total) {
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (p >= n) return;
  const long long row0 = static_cast<long long>(blockIdx.y) * zone;
  const long long yi = static_cast<long long>(blockIdx.y) * n + p;
  const float yp = y[yi];
  const float kb = kappa[0] * beta;
  float acc = 0.0f;
  for (int j = 0; j < zone; ++j) {
    const long long i = (row0 + j) * n + p;
    const float m = mask[row0 + j];
    const float xj = x[i];
    const float zj = z[i];
    float xn, zn;
    const float dc = slot_update(yp, xj, zj, g[i], kb, beta, beta_eps,
                                 eps_half, &xn, &zn);
    x_out[i] = m * xn + (1.0f - m) * xj;
    z_out[i] = m * zn + (1.0f - m) * zj;
    acc = acc + m * dc;
  }
  y_out[yi] = yp + acc / n_total;
}

__global__ void fused_update_kernel(
    const float* __restrict__ x, const float* __restrict__ z,
    const float* __restrict__ y, const float* __restrict__ g,
    const float* __restrict__ kappa, float* __restrict__ x_out,
    float* __restrict__ z_out, float* __restrict__ y_out, long long n,
    float beta, float beta_eps, float eps_half, float n_total) {
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (p >= n) return;
  const float yp = y[p];
  float xn, zn;
  const float dc = slot_update(yp, x[p], z[p], g[p], kappa[0] * beta, beta,
                               beta_eps, eps_half, &xn, &zn);
  x_out[p] = xn;
  z_out[p] = zn;
  y_out[p] = yp + dc / n_total;
}

unsigned int blocks_for(long long n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int rwsadmm_multizone_update(
    const void* x, const void* z, const void* y, const void* g,
    const void* mask, const void* kappa, void* x_out, void* z_out,
    void* y_out, int walkers, int zone, long long n, float beta,
    float beta_eps, float eps_half, float n_total, void* stream) {
  if (n > 0 && zone > 0 && walkers > 0) {
    const dim3 grid(blocks_for(n), static_cast<unsigned int>(walkers));
    multizone_update_kernel<<<grid, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(z),
        static_cast<const float*>(y), static_cast<const float*>(g),
        static_cast<const float*>(mask), static_cast<const float*>(kappa),
        static_cast<float*>(x_out), static_cast<float*>(z_out),
        static_cast<float*>(y_out), zone, n, beta, beta_eps, eps_half,
        n_total);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rwsadmm_fused_update(
    const void* x, const void* z, const void* y, const void* g,
    const void* kappa, void* x_out, void* z_out, void* y_out, long long n,
    float beta, float beta_eps, float eps_half, float n_total,
    void* stream) {
  if (n > 0) {
    fused_update_kernel<<<blocks_for(n), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(z),
        static_cast<const float*>(y), static_cast<const float*>(g),
        static_cast<const float*>(kappa), static_cast<float*>(x_out),
        static_cast<float*>(z_out), static_cast<float*>(y_out), n, beta,
        beta_eps, eps_half, n_total);
  }
  return static_cast<int>(cudaGetLastError());
}
