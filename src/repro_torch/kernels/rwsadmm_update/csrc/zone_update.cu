// Eq. 31 masked zone update of RWSADMM, one pass over device memory.
//
// Replaces the TPU kernel src/repro/kernels/rwsadmm_update/kernel.py ::
// zone_fused_update_flat (pallas_call at kernel.py:176, body _zone_kernel).
//
// Per parameter index p and live zone slot j (mask m_j):
//   s'    = sgn(y − x_j)
//   x⁺_j  = y − g_j/β + s'(z_j − βε)/β
//   z⁺_j  = z_j + κβ(x⁺_j − y − ε)
//   c_j   = x_j − (z_j/β + ε)s'
//   c⁺_j  = x⁺_j − (z⁺_j/β + ε)·sgn(y − x⁺_j)
//   y⁺    = y + (Σ_j m_j(c⁺_j − c_j))/n          (j = 0..Z−1 in order)
// Padded slots (m_j = 0) write m·x⁺ + (1 − m)·x = x and fold zero.
//
// Bound: memory. Each launch reads x, z, g (Z rows each) and y, writes x⁺,
// z⁺ (Z rows each) and y⁺: (5Z + 2)·N·4 bytes. For the paper's CIFAR CNN
// (N = 1,068,266) at Z = 8 that is 42·N·4 B = 179.5 MB per round, about
// 54 µs at the H100 SXM's 3.35 TB/s; the arithmetic (~25 flops per
// element and slot) is far below the compute roofline.
//
// Design: one thread per p on a 1-D grid, tail masked, no padding. Each
// thread reads y[p] once, loops over the zone keeping the fold in a
// register (summed in slot order, like the TPU kernel's loop), and writes
// y⁺[p] once; neighbouring threads touch neighbouring addresses of each
// row, so every access is coalesced. κ and the mask are read from device
// memory: κ decays every round and must not force a host sync.
//
// Build with -fmad=false: the plain PyTorch version rounds after every
// operation, and a contracted a·b + c would move x⁺ by an ulp and flip
// sgn(y − x⁺) where x⁺ sits within an ulp of y.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float sgn(float v) {
  // sgn(0) = 0: under warm init x = y exactly on a client's first visit.
  return static_cast<float>((v > 0.0f) - (v < 0.0f));
}

__global__ void zone_update_kernel(
    const float* __restrict__ x, const float* __restrict__ z,
    const float* __restrict__ y, const float* __restrict__ g,
    const float* __restrict__ mask, const float* __restrict__ kappa,
    float* __restrict__ x_out, float* __restrict__ z_out,
    float* __restrict__ y_out, int zone, long long n, float beta,
    float beta_eps, float eps_half, float n_total) {
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (p >= n) return;
  const float yp = y[p];
  const float kb = kappa[0] * beta;
  float acc = 0.0f;
  for (int j = 0; j < zone; ++j) {
    const long long i = static_cast<long long>(j) * n + p;
    const float m = mask[j];
    const float xj = x[i];
    const float zj = z[i];
    const float gj = g[i];
    const float s = sgn(yp - xj);
    const float xn = yp - gj / beta + s * (zj - beta_eps) / beta;
    const float zn = zj + kb * (xn - yp - eps_half);
    const float co = xj - (zj / beta + eps_half) * s;
    const float cn = xn - (zn / beta + eps_half) * sgn(yp - xn);
    x_out[i] = m * xn + (1.0f - m) * xj;
    z_out[i] = m * zn + (1.0f - m) * zj;
    acc = acc + m * (cn - co);
  }
  y_out[p] = yp + acc / n_total;
}

}  // namespace

extern "C" int rwsadmm_zone_update(
    const void* x, const void* z, const void* y, const void* g,
    const void* mask, const void* kappa, void* x_out, void* z_out,
    void* y_out, int zone, long long n, float beta, float beta_eps,
    float eps_half, float n_total, void* stream) {
  constexpr int kThreads = 256;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (n > 0 && zone > 0) {
    zone_update_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
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
