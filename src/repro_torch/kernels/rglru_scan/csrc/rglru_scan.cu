// RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t over (B, S, D), fp32,
// carry 0 at t = 0.
//
// Replaces src/repro/kernels/rglru_scan/kernel.py :: rglru_scan_blocked
// (pallas_call at kernel.py:49, body _kernel). The TPU kernel tiles D into
// 128-lane blocks and S into VMEM chunks, carrying h in scratch across its
// sequential sequence grid axis. On Hopper blocks run in no order, so the
// carry lives in a register and the sequence is a loop inside the thread.
//
// Bound: memory. Each element of a and b is read once and each h written
// once, 3·B·S·D·4 bytes, against 2 flops per element. At RecurrentGemma-9B's
// prefill (B = 4, S = 2040, D = 4096) that is 401 MB, 0.120 ms at the H100
// SXM's 3.35 TB/s.
//
// Design: one thread per (b, d) channel, looping over t. Neighbouring
// threads take neighbouring d, so every step's loads of a[t] and b[t] and
// its store of h[t] are coalesced. The loop is unrolled by kUnroll with the
// loads placed ahead of the dependent multiply-adds, which keeps
// 2·kUnroll loads in flight per thread. Blocks of 128 threads spread the
// B·D channels over as many SMs as there are blocks. D and S tails are
// masked, nothing is padded. Built with -fmad=false so that a*h + b rounds
// after the multiply and after the add, as the plain PyTorch loop does:
// the two agree bit for bit. A chunked two-pass scan over S would use more
// of the card when B·D is small; it is not done here.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ h, long long channels, long long seq,
                  long long width) {
  const long long ch = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (ch >= channels) return;
  const long long base = (ch / width) * seq * width + ch % width;
  const float* ap = a + base;
  const float* bp = b + base;
  float* hp = h + base;
  float carry = 0.0f;
  long long t = 0;
  for (; t + kUnroll <= seq; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      av[u] = ap[(t + u) * width];
      bv[u] = bp[(t + u) * width];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      carry = av[u] * carry + bv[u];
      hp[(t + u) * width] = carry;
    }
  }
  for (; t < seq; ++t) {
    carry = ap[t * width] * carry + bp[t * width];
    hp[t * width] = carry;
  }
}

}  // namespace

// a, b, h: (batch, seq, width) fp32, contiguous, on the device. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int rglru_scan(const void* a, const void* b, void* h, int batch,
                          long long seq, long long width, void* stream) {
  const long long channels = (long long)batch * width;
  const unsigned grid = (unsigned)((channels + kThreads - 1) / kThreads);
  rglru_scan_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (float*)h, channels, seq, width);
  return (int)cudaGetLastError();
}
