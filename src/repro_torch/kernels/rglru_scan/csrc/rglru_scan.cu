// RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t over (B, S, D), fp32,
// carry 0 at t = 0, and its backward.
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
// SXM's 3.35 TB/s. The multiply-add chain itself is short (2040 steps of
// ~8 cycles, ~10 µs), so what keeps a scan from the bound is the bytes in
// flight: one thread per channel, each with a few dependent loads ahead,
// holds ~1 MB over the card, where the card needs ~2.3 MB.
//
// The file builds with -fmad=false so that a*h + b (and the backward's
// dh + a*g) rounds after the multiply and after the add, as the plain
// PyTorch loops do: each kernel agrees with its loop bit for bit. No
// chunked two-pass scan: it would change the rounding.
//
// rglru_scan_staged (D % 4 == 0, 16-byte aligned tensors): a block owns
// 32 channels of one batch row (each timestep's slice is one 128-byte
// row), grid (ceil(D/32), B): 512 blocks at the prefill shape, four
// resident per SM. Shared memory holds a ring of kStages stages of kSteps
// timesteps × 32 channels of a and of b (16 KB a stage). One lane of a
// producer warp issues cp.async.bulk copies of each stage's rows (the
// Tensor Memory Accelerator's bulk path; no tensor map), which complete
// on the stage's "full" mbarrier, and refills a slot once the consumer
// warp has released it on its "empty" mbarrier, so kStages − 1 stages
// stay in flight while the consumer runs the oldest from shared memory:
// 32 KB in flight per block, 128 KB per SM. Each step's h is stored from
// registers, 128 bytes a warp. The S tail is the last stage's shorter
// copy; the D tail copies a shorter row (a multiple of 16 bytes since
// D % 4 == 0) and its idle lanes store nothing.
//
// rglru_scan_loop (any other D): one thread per (b, d) channel looping
// over t, neighbouring threads on neighbouring d so every step's loads and
// store are coalesced, unrolled by kUnroll with the loads ahead of the
// multiply-adds.
//
// The backward has no Pallas counterpart; it stands for XLA's transpose of
// the reference's associative scan (src/repro/models/recurrent.py ::
// linear_scan), the same gradient by another order of operations. It runs
// the adjoint recurrence in reverse time, fused with the products: g =
// dh[t] + a[t+1] * g (from g = dh[S-1]), db[t] = g, da[t] = g * h[t-1]
// (h[-1] = 0), each product and sum rounded, as the plain loop in
// ../ref.py. It reads a, h and dh once each and writes da and db once
// each, 5·B·S·D·4 bytes: at a training step's (2, 2048, 4096) 335.5 MB,
// 0.100 ms at 3.35 TB/s, with only 256 blocks of 32 channels to carry
// them. Two kernels, each bit for bit equal to the plain loop:
//
// rglru_scan_bwd_staged (D % 4 == 0, 16-byte aligned tensors): the
// forward's staged ring run in reverse, fed by the Tensor Memory
// Accelerator's 2-D boxes. A block owns 32 channels of one batch row,
// grid (ceil(D/32), B). Stage st holds the kSteps timesteps ending at t =
// S-1-st·kSteps, three boxes of kSteps × 32 floats: dh[t], a[t+1] and
// h[t-1], each box one tensor-map copy (cp.async.bulk.tensor) onto the
// slot's full mbarrier, one row apart in the (B·S, D) view of its
// tensor. The hardware bounds the boxes: the D tail's columns and rows
// before the tensor's first or after its last arrive as zeros, so no
// copy reads out of bounds; the rows a box takes from a neighbouring
// batch row (a[S] at t = S-1, h[-1] at t = 0, and the last stage's rows
// before t = 0) are never used (g starts from dh[S-1]; da[0] = g·0).
// The producer lane refills a slot once the consumer warp releases it on
// empty; the consumer runs g from shared memory and stores db and da,
// 128 bytes each a warp a step. 24 KB a stage, 72 KB of ring, three
// blocks an SM: all 256 blocks of the training shape resident, ~48 KB in
// flight each. Three copies a stage, not one a 128-byte row (192 a
// stage): at two blocks an SM the row copies' own cost, not the bytes,
// held that form to ~55 % of the bound on the H100.
//
// rglru_scan_bwd_loop (any other D): one thread per (b, d) channel walks
// t from S-1 down to 0, neighbouring threads on neighbouring d; blocks of
// one warp spread the channels over every SM, and kBwdUnroll steps of
// loads are issued ahead of their adds. The S tail runs step by step;
// idle threads of the D tail return at once.
#include <cuda.h>   // CUtensorMap and its enums (types only: no libcuda link)
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;    // channels per staged block (one warp)
constexpr int kSteps = 64;    // timesteps per stage
constexpr int kStages = 3;    // stages in the ring
constexpr int kStageFloats = 2 * kSteps * kLanes;   // a then b
constexpr int kSmemBytes = kStages * kStageFloats * 4;

constexpr int kThreads = 128;   // register-loop kernel
constexpr int kUnroll = 8;

constexpr int kBwdThreads = 32;  // backward loop: one warp a block
constexpr int kBwdUnroll = 16;
// backward staged ring: dh, then a[t+1], then h[t-1] a stage
constexpr int kBwdStageFloats = 3 * kSteps * kLanes;
constexpr int kBwdSmemBytes = kStages * kBwdStageFloats * 4;

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
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// A 2-D box of the tensor map `map` at (column c0, row c1) into shared
// memory; parts of the box outside the tensor arrive as zeros, and the
// whole box's bytes count on the barrier.
__device__ __forceinline__ void tensor_copy(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Warp 1 (its lane 0) is the producer: it posts each stage's byte count
// on full[slot] and copies the stage's a and b rows, waiting on
// empty[slot] before it refills a slot. Warp 0 consumes: it waits on
// full[slot], runs the stage's steps from shared memory and releases the
// slot on empty[slot].
__global__ void __launch_bounds__(2 * kLanes)
rglru_scan_staged(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ h, long long seq, long long width) {
  extern __shared__ __align__(128) float ring[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const long long d0 = (long long)blockIdx.x * kLanes;
  const int cols = (int)min((long long)kLanes, width - d0);
  const long long base = (long long)blockIdx.y * seq * width + d0;
  const long long n_stages = (seq + kSteps - 1) / kSteps;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 1) {
    if (lane == 0) {
      const uint32_t row = (uint32_t)cols * 4u;
      for (long long st = 0; st < n_stages; ++st) {
        const int slot = (int)(st % kStages);
        if (st >= kStages)
          mbar_wait(&empty[slot], (uint32_t)((st / kStages - 1) & 1));
        const long long t0 = st * kSteps;
        const int n = (int)min((long long)kSteps, seq - t0);
        float* sa = ring + slot * kStageFloats;
        float* sb = sa + kSteps * kLanes;
        mbar_expect_tx(&full[slot], 2u * n * row);
        for (int t = 0; t < n; ++t) {
          const long long off = base + (t0 + t) * width;
          bulk_copy(sa + t * kLanes, a + off, row, &full[slot]);
          bulk_copy(sb + t * kLanes, b + off, row, &full[slot]);
        }
      }
    }
    return;
  }

  float carry = 0.0f;
  float* hp = h + base + lane;
  for (long long st = 0; st < n_stages; ++st) {
    const int slot = (int)(st % kStages);
    mbar_wait(&full[slot], (uint32_t)((st / kStages) & 1));
    const float* sa = ring + slot * kStageFloats + lane;
    const float* sb = sa + kSteps * kLanes;
    const long long t0 = st * kSteps;
    const int n = (int)min((long long)kSteps, seq - t0);
    float* ht = hp + t0 * width;
    if (n == kSteps) {
#pragma unroll 8
      for (int t = 0; t < kSteps; ++t) {
        carry = sa[t * kLanes] * carry + sb[t * kLanes];
        if (lane < cols) ht[t * width] = carry;
      }
    } else {
      for (int t = 0; t < n; ++t) {
        carry = sa[t * kLanes] * carry + sb[t * kLanes];
        if (lane < cols) ht[t * width] = carry;
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
  }
}

__global__ void __launch_bounds__(kThreads)
rglru_scan_loop(const float* __restrict__ a, const float* __restrict__ b,
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

// Warp 1 (its lane 0) produces, warp 0 consumes. Stage st ends at t = hi
// = S-1-st·kSteps and its box starts at row hi-kSteps+1 of the batch row
// (rows before t = 0, in the previous batch row or before the tensor,
// are loaded and never used): row r of each array holds t = hi-kSteps+1
// +r, read as dh[t], a[t+1] and h[t-1] through boxes one row apart.
__global__ void __launch_bounds__(2 * kLanes)
rglru_scan_bwd_staged(const __grid_constant__ CUtensorMap a_map,
                      const __grid_constant__ CUtensorMap h_map,
                      const __grid_constant__ CUtensorMap dh_map,
                      float* __restrict__ da, float* __restrict__ db,
                      long long seq, long long width) {
  extern __shared__ __align__(128) float ring[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int d0 = blockIdx.x * kLanes;
  const int cols = (int)min((long long)kLanes, width - d0);
  const long long base = (long long)blockIdx.y * seq * width + d0;
  const long long n_stages = (seq + kSteps - 1) / kSteps;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 1) {
    if (lane == 0) {
      for (long long st = 0; st < n_stages; ++st) {
        const int slot = (int)(st % kStages);
        if (st >= kStages)
          mbar_wait(&empty[slot], (uint32_t)((st / kStages - 1) & 1));
        const int row0 = (int)(blockIdx.y * seq + seq - st * kSteps
                               - kSteps);
        float* sdh = ring + slot * kBwdStageFloats;
        mbar_expect_tx(&full[slot], kBwdStageFloats * 4);
        tensor_copy(sdh, &dh_map, d0, row0, &full[slot]);
        tensor_copy(sdh + kSteps * kLanes, &a_map, d0, row0 + 1,
                    &full[slot]);
        tensor_copy(sdh + 2 * kSteps * kLanes, &h_map, d0, row0 - 1,
                    &full[slot]);
      }
    }
    return;
  }

  float g = 0.0f;
  for (long long st = 0; st < n_stages; ++st) {
    const int slot = (int)(st % kStages);
    mbar_wait(&full[slot], (uint32_t)((st / kStages) & 1));
    const float* sdh = ring + slot * kBwdStageFloats + lane;
    const float* sa = sdh + kSteps * kLanes;
    const float* sh = sa + kSteps * kLanes;
    const long long t0 = seq - (st + 1) * kSteps;   // row 0's t (may be < 0)
    if (st > 0 && t0 > 0) {   // every row has both shifts
      float* dat = da + base + lane + t0 * width;
      float* dbt = db + base + lane + t0 * width;
#pragma unroll 8
      for (int r = kSteps - 1; r >= 0; --r) {
        g = sdh[r * kLanes] + sa[r * kLanes] * g;
        if (lane < cols) {
          dbt[r * width] = g;
          dat[r * width] = g * sh[r * kLanes];
        }
      }
    } else {
      for (int r = kSteps - 1; r >= 0 && t0 + r >= 0; --r) {
        const long long t = t0 + r;
        g = t == seq - 1 ? sdh[r * kLanes]
                         : sdh[r * kLanes] + sa[r * kLanes] * g;
        if (lane < cols) {
          db[base + lane + t * width] = g;
          da[base + lane + t * width] = g * (t > 0 ? sh[r * kLanes] : 0.0f);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
  }
}

__global__ void __launch_bounds__(kBwdThreads)
rglru_scan_bwd_loop(const float* __restrict__ a, const float* __restrict__ h,
                    const float* __restrict__ dh, float* __restrict__ da,
                    float* __restrict__ db, long long channels,
                    long long seq, long long width) {
  const long long ch = (long long)blockIdx.x * kBwdThreads + threadIdx.x;
  if (ch >= channels) return;
  const long long base = (ch / width) * seq * width + ch % width;
  const float* ap = a + base;
  const float* hp = h + base;
  const float* dhp = dh + base;
  float* dap = da + base;
  float* dbp = db + base;
  long long t = seq - 1;
  float g = dhp[t * width];
  dbp[t * width] = g;
  dap[t * width] = g * (t > 0 ? hp[(t - 1) * width] : 0.0f);
  --t;
  // Whole groups of steps t, t-1, ..., t-kBwdUnroll+1, all >= 1, so each
  // reads h[t-1].
  for (; t >= kBwdUnroll; t -= kBwdUnroll) {
    float av[kBwdUnroll], dv[kBwdUnroll], hv[kBwdUnroll];
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u) {
      av[u] = ap[(t - u + 1) * width];
      dv[u] = dhp[(t - u) * width];
      hv[u] = hp[(t - u - 1) * width];
    }
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u) {
      g = dv[u] + av[u] * g;
      dbp[(t - u) * width] = g;
      dap[(t - u) * width] = g * hv[u];
    }
  }
  for (; t >= 0; --t) {
    g = dhp[t * width] + ap[(t + 1) * width] * g;
    dbp[t * width] = g;
    dap[t * width] = g * (t > 0 ? hp[(t - 1) * width] : 0.0f);
  }
}

}  // namespace

// a, b, h: (batch, seq, width) fp32, contiguous, on the device; width % 4
// == 0 and a, b 16-byte aligned. Launches the staged kernel on `stream`
// and returns cudaGetLastError().
extern "C" int rglru_scan_staged_launch(const void* a, const void* b, void* h,
                                        int batch, long long seq,
                                        long long width, void* stream) {
  static bool allowed = false;
  if (!allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        rglru_scan_staged, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    allowed = true;
  }
  const dim3 grid((unsigned)((width + kLanes - 1) / kLanes), (unsigned)batch);
  rglru_scan_staged<<<grid, 2 * kLanes, kSmemBytes,
                      (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (float*)h, seq, width);
  return (int)cudaGetLastError();
}

// a, b, h: (batch, seq, width) fp32, contiguous, on the device, any width.
// Launches the register-loop kernel on `stream` and returns
// cudaGetLastError().
extern "C" int rglru_scan_loop_launch(const void* a, const void* b, void* h,
                                      int batch, long long seq,
                                      long long width, void* stream) {
  const long long channels = (long long)batch * width;
  const unsigned grid = (unsigned)((channels + kThreads - 1) / kThreads);
  rglru_scan_loop<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (float*)h, channels, seq, width);
  return (int)cudaGetLastError();
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, through the runtime's entry-point
// query (nothing links libcuda); null if the driver has none.
static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (rows, width) fp32 at `ptr` as a tensor map of kSteps × kLanes boxes,
// out-of-bounds elements read as zeros. Returns the driver's result.
static CUresult box_map(CUtensorMap* map, EncodeTiled encode, const void* ptr,
                        long long rows, long long width) {
  const cuuint64_t dims[2] = {(cuuint64_t)width, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)width * 4};
  const cuuint32_t box[2] = {kLanes, kSteps};
  const cuuint32_t step[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<void*>(ptr), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// a, h, dh, da, db: (batch, seq, width) fp32, contiguous, on the device;
// width % 4 == 0, all five 16-byte aligned, batch · seq + kSteps < 2^31.
// Encodes a, h and dh as tensor maps, launches the staged backward on
// `stream` and returns cudaGetLastError(), or 100000 + the driver's
// result if a map cannot be made.
extern "C" int rglru_scan_bwd_staged_launch(const void* a, const void* h,
                                            const void* dh, void* da,
                                            void* db, int batch,
                                            long long seq, long long width,
                                            void* stream) {
  static bool allowed = false;
  if (!allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        rglru_scan_bwd_staged, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kBwdSmemBytes);
    if (err != cudaSuccess) return (int)err;
    allowed = true;
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  // The encoder needs a current context, which a thread that has made no
  // runtime call yet (autograd's, a new one) may lack: setting the device
  // makes its primary context current.
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap maps[3];
  const void* srcs[3] = {a, h, dh};
  for (int i = 0; i < 3; ++i) {
    const CUresult res = box_map(&maps[i], encode, srcs[i],
                                 (long long)batch * seq, width);
    if (res != CUDA_SUCCESS) return 100000 + (int)res;
  }
  const dim3 grid((unsigned)((width + kLanes - 1) / kLanes), (unsigned)batch);
  rglru_scan_bwd_staged<<<grid, 2 * kLanes, kBwdSmemBytes,
                          (cudaStream_t)stream>>>(
      maps[0], maps[1], maps[2], (float*)da, (float*)db, seq, width);
  return (int)cudaGetLastError();
}

// a, h, dh, da, db: (batch, seq, width) fp32, contiguous, on the device,
// any width. Launches the register-loop backward on `stream` and returns
// cudaGetLastError().
extern "C" int rglru_scan_bwd_loop_launch(const void* a, const void* h,
                                     const void* dh, void* da, void* db,
                                     int batch, long long seq,
                                     long long width, void* stream) {
  const long long channels = (long long)batch * width;
  const unsigned grid = (unsigned)((channels + kBwdThreads - 1) /
                                   kBwdThreads);
  rglru_scan_bwd_loop<<<grid, kBwdThreads, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)h, (const float*)dh, (float*)da,
      (float*)db, channels, seq, width);
  return (int)cudaGetLastError();
}

// The staged kernels' geometry: {channels per block, timesteps per stage,
// stages in the ring, dynamic shared-memory bytes of the forward, of the
// backward}.
extern "C" void rglru_scan_staged_geometry(int* out) {
  out[0] = kLanes;
  out[1] = kSteps;
  out[2] = kStages;
  out[3] = kSmemBytes;
  out[4] = kBwdSmemBytes;
}
