// Hand-written Hopper (sm_90a) kernels for one beam-search decode step.
//
// Together they replace the TPU kernel fpn_mt_image_captioning_tpu/ops/
// fused_decoder.py:_decoder_kernel, which ran all N decoder layers plus the
// vocabulary projection and per-row top-k in one launch, carrying the hidden
// state from grid step to grid step in VMEM. Blocks on this card run in no
// order, so that carry cannot be copied: the Python side
// (ops/fused_decoder.py:fused_decode_step) issues a fixed sequence of these
// kernels per layer instead, and the hidden state goes through device memory
// between them.
//
// Plain C interface, loaded with ctypes. Every entry point launches on the
// stream it is given, allocates nothing, and returns 0 or an error code that
// fd_error_string explains (a cudaError_t, or ENCODE_ERROR + the CUresult of
// a failed cuTensorMapEncodeTiled, or ENTRY_ERROR + the cudaError_t of a
// failed driver entry-point lookup), so a refused launch raises in the
// wrapper. dtype codes: 0 float32, 1 bfloat16.
//
// Bounds at the flagship decode shapes (B*beam = BK = 512, d = 512, H = 8,
// dff = 2048, N = 6, V = 2000, bf16 weights; H100 SXM: 3.35 TB/s, 989 TFLOP/s
// bf16) are given per kernel below.
//
// Built a second time with -DFD_TRIVIAL_BODIES (library fused_decoder_trivial)
// for the launch-cost probe (scripts/probe_launch_overhead.py): the same entry
// points launch every kernel with the same arguments, grid, block and dynamic
// shared memory, and each kernel returns at once, except that
// logsoftmax_topk writes out_s[row, j] = scores[row] (its ids stay unwritten),
// so a step's result shows that its last launch ran.

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and the driver's enums; the driver is reached through
                   // cudaGetDriverEntryPoint, so nothing links against libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>

#include <atomic>
#include <mutex>
#include <unordered_map>

namespace {

typedef __nv_bfloat16 bf16;

#ifdef FD_TRIVIAL_BODIES
constexpr bool kTrivial = true;
#else
constexpr bool kTrivial = false;
#endif

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide sum / max; every thread gets the result. blockDim.x is a
// multiple of 32, at most 1024.
__device__ float block_sum(float v) {
  __shared__ float part[32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, nw = blockDim.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) part[wid] = v;
  __syncthreads();
  v = lane < nw ? part[lane] : 0.f;
  return warp_sum(v);
}

__device__ float block_max(float v) {
  __shared__ float part[32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, nw = blockDim.x >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) part[wid] = v;
  __syncthreads();
  v = lane < nw ? part[lane] : -INFINITY;
  return warp_max(v);
}

// (value, index) pair that wins: the larger value, and on equal values the
// lower index (lax.top_k's order).
__device__ __forceinline__ void arg_better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) { v = ov; i = oi; }
}

__device__ void block_argmax(float& v, int& i) {
  __shared__ float pv[32];
  __shared__ int pi[32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, nw = blockDim.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    arg_better(v, i, __shfl_xor_sync(0xffffffffu, v, o), __shfl_xor_sync(0xffffffffu, i, o));
  __syncthreads();
  if (lane == 0) { pv[wid] = v; pi[wid] = i; }
  __syncthreads();
  v = lane < nw ? pv[lane] : -INFINITY;
  i = lane < nw ? pi[lane] : 0x7fffffff;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    arg_better(v, i, __shfl_xor_sync(0xffffffffu, v, o), __shfl_xor_sync(0xffffffffu, i, o));
}

enum { ACT_NONE = 0, ACT_LEAKY = 1, ACT_RELU = 2, ACT_RELU6 = 3, ACT_GELU = 4 };

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case ACT_LEAKY: return v > 0.f ? v : 0.2f * v;
    case ACT_RELU: return fmaxf(v, 0.f);
    case ACT_RELU6: return fminf(fmaxf(v, 0.f), 6.f);
    case ACT_GELU: {  // tanh approximation, as jax.nn.gelu
      const float c = 0.7978845608028654f;  // sqrt(2/pi)
      return 0.5f * v * (1.f + tanhf(c * (v + 0.044715f * v * v * v)));
    }
    default: return v;
  }
}

// act over all of a thread's values, one branch for them all: inlined per
// value, the switch cost the wgmma epilogue ~0.25 µs an 8-column group
// (PERF.md).
template <int NV>
__device__ __forceinline__ void activate_all(float (&v)[NV], int act) {
  if (act == ACT_LEAKY) {
#pragma unroll
    for (int i = 0; i < NV; ++i) v[i] = activate(v[i], ACT_LEAKY);
  } else if (act == ACT_RELU) {
#pragma unroll
    for (int i = 0; i < NV; ++i) v[i] = activate(v[i], ACT_RELU);
  } else if (act == ACT_RELU6) {
#pragma unroll
    for (int i = 0; i < NV; ++i) v[i] = activate(v[i], ACT_RELU6);
  } else if (act == ACT_GELU) {
#pragma unroll
    for (int i = 0; i < NV; ++i) v[i] = activate(v[i], ACT_GELU);
  }
}

// ---------------------------------------------------------------------------
// (a) decoder_linear: Y = act(X·W + b), X (M, K), W (K, N) row-major (in, out),
// b (N) float32, float32 accumulation; Y in the input dtype or float32.
// Replaces the products of _decoder_kernel at fused_decoder.py:237 (QKV),
// :409 (self out), :426 (cross q), :455 (cross out), :463 and :478 (FFN) and
// :500 (vocabulary projection).
// Bound: bytes. At BK = 512 rows a product moves M·K + K·N + M·N elements
// for 2·M·K·N operations, ~220 FLOP per byte in bf16, under the card's ~295
// FLOP/B ridge (QKV: 3.7 MB, 1.1 us, against 0.8 us of operations); at 64
// rows (batch 8) the weights' bytes bound it outright. Every shape of the
// step forms few output tiles, so what limits a simple kernel is latency:
// too few bytes in flight per SM.
//
// Design, bf16 with K and N multiples of 8 (every shape of the step):
// linear_wgmma_kernel. A CTA owns a BM × 64 output tile (BM = 64 or 128, one
// consumer warpgroup per 64 rows) and a range of 64-deep K slices. One
// producer warp streams the slices through a ring of STAGES shared-memory
// stages with TMA (cp.async.bulk.tensor, full/empty mbarrier pairs), 128-byte
// swizzle: X boxes (64 K × BM rows, K-major) and W boxes (64 N × 64 K, W's own
// (K, N) layout, MN-major, so the packed weights stay as they are). The
// consumers run wgmma.mma_async m64n64k16 bf16 → f32 straight from the
// stages (B through wgmma's transpose bit), one slice's products kept in
// flight while the next slice's are issued. Ragged M, N and K come from
// TMA's zero fill and masked stores. A plan (ops/fused_decoder.py:
// linear_plan) may split K across a thread-block cluster of SPLIT CTAs (1,
// 2, 4 or 8, a template argument): every CTA accumulates its slices, then
// the f32 partials are reduce-scattered through distributed shared memory
// (each CTA owns a band of the tile's columns, receives that band from
// every CTA and adds the bands in rank order, so the result does not change
// from run to run). The epilogue adds the bias (read before the K loop, its
// latency hidden under the stages') and applies the activation on the
// accumulator registers and stores bf16 pairs or float2 straight to device
// memory. W's tensor maps are encoded once and kept (keyed by pointer and
// shape); X's is encoded per call.
//
// float32 (and any other bf16 shape) runs linear_kernel on the CUDA cores in
// exact float32 FMA: 64×64 tile per 256-thread block, 16-deep slices, 4×4
// outputs a thread. The float32 decode is not the main path.
// ---------------------------------------------------------------------------
constexpr int LBM = 64, LBN = 64, LBK = 16;

template <typename T, typename TO>
__global__ void __launch_bounds__(256) linear_kernel(
    const T* __restrict__ X, const T* __restrict__ W, const float* __restrict__ bias,
    TO* __restrict__ Y, int M, int N, int K, int act) {
  if (kTrivial) return;
  __shared__ float As[LBK][LBM + 4];
  __shared__ float Bs[LBK][LBN];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * LBM, n0 = blockIdx.x * LBN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += LBK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + 256 * i;
      const int r = e >> 4, c = e & 15, gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? to_f(X[(size_t)gm * K + gk]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + 256 * i;
      const int r = e >> 6, c = e & 63, gk = k0 + r, gn = n0 + c;
      Bs[r][c] = (gk < K && gn < N) ? to_f(W[(size_t)gk * N + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < LBK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N) Y[(size_t)gm * N + gn] = from_f<TO>(activate(acc[i][j] + bias[gn], act));
    }
  }
}

// --- Hopper primitives: mbarriers, TMA, wgmma ------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// 2-D TMA load of the box at (c0 innermost, c1) into dst, completing on bar.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (all in 16-byte units), layout type 1.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving accumulator reads or writes across an
// asynchronous wgmma.
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64×64, f32, accumulated) += A (64×16, K-major) · B (16×64, MN-major).
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

constexpr int WG_BN = 64, WG_BK = 64;

constexpr int WG_B_BYTES = WG_BK * WG_BN * 2;  // one W box: 64 K rows of 128 bytes

#ifdef FD_PHASE_TIMES
// Per-CTA timestamps of linear_wgmma_kernel's phases (thread 0's SM clock at
// entry, after the barrier set-up, at the first slice's arrival, after the K
// loop, after each cluster barrier, after the reduction and at the end; the
// global timer at entry and end), for the last launch; fd_phase_times reads
// them (scripts/linear_phases.py). They stand in for a stall profile where
// no Nsight Compute is at hand.
constexpr int PHASE_CTAS = 4096;
__device__ long long g_phase[PHASE_CTAS][10];
#define FD_PHASE(k) \
  if (threadIdx.x == 0) t_phase[k] = clock64();
#else
#define FD_PHASE(k)
#endif

// Ring depth: 6 stages of 16 KB for 64-row tiles, 4 of 24 KB for 128-row
// tiles; ~97 KB either way, two CTAs an SM.
template <int NWG>
__host__ __device__ constexpr int wg_stages() { return NWG == 1 ? 6 : 4; }

template <int NWG>
__host__ __device__ constexpr int wg_smem_bytes() {
  // 1 KB of slack to align the stages to the 128-byte swizzle's 1 KB period
  return 1024 + wg_stages<NWG>() * (NWG * 64 * WG_BK * 2 + WG_B_BYTES) + 2 * wg_stages<NWG>() * 8;
}

// Block: NWG consumer warpgroups (rows 64·wg .. of the tile), then one
// producer warp. Grid: (SPLIT, N tiles, M tiles); with SPLIT > 1 the launch
// is a cluster of (SPLIT, 1, 1), CTA `rank` takes K slices
// [rank·kslices, (rank+1)·kslices) and stores column band `rank` of the
// tile (64 / SPLIT columns: BAND = 32 / SPLIT accumulator registers a thread).
template <int NWG, int SPLIT, typename TO>
__global__ void __launch_bounds__(NWG * 128 + 32) linear_wgmma_kernel(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
    const float* __restrict__ bias, TO* __restrict__ Y, int M, int N, int kslices, int act) {
  if (kTrivial) return;
#ifdef FD_PHASE_TIMES
  long long t_phase[8] = {};
  unsigned long long g_enter = 0, g_exit = 0;
  if (threadIdx.x == 0) asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g_enter));
  FD_PHASE(0)
#endif
  namespace cg = cooperative_groups;
  constexpr int BM = NWG * 64, NT = NWG * 128, STAGES = wg_stages<NWG>();
  constexpr int A_BYTES = BM * WG_BK * 2, STAGE_BYTES = A_BYTES + WG_B_BYTES;
  constexpr int BAND = 32 / SPLIT, JB = 8 / SPLIT;  // registers, 8-column groups a band
  extern __shared__ unsigned char smem_raw[];
  unsigned char* stages = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  const int rank = SPLIT > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int n0 = blockIdx.y * WG_BN, m0 = blockIdx.z * BM, kbase = rank * kslices;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool producer = warp == NWG * 4;

  auto load = [&](int i) {  // slice i of this CTA into stage i % STAGES
    const int s = i % STAGES, k0 = (kbase + i) * WG_BK;
    unsigned char* st = stages + s * STAGE_BYTES;
    mbar_expect_tx(&full[s], STAGE_BYTES);
    tma_load_2d(st, &xmap, &full[s], k0, m0);
    tma_load_2d(st + A_BYTES, &wmap, &full[s], n0, k0);
  };
  // the producer lane sets the barriers up and starts the first loads
  // before the block meets
  if (producer && lane == 0) {
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&xmap)) : "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&wmap)) : "memory");
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int i = 0; i < min(STAGES, kslices); ++i) load(i);
  }
  __syncthreads();
  FD_PHASE(1)

  // accumulator layout of m64nNk16: warp w of the warpgroup holds rows
  // 16w + lane/4 (registers 4j, 4j+1) and 16w + lane/4 + 8 (4j+2, 4j+3),
  // columns 8j + 2·(lane % 4) + {0, 1}
  float acc[32];
  float2 bv[JB];  // the bias of this thread's columns in its band
  if (producer) {
    if (lane == 0) {
      for (int i = STAGES; i < kslices; ++i) {
        mbar_wait(&empty[i % STAGES], ((i / STAGES) + 1) & 1);
        load(i);
      }
    }
    __syncwarp();
  } else {
    const int wg = warp >> 2;
    // read before the K loop, so their latency hides under the stages'
#pragma unroll
    for (int jl = 0; jl < JB; ++jl) {
      const int col = n0 + 8 * (rank * JB + jl) + 2 * (lane & 3);
      bv[jl] = col < N ? make_float2(__ldg(bias + col), __ldg(bias + col + 1))
                       : make_float2(0.f, 0.f);  // N is even: col + 1 < N too
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] = 0.f;
    for (int i = 0; i < kslices; ++i) {
      const int s = i % STAGES;
      mbar_wait(&full[s], (i / STAGES) & 1);
      if (i == 0) { FD_PHASE(2) }
      const unsigned char* a = stages + s * STAGE_BYTES + wg * 64 * WG_BK * 2;
      const unsigned char* b = stages + s * STAGE_BYTES + A_BYTES;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk) {
        // A: K-major rows of 128 B, 8-row groups 1 KB apart; a 16-deep step
        // moves 32 B along the row. B: MN-major, 16 K rows (2 KB) a step, its
        // 8-row groups 1 KB apart; the 64-wide tile is one swizzle atom, so
        // only that 1 KB stride is read, whichever field the unit reads it from.
        wgmma_m64n64k16(acc, sw128_desc(a + kk * 32, 16, 1024),
                        sw128_desc(b + kk * 16 * 128, 1024, 1024));
      }
      wgmma_commit();
      // this slice's products stay in flight; the previous slice's are done,
      // so its stage goes back to the producer
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      fence_acc(acc);
      if (lane == 0 && i > 0) mbar_arrive(&empty[(i - 1) % STAGES]);
    }
    wgmma_wait_all();
    fence_acc(acc);
  }
  FD_PHASE(3)

  float out[BAND];  // this CTA's band, reduced over the cluster
  if constexpr (SPLIT > 1) {
    // Reduce-scatter through distributed shared memory: each CTA pushes band
    // q of its partial tile into slot `rank` of CTA q's stages (float4 chunks,
    // consecutive threads 16 B apart), and CTA q adds its slots in rank
    // order, so the sum is the same on every run. The first cluster barrier
    // keeps pushes out of stages still being read; the second makes them
    // visible.
    cg::cluster_group cluster = cg::this_cluster();
    float4* slots = reinterpret_cast<float4*>(stages);  // [SPLIT][BAND / 4][NT]
    cluster.sync();
    FD_PHASE(4)
    if (!producer) {
#pragma unroll
      for (int q = 0; q < SPLIT; ++q) {
        float4* dst = cluster.map_shared_rank(slots, q) + rank * (BAND / 4) * NT + threadIdx.x;
#pragma unroll
        for (int c = 0; c < BAND / 4; ++c) {
          const int j = q * BAND + 4 * c;
          dst[c * NT] = make_float4(acc[j], acc[j + 1], acc[j + 2], acc[j + 3]);
        }
      }
    }
    cluster.sync();
    FD_PHASE(5)
    if (!producer) {
#pragma unroll
      for (int i = 0; i < BAND; ++i) out[i] = 0.f;
#pragma unroll
      for (int r = 0; r < SPLIT; ++r) {
#pragma unroll
        for (int c = 0; c < BAND / 4; ++c) {
          const float4 v = slots[(r * (BAND / 4) + c) * NT + threadIdx.x];
          out[4 * c] += v.x;
          out[4 * c + 1] += v.y;
          out[4 * c + 2] += v.z;
          out[4 * c + 3] += v.w;
        }
      }
    }
    FD_PHASE(6)
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i) out[i] = acc[i];
  }
  if (!producer) {
    // out[4·jl + 2·h + e]: row + 8·h, column col(jl) + e
#pragma unroll
    for (int i = 0; i < BAND; ++i) out[i] += (i & 1) ? bv[i / 4].y : bv[i / 4].x;
    activate_all(out, act);
    const int wg = warp >> 2;
    const int row = m0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
    for (int jl = 0; jl < JB; ++jl) {
      const int col = n0 + 8 * (rank * JB + jl) + 2 * (lane & 3);
      if (col >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row + 8 * h;
        if (r < M) store_pair(Y + (size_t)r * N + col, out[4 * jl + 2 * h], out[4 * jl + 2 * h + 1]);
      }
    }
  }
#ifdef FD_PHASE_TIMES
  FD_PHASE(7)
  if (threadIdx.x == 0) {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g_exit));
    const int cta = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
    if (cta < PHASE_CTAS) {
#pragma unroll
      for (int k = 0; k < 8; ++k) g_phase[cta][k] = t_phase[k];
      g_phase[cta][8] = (long long)g_enter;
      g_phase[cta][9] = (long long)g_exit;
    }
  }
#endif
}

// ---------------------------------------------------------------------------
// (b) decoder_add_layernorm: out = LN(y + r) over d, float32 statistics,
// mean then mean of squared deviations, eps 1e-6, float32 scale/shift
// (_decoder_kernel's layer_norm, fused_decoder.py:226-230, at :410, :456,
// :479). y is float32 (a linear's output), r is the input dtype (the layer
// input) or float32 (the carried out1/out2, kept float32 as the TPU kernel
// keeps them). Writes the float32 result (when out_f is given) and its cast.
// Bound: bytes — at 512×512 it reads 1–2 MB and writes 1.5 MB, ~1 us.
// Design: one warp per row, four rows per 128-thread block, no shared memory
// and no __syncthreads. Where d is a multiple of 128 up to 1024 and every
// pointer is 16-byte aligned (the step's case), a lane holds d/32 values in
// registers (NC = d/128 float4 chunks, a template argument): it issues all
// its loads (y, gamma, beta as float4; r as four
// values a vector, 16 bytes in float32 and 8 in bf16) before the first of the
// two warp-shuffle reductions, and stores out_f and out_t as vectors. Other d
// take the same warp per row through a strided loop that reads the row again
// for each pass.
// ---------------------------------------------------------------------------
constexpr int LN_ROWS = 4, LN_MAX_CHUNKS = 8;  // float4 chunks a lane: d <= 32·4·8

__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y), b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// NC > 0: d = 128·NC, in registers; NC = 0: any d, strided.
template <typename T, typename R, int NC>
__global__ void __launch_bounds__(32 * LN_ROWS) add_layernorm_kernel(
    const float* __restrict__ y, const R* __restrict__ r, const float* __restrict__ gamma,
    const float* __restrict__ beta, float* __restrict__ out_f, T* __restrict__ out_t,
    int rows, int d, float eps) {
  if (kTrivial) return;
  const int lane = threadIdx.x & 31, row = blockIdx.x * LN_ROWS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const size_t off = (size_t)row * d;
  const float inv_d = 1.f / d;
  if constexpr (NC > 0) {
    float4 v[NC], g[NC], b[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int e = (c * 32 + lane) * 4;
      const float4 a = load4(y + off + e), rr = load4(r + off + e);
      v[c] = make_float4(a.x + rr.x, a.y + rr.y, a.z + rr.z, a.w + rr.w);
      g[c] = load4(gamma + e);
      b[c] = load4(beta + e);
    }
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) s += (v[c].x + v[c].y) + (v[c].z + v[c].w);
    const float mu = warp_sum(s) * inv_d;
    float q = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      v[c] = make_float4(v[c].x - mu, v[c].y - mu, v[c].z - mu, v[c].w - mu);
      q += (v[c].x * v[c].x + v[c].y * v[c].y) + (v[c].z * v[c].z + v[c].w * v[c].w);
    }
    const float rstd = rsqrtf(warp_sum(q) * inv_d + eps);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int e = (c * 32 + lane) * 4;
      const float4 o = make_float4(v[c].x * rstd * g[c].x + b[c].x, v[c].y * rstd * g[c].y + b[c].y,
                                   v[c].z * rstd * g[c].z + b[c].z, v[c].w * rstd * g[c].w + b[c].w);
      if (out_f) store4(out_f + off + e, o);
      store4(out_t + off + e, o);
    }
  } else {
    float s = 0.f;
    for (int e = lane; e < d; e += 32) s += y[off + e] + to_f(r[off + e]);
    const float mu = warp_sum(s) * inv_d;
    float q = 0.f;
    for (int e = lane; e < d; e += 32) {
      const float c = y[off + e] + to_f(r[off + e]) - mu;
      q += c * c;
    }
    const float rstd = rsqrtf(warp_sum(q) * inv_d + eps);
    for (int e = lane; e < d; e += 32) {
      const float o = (y[off + e] + to_f(r[off + e]) - mu) * rstd * gamma[e] + beta[e];
      if (out_f) out_f[off + e] = o;
      out_t[off + e] = from_f<T>(o);
    }
  }
}

// Softmax in place over n logits held in shared memory by one warp; returns
// 1/sum so the caller scales the exponentials (they are left unnormalized).
__device__ __forceinline__ float warp_softmax_exp(float* lg, int n) {
  const int lane = threadIdx.x & 31;
  float m = -INFINITY;
  for (int p = lane; p < n; p += 32) m = fmaxf(m, lg[p]);
  m = warp_max(m);
  float s = 0.f;
  for (int p = lane; p < n; p += 32) {
    const float e = expf(lg[p] - m);
    lg[p] = e;
    s += e;
  }
  s = warp_sum(s);
  __syncwarp();
  return 1.f / s;
}

constexpr int MAX_DH_REGS = 4;  // head width up to 128

// ---------------------------------------------------------------------------
// (c) decoder_self_attention, one block per row, one warp per head.
// Writes this position's k_t/v_t (from the fused QKV output) into the
// position-major cache k_self[layer, pos, row] / v_self[...], attends over
// positions p < pos through the beam ancestry — physical row
// (row / beam) * beam + src_t[p, row], an indexed load replacing the TPU's
// one-hot ancestry matmul (fused_decoder.py:340-353) — and takes the current
// position's term straight from k_t/v_t (:274-278, :365-384). Scale 1/sqrt(dh),
// float32 softmax and context; context cast to the input dtype.
// The history reads never touch slot pos, which this kernel writes, so no
// ordering between blocks is needed (the TPU's kw.wait() has no counterpart).
// Bound: bytes — the history K/V rows it must read, pos·BK·d·2 elements per
// layer (1 MB per position at bf16: ~31 MB, 9 us, at pos 30); its operations
// are 4·BK·d per position, far below the ridge.
// Design: each lane holds dh/32 query values in registers; per position a warp
// reads the head's 64 contiguous K values (128 B) and reduces with shuffles;
// the logits of all positions sit in shared memory for the softmax; the V pass
// accumulates in registers. All BK·H warps are resident at once, which hides
// the gather's latency.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void self_attention_kernel(
    const T* __restrict__ qkv, T* __restrict__ k_layer, T* __restrict__ v_layer,
    const int* __restrict__ src_t, T* __restrict__ ctx, int BK, int d, int H, int beam,
    int pos, float scale) {
  if (kTrivial) return;
  extern __shared__ float lg_all[];
  const int row = blockIdx.x, h = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int dh = d / H, n = pos + 1;
  float* lg = lg_all + h * n;
  const T* q = qkv + (size_t)row * 3 * d + h * dh;
  const T* kt = q + d;
  const T* vt = q + 2 * d;
  T* krow = k_layer + ((size_t)pos * BK + row) * d + h * dh;
  T* vrow = v_layer + ((size_t)pos * BK + row) * d + h * dh;

  float qr[MAX_DH_REGS], kc[MAX_DH_REGS], vc[MAX_DH_REGS];
#pragma unroll
  for (int i = 0; i < MAX_DH_REGS; ++i) {
    const int e = lane + 32 * i;
    const bool ok = e < dh;
    qr[i] = ok ? to_f(q[e]) * scale : 0.f;
    kc[i] = ok ? to_f(kt[e]) : 0.f;
    vc[i] = ok ? to_f(vt[e]) : 0.f;
    if (ok) { krow[e] = kt[e]; vrow[e] = vt[e]; }
  }
  const int base = (row / beam) * beam;
  for (int p = 0; p < pos; ++p) {
    const T* kp = k_layer + ((size_t)p * BK + base + src_t[(size_t)p * BK + row]) * d + h * dh;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < MAX_DH_REGS; ++i) {
      const int e = lane + 32 * i;
      if (e < dh) s = fmaf(qr[i], to_f(kp[e]), s);
    }
    s = warp_sum(s);
    if (lane == 0) lg[p] = s;
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < MAX_DH_REGS; ++i) s = fmaf(qr[i], kc[i], s);
  s = warp_sum(s);
  if (lane == 0) lg[pos] = s;
  __syncwarp();
  const float inv = warp_softmax_exp(lg, n);

  float acc[MAX_DH_REGS];
#pragma unroll
  for (int i = 0; i < MAX_DH_REGS; ++i) acc[i] = lg[pos] * inv * vc[i];
  for (int p = 0; p < pos; ++p) {
    const T* vp = v_layer + ((size_t)p * BK + base + src_t[(size_t)p * BK + row]) * d + h * dh;
    const float w = lg[p] * inv;
#pragma unroll
    for (int i = 0; i < MAX_DH_REGS; ++i) {
      const int e = lane + 32 * i;
      if (e < dh) acc[i] = fmaf(w, to_f(vp[e]), acc[i]);
    }
  }
  T* out = ctx + (size_t)row * d + h * dh;
#pragma unroll
  for (int i = 0; i < MAX_DH_REGS; ++i) {
    const int e = lane + 32 * i;
    if (e < dh) out[e] = from_f<T>(acc[i]);
  }
}

// ---------------------------------------------------------------------------
// (d) decoder_cross_attention, one block per row, one warp per head, over the
// per-item encoder K/V kv_cross[layer] (Lenc, B, 2d): row r reads item
// r / beam — an index, replacing the TPU's one-hot beam-expansion matmul
// (fused_decoder.py:425-453). Scale 1/sqrt(dh), float32 softmax.
// Bound: bytes — the layer's cross K/V is Lenc·B·2d elements (1 MB at bf16,
// ~0.3 us) plus q and the context (1 MB); beams of one item share their K/V
// rows through the cache.
// Design: as (c), with Lenc = 16 positions.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void cross_attention_kernel(
    const T* __restrict__ q2, const T* __restrict__ kv_layer, T* __restrict__ ctx,
    int B, int Lenc, int d, int H, int beam, float scale) {
  if (kTrivial) return;
  extern __shared__ float lg_all[];
  const int row = blockIdx.x, h = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int dh = d / H, item = row / beam;
  float* lg = lg_all + h * Lenc;
  const T* q = q2 + (size_t)row * d + h * dh;
  float qr[MAX_DH_REGS];
#pragma unroll
  for (int i = 0; i < MAX_DH_REGS; ++i) {
    const int e = lane + 32 * i;
    qr[i] = e < dh ? to_f(q[e]) * scale : 0.f;
  }
  for (int p = 0; p < Lenc; ++p) {
    const T* kp = kv_layer + ((size_t)p * B + item) * 2 * d + h * dh;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < MAX_DH_REGS; ++i) {
      const int e = lane + 32 * i;
      if (e < dh) s = fmaf(qr[i], to_f(kp[e]), s);
    }
    s = warp_sum(s);
    if (lane == 0) lg[p] = s;
  }
  __syncwarp();
  const float inv = warp_softmax_exp(lg, Lenc);
  float acc[MAX_DH_REGS] = {0.f, 0.f, 0.f, 0.f};
  for (int p = 0; p < Lenc; ++p) {
    const T* vp = kv_layer + ((size_t)p * B + item) * 2 * d + d + h * dh;
    const float w = lg[p] * inv;
#pragma unroll
    for (int i = 0; i < MAX_DH_REGS; ++i) {
      const int e = lane + 32 * i;
      if (e < dh) acc[i] = fmaf(w, to_f(vp[e]), acc[i]);
    }
  }
  T* out = ctx + (size_t)row * d + h * dh;
#pragma unroll
  for (int i = 0; i < MAX_DH_REGS; ++i) {
    const int e = lane + 32 * i;
    if (e < dh) out[e] = from_f<T>(acc[i]);
  }
}

// ---------------------------------------------------------------------------
// (e) decoder_logsoftmax_topk, one block per row (_decoder_kernel's final
// cell, fused_decoder.py:497-526): max and logsumexp over V; the beam freeze
// lp = fin*pad_row + (1-fin)*lp with pad_row = 0 at column 0 and -1e9
// elsewhere (so a finished row carries its score on the pad token); + the
// row's running score; then the top `topk` (score, id) pairs in descending
// order, ties to the LOWEST id, by iterated block arg-max.
// Bound: bytes — reads BK·V float32 logits (4.1 MB at V 2000, ~1.2 us).
// Design: the row's totals are staged in shared memory (V·4 bytes); each of
// the topk rounds is one block arg-max and knocks its winner out with -1e30.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(256) logsoftmax_topk_kernel(
    const float* __restrict__ logits, const float* __restrict__ scores,
    const float* __restrict__ fin, float* __restrict__ out_s, int* __restrict__ out_i,
    int V, int topk) {
  extern __shared__ float tot[];
  const int row = blockIdx.x;
  if (kTrivial) {
    for (int j = threadIdx.x; j < topk; j += blockDim.x) out_s[(size_t)row * topk + j] = scores[row];
    return;
  }
  const float* lg = logits + (size_t)row * V;
  float m = -INFINITY;
  for (int c = threadIdx.x; c < V; c += blockDim.x) m = fmaxf(m, lg[c]);
  m = block_max(m);
  float s = 0.f;
  for (int c = threadIdx.x; c < V; c += blockDim.x) s += expf(lg[c] - m);
  const float lse = m + logf(block_sum(s));
  const float f = fin[row], sc = scores[row];
  for (int c = threadIdx.x; c < V; c += blockDim.x) {
    const float pad = c == 0 ? 0.f : -1e9f;
    tot[c] = f * pad + (1.f - f) * (lg[c] - lse) + sc;
  }
  __syncthreads();
  for (int j = 0; j < topk; ++j) {
    float bv = -INFINITY;
    int bi = 0x7fffffff;
    for (int c = threadIdx.x; c < V; c += blockDim.x) arg_better(bv, bi, tot[c], c);
    block_argmax(bv, bi);
    if (threadIdx.x == 0) {
      out_s[(size_t)row * topk + j] = bv;
      out_i[(size_t)row * topk + j] = bi;
      tot[bi] = -1e30f;
    }
    __syncthreads();
  }
}

inline int last_error() { return (int)cudaGetLastError(); }

// --- host side of decoder_linear: tensor maps and the launch ---------------
constexpr int ENCODE_ERROR = 20000;
constexpr int ENTRY_ERROR = 30000;

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, looked up once; 0 or an error code.
int encode_fn(EncodeTiledFn* fn) {
  static std::atomic<EncodeTiledFn> cached{nullptr};
  EncodeTiledFn f = cached.load();
  if (!f) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess) return ENTRY_ERROR + (int)e;
    if (q != cudaDriverEntryPointSuccess || !p) return ENTRY_ERROR + (int)cudaErrorSymbolNotFound;
    f = reinterpret_cast<EncodeTiledFn>(p);
    cached.store(f);
  }
  *fn = f;
  return 0;
}

// A 2-D bf16 map over a row-major (rows, cols) matrix, boxes of (box_cols,
// box_rows), 128-byte swizzle, zero fill outside; 0 or an error code.
int encode_2d(CUtensorMap* map, const void* ptr, uint64_t rows, uint64_t cols, uint32_t box_rows,
              uint32_t box_cols) {
  EncodeTiledFn fn;
  const int rc = encode_fn(&fn);
  if (rc) return rc;
  const cuuint64_t dims[2] = {cols, rows}, strides[1] = {cols * 2};
  const cuuint32_t box[2] = {box_cols, box_rows}, ones[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                        strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_ERROR + (int)r;
}

// W's map depends only on its pointer and shape (the box is fixed), so it
// is encoded once and kept: a lookup returns exactly what an encode would.
struct WKey {
  uintptr_t ptr;
  int k, n;
  bool operator==(const WKey& o) const { return ptr == o.ptr && k == o.k && n == o.n; }
};
struct WKeyHash {
  size_t operator()(const WKey& w) const {
    return std::hash<uintptr_t>()(w.ptr) ^ ((size_t)w.k * 0x9E3779B97F4A7C15ull) ^ (size_t)w.n;
  }
};

int weight_map(CUtensorMap* map, const void* w, int K, int N) {
  static std::mutex mu;
  static std::unordered_map<WKey, CUtensorMap, WKeyHash> cache;
  const WKey key{reinterpret_cast<uintptr_t>(w), K, N};
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *map = it->second;
    return 0;
  }
  const int rc = encode_2d(map, w, K, N, WG_BK, WG_BN);
  if (rc) return rc;
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, *map);
  return 0;
}

// The dynamic shared-memory attribute, set once per kernel and device (so a
// launch, and a CUDA-graph capture of it, makes no such call).
template <typename Kern>
int allow_smem(Kern kernel, int smem, std::atomic<bool>* done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (done[dev].load()) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  done[dev].store(true);
  return 0;
}

template <int NWG, int SPLIT, typename TO>
int launch_wgmma(const CUtensorMap& xmap, const CUtensorMap& wmap, const float* b, void* y,
                 int M, int N, int grid_n, int grid_m, int kslices, int act, cudaStream_t s) {
  static std::atomic<bool> done[64];
  auto kernel = linear_wgmma_kernel<NWG, SPLIT, TO>;
  constexpr int smem = wg_smem_bytes<NWG>();
  const int rc = allow_smem(kernel, smem, done);
  if (rc) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(SPLIT, grid_n, grid_m);
  cfg.blockDim = dim3(NWG * 128 + 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = SPLIT;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = SPLIT > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, xmap, wmap, b, (TO*)y, M, N, kslices, act);
  return e != cudaSuccess ? (int)e : last_error();
}

template <int NWG, typename TO>
int launch_split(const CUtensorMap& xmap, const CUtensorMap& wmap, const float* b, void* y,
                 int M, int N, int split, int grid_n, int grid_m, int kslices, int act,
                 cudaStream_t s) {
  switch (split) {
    case 1: return launch_wgmma<NWG, 1, TO>(xmap, wmap, b, y, M, N, grid_n, grid_m, kslices, act, s);
    case 2: return launch_wgmma<NWG, 2, TO>(xmap, wmap, b, y, M, N, grid_n, grid_m, kslices, act, s);
    case 4: return launch_wgmma<NWG, 4, TO>(xmap, wmap, b, y, M, N, grid_n, grid_m, kslices, act, s);
    case 8: return launch_wgmma<NWG, 8, TO>(xmap, wmap, b, y, M, N, grid_n, grid_m, kslices, act, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* fd_error_string(int code) {
  static thread_local char msg[160];
  if (code >= ENTRY_ERROR) {
    snprintf(msg, sizeof msg, "driver entry point cuTensorMapEncodeTiled not found (%s)",
             cudaGetErrorString((cudaError_t)(code - ENTRY_ERROR)));
  } else if (code >= ENCODE_ERROR) {
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled failed with CUresult %d",
             code - ENCODE_ERROR);
  } else {
    snprintf(msg, sizeof msg, "%s", cudaGetErrorString((cudaError_t)code));
  }
  return msg;
}

// bm 0: linear_kernel (CUDA cores), its own grid. bm 64 or 128: bf16 with K
// and N multiples of 8 and x, w 16-byte aligned, linear_wgmma_kernel on the
// plan's grid (split, grid_n, grid_m), kslices 64-deep K slices a CTA.
int fd_linear(const void* x, const void* w, const float* b, void* y, int M, int N, int K,
              int dtype, int out_f32, int act, int bm, int split, int grid_n, int grid_m,
              int kslices, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bm == 0) {
    const dim3 grid((N + LBN - 1) / LBN, (M + LBM - 1) / LBM);
    if (dtype == 0) {
      linear_kernel<float, float><<<grid, 256, 0, s>>>(
          (const float*)x, (const float*)w, b, (float*)y, M, N, K, act);
    } else if (out_f32) {
      linear_kernel<bf16, float><<<grid, 256, 0, s>>>(
          (const bf16*)x, (const bf16*)w, b, (float*)y, M, N, K, act);
    } else {
      linear_kernel<bf16, bf16><<<grid, 256, 0, s>>>(
          (const bf16*)x, (const bf16*)w, b, (bf16*)y, M, N, K, act);
    }
    return last_error();
  }
  if (dtype != 1 || K % 8 || N % 8 || ((uintptr_t)x | (uintptr_t)w) % 16 ||
      (bm != 64 && bm != 128))
    return (int)cudaErrorInvalidValue;
  CUtensorMap xmap, wmap;
  int rc = encode_2d(&xmap, x, M, K, bm, WG_BK);
  if (!rc) rc = weight_map(&wmap, w, K, N);
  if (rc) return rc;
  if (bm == 64)
    return out_f32 ? launch_split<1, float>(xmap, wmap, b, y, M, N, split, grid_n, grid_m, kslices, act, s)
                   : launch_split<1, bf16>(xmap, wmap, b, y, M, N, split, grid_n, grid_m, kslices, act, s);
  return out_f32 ? launch_split<2, float>(xmap, wmap, b, y, M, N, split, grid_n, grid_m, kslices, act, s)
                 : launch_split<2, bf16>(xmap, wmap, b, y, M, N, split, grid_n, grid_m, kslices, act, s);
}

#ifdef FD_PHASE_TIMES
// The phase timestamps of the last wgmma linear's first n CTAs (10 int64
// each, see g_phase) into host memory at dst.
int fd_phase_times(void* dst, int n) {
  if (n < 0 || n > PHASE_CTAS) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyFromSymbol(dst, g_phase, (size_t)n * 10 * sizeof(long long));
}
#endif

int fd_add_layernorm(const float* y, const void* r, const float* gamma, const float* beta,
                     float* out_f, void* out_t, int rows, int d, int dtype, int r_f32,
                     float eps, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = (rows + LN_ROWS - 1) / LN_ROWS;
  const bool vec = d % 128 == 0 && d <= 128 * LN_MAX_CHUNKS &&
                   ((uintptr_t)y | (uintptr_t)r | (uintptr_t)gamma | (uintptr_t)beta |
                    (uintptr_t)out_f | (uintptr_t)out_t) % 16 == 0;
  const int nc = vec ? d / 128 : 0;
#define FD_LN_NC(T, R, NC)                                                                     \
  case NC:                                                                                     \
    add_layernorm_kernel<T, R, NC><<<blocks, 32 * LN_ROWS, 0, s>>>(                           \
        y, (const R*)r, gamma, beta, out_f, (T*)out_t, rows, d, eps);                          \
    break;
#define FD_LN(T, R)                                                                            \
  switch (nc) {                                                                                \
    FD_LN_NC(T, R, 0) FD_LN_NC(T, R, 1) FD_LN_NC(T, R, 2) FD_LN_NC(T, R, 3)                   \
    FD_LN_NC(T, R, 4) FD_LN_NC(T, R, 5) FD_LN_NC(T, R, 6) FD_LN_NC(T, R, 7)                   \
    FD_LN_NC(T, R, 8)                                                                          \
  }
  if (dtype == 0) {
    FD_LN(float, float);
  } else if (r_f32) {
    FD_LN(bf16, float);
  } else {
    FD_LN(bf16, bf16);
  }
#undef FD_LN_NC
#undef FD_LN
  return last_error();
}

int fd_self_attention(const void* qkv, void* k_layer, void* v_layer, const int* src_t,
                      void* ctx, int BK, int d, int H, int beam, int pos, float scale,
                      int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = (size_t)H * (pos + 1) * sizeof(float);
  if (dtype == 0) {
    self_attention_kernel<float><<<BK, 32 * H, smem, s>>>(
        (const float*)qkv, (float*)k_layer, (float*)v_layer, src_t, (float*)ctx, BK, d, H,
        beam, pos, scale);
  } else {
    self_attention_kernel<bf16><<<BK, 32 * H, smem, s>>>(
        (const bf16*)qkv, (bf16*)k_layer, (bf16*)v_layer, src_t, (bf16*)ctx, BK, d, H,
        beam, pos, scale);
  }
  return last_error();
}

int fd_cross_attention(const void* q, const void* kv_layer, void* ctx, int BK, int B,
                       int Lenc, int d, int H, int beam, float scale, int dtype,
                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = (size_t)H * Lenc * sizeof(float);
  if (dtype == 0) {
    cross_attention_kernel<float><<<BK, 32 * H, smem, s>>>(
        (const float*)q, (const float*)kv_layer, (float*)ctx, B, Lenc, d, H, beam, scale);
  } else {
    cross_attention_kernel<bf16><<<BK, 32 * H, smem, s>>>(
        (const bf16*)q, (const bf16*)kv_layer, (bf16*)ctx, B, Lenc, d, H, beam, scale);
  }
  return last_error();
}

int fd_logsoftmax_topk(const float* logits, const float* scores, const float* fin,
                       float* out_s, int* out_i, int BK, int V, int topk, void* stream) {
  const size_t smem = (size_t)V * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        logsoftmax_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  logsoftmax_topk_kernel<<<BK, 256, smem, (cudaStream_t)stream>>>(
      logits, scores, fin, out_s, out_i, V, topk);
  return last_error();
}

}  // extern "C"
