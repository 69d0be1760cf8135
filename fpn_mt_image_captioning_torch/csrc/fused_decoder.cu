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

// Whether (v, i) comes before (ov, oi): the larger value, and on equal values
// the lower index (lax.top_k's order).
__device__ __forceinline__ bool tk_better(float v, int i, float ov, int oi) {
  return v > ov || (v == ov && i < oi);
}

// (v, i) becomes (ov, oi) where that pair comes first.
__device__ __forceinline__ void arg_better(float& v, int& i, float ov, int oi) {
  if (tk_better(ov, oi, v, i)) { v = ov; i = oi; }
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

// --- the attention kernels' lane chunks -------------------------------------
// A lane's share of one head row: with VEC, 16 bytes (8 bf16 or 4 float32
// values) moved by one load or store; otherwise 4 values moved one at a time
// and masked to the row's end (head rows that are not a multiple of 16 bytes,
// or a pointer off a 16-byte boundary). Element i of a 16-byte chunk is read
// from its 32-bit word: a bf16 is the upper half of the float it widens to.
template <typename T, bool VEC> struct Chunk;

template <typename T> struct Chunk<T, true> {
  static constexpr int CW = 16 / (int)sizeof(T);
  uint4 u;
  __device__ __forceinline__ void load(const T* p, int) { u = __ldg(reinterpret_cast<const uint4*>(p)); }
  __device__ __forceinline__ float operator[](int i) const {
    const int k = sizeof(T) == 4 ? i : i >> 1;  // the 32-bit word that holds element i
    const uint32_t w = k == 0 ? u.x : k == 1 ? u.y : k == 2 ? u.z : u.w;
    if (sizeof(T) == 4) return __uint_as_float(w);
    return __uint_as_float(i & 1 ? w & 0xffff0000u : w << 16);
  }
};

template <typename T> struct Chunk<T, false> {
  static constexpr int CW = 4;
  float f[4];
  __device__ __forceinline__ void load(const T* p, int n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = i < n ? to_f(p[i]) : 0.f;
  }
  __device__ __forceinline__ float operator[](int i) const { return f[i]; }
};

__device__ __forceinline__ uint32_t pack_bf2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// n (<= CW) values of v, rounded to T, to p.
template <typename T, bool VEC, int CW>
__device__ __forceinline__ void store_chunk(T* p, const float (&v)[CW], int n) {
  if constexpr (VEC && sizeof(T) == 4) {
    *reinterpret_cast<uint4*>(p) = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                                              __float_as_uint(v[2]), __float_as_uint(v[3]));
  } else if constexpr (VEC) {
    *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf2(v[0], v[1]), pack_bf2(v[2], v[3]),
                                              pack_bf2(v[4], v[5]), pack_bf2(v[6], v[7]));
  } else {
#pragma unroll
    for (int i = 0; i < CW; ++i)
      if (i < n) p[i] = from_f<T>(v[i]);
  }
}

// n (<= CW) elements from src to dst, bit for bit.
template <typename T, bool VEC, int CW>
__device__ __forceinline__ void copy_chunk(T* dst, const T* src, int n) {
  if constexpr (VEC) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  } else {
#pragma unroll
    for (int i = 0; i < CW; ++i)
      if (i < n) dst[i] = src[i];
  }
}

// exp(a - m), 0 where a is -inf (an empty running max); m is finite or -inf
// together with a.
__device__ __forceinline__ float rescale(float a, float m) {
  return a == -INFINITY ? 0.f : expf(a - m);
}

// ---------------------------------------------------------------------------
// (c) decoder_self_attention (_decoder_kernel's self-attention,
// fused_decoder.py:330-400). Writes this position's k_t/v_t (from the fused
// QKV output) into the position-major cache k_self[layer, pos, row] /
// v_self[...] in place, and attends over positions p < pos through the beam
// ancestry — physical row (row / beam) * beam + src_t[p, row], an indexed
// load replacing the TPU's one-hot ancestry matmul (:340-353) — plus the
// current position, whose K/V come straight from k_t/v_t (:274-278). Scale
// 1/sqrt(dh), float32 softmax and context, context cast to the input dtype.
// The history reads never touch slot pos, which this kernel writes, so no
// ordering between blocks is needed (the TPU's kw.wait() has no counterpart).
// Bound: bytes — each distinct (position, physical row) the ancestry reaches
// is read once for K and once for V (at pos 30 of a random ancestry over
// beam 8, ~0.66 of the BK·pos rows: ~21 MB at bf16, with q, k_t, v_t, the
// ancestry and the context ~7.1 us, as chip_smoke.py counts it); its
// operations, 4·BK·d a position, are far below the ridge.
// Design: flash-decoding in one pass. A block is SA_ROWS consecutive rows
// (one warp each) on one head, so the beams of an item share a block and the
// ancestors they share come from L1; the grid puts the heads of a row group
// side by side (blockIdx.x = head), so the blocks that read one cache row's
// heads run together. The block stages the rows' physical ancestors for up
// to SA_STAGE positions in shared memory with coalesced loads; grid and
// shared memory do not depend on pos. In a warp, gw lanes (the power of two
// covering the head row's 16-byte chunks: 8 for dh 64 in bf16) take one
// position, so a warp instruction covers 32/gw positions; each lane issues
// the K and V chunks of SA_UNROLL positions before it uses any, then folds
// them into its online softmax (running max m, sum l, context acc) with one
// max and one rescale for the batch; the lane groups merge theirs with
// shuffles at the end. The kernel is bound by its instructions and the
// gathers' latency as much as by bytes: at most 64 registers a thread keep
// all 512 blocks of the flagship shape resident at once, and a lane holding
// one chunk of two positions is what fits them without spilling (more
// chunks a lane, or more positions, spilled and ran slower on the card:
// PERF.md). A head row of more than 32 chunks goes to
// self_attention_wide_kernel instead (the launcher picks by width).
// ---------------------------------------------------------------------------
constexpr int SA_ROWS = 8;     // rows a block, one warp each, all on one head
constexpr int SA_STAGE = 64;   // ancestry positions staged in shared memory at a time
constexpr int SA_UNROLL = 2;   // positions whose K and V a lane has in flight

template <typename T, bool VEC>
__global__ void __launch_bounds__(32 * SA_ROWS, 4) self_attention_kernel(
    const T* __restrict__ qkv, T* __restrict__ k_layer, T* __restrict__ v_layer,
    const int* __restrict__ src_t, T* __restrict__ ctx, int BK, int d, int H, int beam,
    int pos, float scale) {
  if (kTrivial) return;
  using C = Chunk<T, VEC>;
  constexpr int CW = C::CW, U = SA_UNROLL;
  __shared__ int phys[SA_STAGE][SA_ROWS];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.y * SA_ROWS, row = row0 + w, h = blockIdx.x;
  const int dh = d / H, nch = (dh + CW - 1) / CW;  // chunks of a head row, <= 32
  int gw = 1;
  while (gw < nch) gw <<= 1;
  const int per = 32 / gw, grp = lane / gw, c = lane % gw, e0 = c * CW;
  const bool live = row < BK, mine = live && c < nch;  // live is warp-uniform
  const int ne = min(CW, dh - e0);
  const size_t hoff = (size_t)h * dh + e0;

  float q[CW], acc[CW];
  const T* kt = qkv + (size_t)row * 3 * d + d + hoff;  // this row's k_t chunk; v_t at + d
  {
    C qc;
    if (mine) qc.load(kt - d, ne);
#pragma unroll
    for (int i = 0; i < CW; ++i) {
      q[i] = mine ? qc[i] * scale : 0.f;
      acc[i] = 0.f;
    }
  }
  if (mine && grp == 0) {
    const size_t slot = ((size_t)pos * BK + row) * d + hoff;
    copy_chunk<T, VEC, CW>(k_layer + slot, kt, ne);
    copy_chunk<T, VEC, CW>(v_layer + slot, kt + d, ne);
  }
  float m = -INFINITY, l = 0.f;
  for (int s0 = 0; s0 <= pos; s0 += SA_STAGE) {
    const int n = min(SA_STAGE, pos + 1 - s0);  // positions of this stage, pos itself last
    __syncthreads();
    for (int i = threadIdx.x; i < n * SA_ROWS; i += blockDim.x) {
      const int p = s0 + i / SA_ROWS, r = row0 + i % SA_ROWS;
      phys[i / SA_ROWS][i % SA_ROWS] =
          p < pos && r < BK ? (r / beam) * beam + src_t[(size_t)p * BK + r] : r;
    }
    __syncthreads();
    if (!live) continue;
    for (int j0 = 0; j0 < n; j0 += per * U) {
      C kc[U], vc[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u * per + grp;
        if (mine && j < n) {
          const int p = s0 + j;
          const T* kp = p < pos ? k_layer + ((size_t)p * BK + phys[j][w]) * d + hoff : kt;
          const T* vp = p < pos ? v_layer + ((size_t)p * BK + phys[j][w]) * d + hoff : kt + d;
          kc[u].load(kp, ne);
          vc[u].load(vp, ne);
        }
      }
      float s[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[u] = 0.f;
        if (mine && j0 + u * per + grp < n) {
#pragma unroll
          for (int i = 0; i < CW; ++i) s[u] = fmaf(q[i], kc[u][i], s[u]);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {  // sum over the gw lanes of a position
        if (o < gw) {
#pragma unroll
          for (int u = 0; u < U; ++u) s[u] += __shfl_xor_sync(0xffffffffu, s[u], o);
        }
      }
      // one max and one rescale for the batch's positions of this lane group
      // (uniform over the group); a lane past the head row keeps acc at 0
      float mb = m;
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (j0 + u * per + grp < n) mb = fmaxf(mb, s[u]);
      if (mb != -INFINITY) {  // else no position yet for this group
        const float a = rescale(m, mb);
        l *= a;
#pragma unroll
        for (int i = 0; i < CW; ++i) acc[i] *= a;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (j0 + u * per + grp < n) {
            const float e = expf(s[u] - mb);
            l += e;
            if (mine) {
#pragma unroll
              for (int i = 0; i < CW; ++i) acc[i] = fmaf(e, vc[u][i], acc[i]);
            }
          }
        }
        m = mb;
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {  // merge the lane groups' (m, l, acc)
    if (o >= gw) {
      const float mo = __shfl_xor_sync(0xffffffffu, m, o), lo = __shfl_xor_sync(0xffffffffu, l, o);
      const float mn = fmaxf(m, mo), a = rescale(m, mn), b = rescale(mo, mn);
      l = l * a + lo * b;
#pragma unroll
      for (int i = 0; i < CW; ++i) acc[i] = acc[i] * a + __shfl_xor_sync(0xffffffffu, acc[i], o) * b;
      m = mn;
    }
  }
  if (mine && grp == 0) {
    const float inv = 1.f / l;
#pragma unroll
    for (int i = 0; i < CW; ++i) acc[i] *= inv;
    store_chunk<T, VEC, CW>(ctx + (size_t)row * d + hoff, acc, ne);
  }
}

// ---------------------------------------------------------------------------
// (d) decoder_cross_attention (_decoder_kernel's cross-attention,
// fused_decoder.py:425-453) over the per-item encoder K/V kv_cross[layer]
// (Lenc, B, 2d): row r reads item r / beam — an index, replacing the TPU's
// one-hot beam-expansion matmul. Scale 1/sqrt(dh), float32 softmax and
// context, context cast to the input dtype.
// Bound: bytes — q, the layer's cross K/V (Lenc·B·2d elements: 2 MB at Lenc
// 16, bf16) and the context, each once: ~0.94 us at the flagship shapes; its
// operations, 4·BK·d·Lenc, are far below the ridge.
// Design: two kernels, as the launcher picks. bf16 with a head width of 16,
// 32, 64 or 128 and 16-byte aligned pointers (the main path) runs on the
// tensor cores, below (cross_attention_mma_kernel); head widths above 128 run
// the wide kernel (cross_attention_wide_kernel). Anything else (float32,
// other widths up to 128, misaligned inputs) runs on the CUDA cores here: the beams of
// an item share its K/V, so a block is one (head, item) and up to CA_ROWS of
// the item's rows, one warp each (grid: heads × items × row groups; the
// heads of an item side by side). It stages CA_TILE encoder positions of the
// head's K and V in shared memory at a time, as float32 (rows padded to
// ca_stride floats, so float4 reads of one column group across 8
// consecutive positions hit 32 banks), with the rows' scaled q. A row's warp
// computes its logits, one position a lane (float4 reads, four partial
// sums), and carries the row's online-softmax max and sum in registers from
// tile to tile, so shared memory depends on dh alone; each thread then owns
// one float4 group of one row's context and accumulates it over the tile.
// ---------------------------------------------------------------------------
constexpr int CA_ROWS = 8;                 // rows of one item a block, one warp each
constexpr int CA_TILE = 32;                // encoder positions a tile: one a lane
constexpr int CA_THREADS = 32 * CA_ROWS;   // >= CA_ROWS · 128/4 float4 groups of context

// K/V/q rows in shared memory: dh rounded up to 4 floats, + 4
__host__ __device__ constexpr int ca_stride(int dh) { return (dh + 3) / 4 * 4 + 4; }
__host__ __device__ constexpr int ca_smem_floats(int dh) {
  return (2 * CA_TILE + CA_ROWS) * ca_stride(dh) + CA_ROWS * (CA_TILE + 1) + CA_ROWS;
}

__device__ __forceinline__ float4 lds4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// The chunk's CW values (zeros past the row's end) times mul as float4s at dst.
template <typename T, bool VEC>
__device__ __forceinline__ void stage_chunk(float* dst, const Chunk<T, VEC>& c, float mul = 1.f) {
#pragma unroll
  for (int k = 0; k < Chunk<T, VEC>::CW; k += 4)
    *reinterpret_cast<float4*>(dst + k) =
        make_float4(c[k] * mul, c[k + 1] * mul, c[k + 2] * mul, c[k + 3] * mul);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(CA_THREADS) cross_attention_kernel(
    const T* __restrict__ q2, const T* __restrict__ kv_layer, T* __restrict__ ctx,
    int B, int Lenc, int d, int H, int beam, float scale) {
  if (kTrivial) return;
  using C = Chunk<T, VEC>;
  constexpr int CW = C::CW;
  extern __shared__ __align__(16) float ca_smem[];
  const int h = blockIdx.x, item = blockIdx.y, r0 = blockIdx.z * CA_ROWS;
  const int nr = min(CA_ROWS, beam - r0), tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int dh = d / H, ks = ca_stride(dh), nch = (dh + CW - 1) / CW, nq = (dh + 3) / 4;
  float* sk = ca_smem;                    // [CA_TILE][ks]
  float* sv = sk + CA_TILE * ks;          // [CA_TILE][ks]
  float* sq = sv + CA_TILE * ks;          // [CA_ROWS][ks], scaled
  float* sp = sq + CA_ROWS * ks;          // [CA_ROWS][CA_TILE + 1], this tile's exp(s - m)
  float* sa = sp + CA_ROWS * (CA_TILE + 1);  // [CA_ROWS], this tile's rescale; at the end 1/l
  const size_t row0 = (size_t)item * beam + r0, hoff = (size_t)h * dh;

  for (int i = tid; i < nr * nch; i += CA_THREADS) {
    const int b = i / nch, e0 = (i % nch) * CW;
    C qc;
    qc.load(q2 + (row0 + b) * d + hoff + e0, dh - e0);
    stage_chunk(sq + b * ks + e0, qc, scale);
  }
  const bool row_live = warp < nr;
  float m = -INFINITY, l = 0.f;          // this warp's row
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const int cb = tid / nq, ce = (tid % nq) * 4;  // this thread's context group
  for (int p0 = 0; p0 < Lenc; p0 += CA_TILE) {
    const int np = min(CA_TILE, Lenc - p0);
    for (int i = tid; i < 2 * np * nch; i += CA_THREADS) {
      const int v = i >= np * nch, k = i - v * np * nch, p = k / nch, e0 = (k % nch) * CW;
      C c;
      c.load(kv_layer + ((size_t)(p0 + p) * B + item) * 2 * d + v * d + hoff + e0, dh - e0);
      stage_chunk((v ? sv : sk) + p * ks + e0, c);
    }
    __syncthreads();
    if (row_live) {
      float s = -INFINITY;
      if (lane < np) {
        const float* qr = sq + warp * ks;
        const float* kr = sk + lane * ks;
        float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll 4
        for (int e = 0; e < nq * 4; e += 4) {
          const float4 a = lds4(qr + e), b = lds4(kr + e);
          s0 = fmaf(a.x, b.x, s0);
          s1 = fmaf(a.y, b.y, s1);
          s2 = fmaf(a.z, b.z, s2);
          s3 = fmaf(a.w, b.w, s3);
        }
        s = (s0 + s1) + (s2 + s3);
      }
      const float mn = fmaxf(m, warp_max(s));
      const float e = lane < np ? expf(s - mn) : 0.f;
      const float a = rescale(m, mn);
      l = l * a + warp_sum(e);
      m = mn;
      sp[warp * (CA_TILE + 1) + lane] = e;
      if (lane == 0) sa[warp] = a;
    }
    __syncthreads();
    if (cb < nr) {
      const float a = sa[cb];
      float4 x = make_float4(acc.x * a, acc.y * a, acc.z * a, acc.w * a);
      const float* pr = sp + cb * (CA_TILE + 1);
#pragma unroll 4
      for (int p = 0; p < np; ++p) {
        const float wgt = pr[p];
        const float4 vv = lds4(sv + p * ks + ce);
        x.x = fmaf(wgt, vv.x, x.x);
        x.y = fmaf(wgt, vv.y, x.y);
        x.z = fmaf(wgt, vv.z, x.z);
        x.w = fmaf(wgt, vv.w, x.w);
      }
      acc = x;
    }
    __syncthreads();
  }
  if (row_live && lane == 0) sa[warp] = 1.f / l;
  __syncthreads();
  if (cb < nr) {
    const float inv = sa[cb];
    const float4 o = make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
    T* out = ctx + (row0 + cb) * d + hoff + ce;
    if (VEC) {
      store4(out, o);
    } else {  // dh need not be a multiple of 4 here
      out[0] = from_f<T>(o.x);
      if (ce + 1 < dh) out[1] = from_f<T>(o.y);
      if (ce + 2 < dh) out[2] = from_f<T>(o.z);
      if (ce + 3 < dh) out[3] = from_f<T>(o.w);
    }
  }
}

// --- (d) on the tensor cores: bf16, head width 16, 32, 64 or 128 -----------
// One warp is one (head, item) and up to CM_ROWS of the item's rows: one
// m16 tile of q (rows past the item's beams are zero). It stages CM_TILE
// encoder positions of the head's K and V and the tile's q in shared memory
// with cp.async (rows padded by 16 bytes, so ldmatrix's eight row reads hit
// 32 banks; positions past Lenc are zero-filled), then for every 16
// positions: S = q·Kᵀ by mma.sync m16n8k16 (K rows are B's columns as they
// lie), the online-softmax update on S's fragments (a row's 16 values sit in
// the 4 lanes of a quad), and O += P·V with P from S's fragments in
// registers and V through ldmatrix.trans. P enters the product as two bf16
// terms, P = hi + lo (hi = bf16(P), lo = bf16(P - hi)), so the weights keep
// about 16 bits as in the float32 softmax of the plain version.
constexpr int CM_ROWS = 16;   // rows of one item a warp: one m16 tile
constexpr int CM_TILE = 64;   // encoder positions staged at a time

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
// c += a·b, m16n8k16, bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// 16 bytes from src to shared dst, or 16 zero bytes where !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
}

template <int DH>
__global__ void __launch_bounds__(32) cross_attention_mma_kernel(
    const bf16* __restrict__ q2, const bf16* __restrict__ kv_layer, bf16* __restrict__ ctx,
    int B, int Lenc, int d, int beam, float scale) {
  if (kTrivial) return;
  constexpr int LD = DH + 8, KS = DH / 16, NT = DH / 8, CH = DH / 8;  // CH: 16-byte chunks a row
  __shared__ __align__(128) bf16 sq[CM_ROWS][LD], sk[CM_TILE][LD], sv[CM_TILE][LD];
  const int h = blockIdx.x, item = blockIdx.y, r0 = blockIdx.z * CM_ROWS;
  const int nr = min(CM_ROWS, beam - r0), lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  const size_t row0 = (size_t)item * beam + r0, hoff = (size_t)h * DH;

  for (int i = lane; i < CM_ROWS * CH; i += 32) {
    const int r = i / CH, c = i % CH;
    cp_async16(&sq[r][c * 8], q2 + (row0 + min(r, nr - 1)) * d + hoff + c * 8, r < nr);
  }
  float o[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g and g + 8
  uint32_t qa[KS][4];
  for (int p0 = 0; p0 < Lenc; p0 += CM_TILE) {
    const int np = min(CM_TILE, Lenc - p0), ns = (np + 15) / 16;  // 16-position steps
    __syncwarp();
    for (int i = lane; i < ns * 16 * CH; i += 32) {
      const int p = i / CH, c = i % CH;
      const bf16* src = kv_layer + ((size_t)(p0 + min(p, np - 1)) * B + item) * 2 * d + hoff + c * 8;
      cp_async16(&sk[p][c * 8], src, p < np);
      cp_async16(&sv[p][c * 8], src + d, p < np);
    }
    cp_async_wait_all();
    __syncwarp();
    if (p0 == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) ldsm_x4(qa[kk], &sq[lane & 15][kk * 16 + 8 * (lane >> 4)]);
    }
    for (int st = 0; st < ns; ++st) {
      const int n0 = st * 16;
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};  // positions n0 + 8·half
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t b[4];
        ldsm_x4(b, &sk[n0 + (lane & 7) + 8 * (lane >> 4)][kk * 16 + 8 * ((lane >> 3) & 1)]);
        mma_bf16(s[0], qa[kk], b[0], b[1]);
        mma_bf16(s[1], qa[kk], b[2], b[3]);
      }
      // s[half][0..1]: row g, positions n0 + 8·half + 2t + {0, 1}; [2..3]: row g + 8
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const bool ok = n0 + 8 * hf + 2 * t + (k & 1) < np;
          s[hf][k] = ok ? s[hf][k] * scale : -INFINITY;
          mx[k >> 1] = fmaxf(mx[k >> 1], s[hf][k]);
        }
      float a[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
        a[rr] = rescale(m[rr], mx[rr]);
        m[rr] = mx[rr];
      }
      uint32_t ph[4], pl[4];  // P as the A fragment of positions n0..n0 + 15, hi and lo
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const float e0 = expf(s[hf][2 * rr] - m[rr]), e1 = expf(s[hf][2 * rr + 1] - m[rr]);
          sum[rr] += e0 + e1;
          const __nv_bfloat162 hi = __floats2bfloat162_rn(e0, e1);
          const float2 hf2 = __bfloat1622float2(hi);
          const __nv_bfloat162 lo = __floats2bfloat162_rn(e0 - hf2.x, e1 - hf2.y);
          ph[2 * hf + rr] = *reinterpret_cast<const uint32_t*>(&hi);
          pl[2 * hf + rr] = *reinterpret_cast<const uint32_t*>(&lo);
        }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        sum[rr] += __shfl_xor_sync(0xffffffffu, sum[rr], 1);
        sum[rr] += __shfl_xor_sync(0xffffffffu, sum[rr], 2);
        l[rr] = l[rr] * a[rr] + sum[rr];
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        o[j][0] *= a[0];
        o[j][1] *= a[0];
        o[j][2] *= a[1];
        o[j][3] *= a[1];
      }
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t b[4];
        ldsm_x4_trans(b, &sv[n0 + (lane & 7) + 8 * ((lane >> 3) & 1)][8 * j + 8 * (lane >> 4)]);
        mma_bf16(o[j], ph, b[0], b[1]);
        mma_bf16(o[j], pl, b[0], b[1]);
        mma_bf16(o[j + 1], ph, b[2], b[3]);
        mma_bf16(o[j + 1], pl, b[2], b[3]);
      }
    }
  }
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = g + 8 * rr;
    if (r < nr) {
      bf16* out = ctx + (row0 + r) * d + hoff + 2 * t;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        store_pair(out + 8 * j, o[j][2 * rr] * inv[rr], o[j][2 * rr + 1] * inv[rr]);
    }
  }
}

// --- (c) and (d) for head rows wider than their fast kernels reach ---------
// Any head width, dtype and alignment: self-attention where a head row is
// more than 32 chunks (bf16 above 256 values on 16-byte chunks; float32, or
// a misaligned input, above 128), cross-attention above 128 values. The
// grids and row groups are the fast kernels'; one warp is one row, and its
// lanes stride over the row's chunks, so no register array grows with the
// width. Positions go in stages of WA_STAGE: the warp computes the stage's
// logits (each lane's partial dot products, one warp sum a position) into
// shared memory, takes the stage's max and rescale once, and then each lane
// adds the stage's weighted V rows into its chunks of the context. Between
// stages the context waits in a float32 scratch row (the wrapper's buffer,
// read and written by the lane that owns the chunk, so it stays in L1/L2).
// Bound: the same bytes as the fast kernels; q is read again for every
// position from L1.
constexpr int WA_ROWS = 8;    // rows a block, one warp each
constexpr int WA_STAGE = 64;  // positions a stage

// One stage of one row: n positions whose K and V rows kv(j, false) and
// kv(j, true) give, folded into (m, l) and the context (acc between stages,
// out after the last). sw holds this warp's WA_STAGE logits.
template <typename T, bool VEC, typename KV>
__device__ __forceinline__ void wide_stage(const T* q, float* acc, T* out, int dh, int n,
                                           bool first, bool last, float scale, float* sw,
                                           float& m, float& l, KV kv) {
  using C = Chunk<T, VEC>;
  constexpr int CW = C::CW;
  const int lane = threadIdx.x & 31, nch = (dh + CW - 1) / CW;
  float mb = m;
  for (int j = 0; j < n; ++j) {
    const T* kp = kv(j, false);
    float s = 0.f;
    for (int c = lane; c < nch; c += 32) {
      const int e0 = c * CW;
      C qc, kc;
      qc.load(q + e0, dh - e0);
      kc.load(kp + e0, dh - e0);
#pragma unroll
      for (int i = 0; i < CW; ++i) s = fmaf(qc[i], kc[i], s);
    }
    s = warp_sum(s) * scale;
    if (lane == 0) sw[j] = s;
    mb = fmaxf(mb, s);
  }
  __syncwarp();
  const float a = rescale(m, mb);
  float part = 0.f;
  for (int j = lane; j < n; j += 32) {
    const float e = expf(sw[j] - mb);
    sw[j] = e;
    part += e;
  }
  l = l * a + warp_sum(part);
  m = mb;
  __syncwarp();
  const float inv = 1.f / l;  // the last stage's
  for (int c = lane; c < nch; c += 32) {
    const int e0 = c * CW, ne = min(CW, dh - e0);
    float o[CW];
#pragma unroll
    for (int i = 0; i < CW; ++i) o[i] = first || i >= ne ? 0.f : acc[e0 + i] * a;
    for (int j = 0; j < n; ++j) {
      C vc;
      vc.load(kv(j, true) + e0, ne);
      const float e = sw[j];
#pragma unroll
      for (int i = 0; i < CW; ++i) o[i] = fmaf(e, vc[i], o[i]);
    }
    if (last) {
#pragma unroll
      for (int i = 0; i < CW; ++i) o[i] *= inv;
      store_chunk<T, VEC, CW>(out + e0, o, ne);
    } else {
#pragma unroll
      for (int i = 0; i < CW; ++i)
        if (i < ne) acc[e0 + i] = o[i];
    }
  }
  __syncwarp();  // the next stage rewrites sw
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(32 * WA_ROWS) self_attention_wide_kernel(
    const T* __restrict__ qkv, T* __restrict__ k_layer, T* __restrict__ v_layer,
    const int* __restrict__ src_t, T* __restrict__ ctx, float* __restrict__ acc, int BK, int d,
    int H, int beam, int pos, float scale) {
  if (kTrivial) return;
  constexpr int CW = Chunk<T, VEC>::CW;
  __shared__ int phys[WA_STAGE][WA_ROWS];
  __shared__ float sw[WA_ROWS][WA_STAGE];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.y * WA_ROWS, row = row0 + w, h = blockIdx.x;
  const int dh = d / H, nch = (dh + CW - 1) / CW;
  const bool live = row < BK;  // warp-uniform
  const size_t hoff = (size_t)h * dh, roff = (size_t)row * d + hoff;
  const T* q = qkv + (size_t)row * 3 * d + hoff;  // k_t at + d, v_t at + 2d
  if (live) {
    const size_t slot = ((size_t)pos * BK + row) * d + hoff;
    for (int c = lane; c < nch; c += 32) {
      const int e0 = c * CW;
      copy_chunk<T, VEC, CW>(k_layer + slot + e0, q + d + e0, dh - e0);
      copy_chunk<T, VEC, CW>(v_layer + slot + e0, q + 2 * d + e0, dh - e0);
    }
  }
  float m = -INFINITY, l = 0.f;
  for (int s0 = 0; s0 <= pos; s0 += WA_STAGE) {
    const int n = min(WA_STAGE, pos + 1 - s0);  // pos itself last
    __syncthreads();
    for (int i = threadIdx.x; i < n * WA_ROWS; i += blockDim.x) {
      const int p = s0 + i / WA_ROWS, r = row0 + i % WA_ROWS;
      phys[i / WA_ROWS][i % WA_ROWS] =
          p < pos && r < BK ? (r / beam) * beam + src_t[(size_t)p * BK + r] : r;
    }
    __syncthreads();
    if (!live) continue;
    wide_stage<T, VEC>(q, acc + roff, ctx + roff, dh, n, s0 == 0, s0 + WA_STAGE > pos, scale,
                       sw[w], m, l, [&](int j, bool v) -> const T* {
                         const int p = s0 + j;
                         if (p == pos) return q + (v ? 2 : 1) * d;
                         return (v ? v_layer : k_layer) + ((size_t)p * BK + phys[j][w]) * d + hoff;
                       });
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(32 * WA_ROWS) cross_attention_wide_kernel(
    const T* __restrict__ q2, const T* __restrict__ kv_layer, T* __restrict__ ctx,
    float* __restrict__ acc, int B, int Lenc, int d, int H, int beam, float scale) {
  if (kTrivial) return;
  __shared__ float sw[WA_ROWS][WA_STAGE];
  const int w = threadIdx.x >> 5, h = blockIdx.x, item = blockIdx.y;
  const int r = blockIdx.z * WA_ROWS + w;
  if (r >= beam) return;  // nothing below syncs the block
  const int dh = d / H;
  const size_t hoff = (size_t)h * dh, roff = ((size_t)item * beam + r) * d + hoff;
  float m = -INFINITY, l = 0.f;
  for (int s0 = 0; s0 < Lenc; s0 += WA_STAGE) {
    wide_stage<T, VEC>(q2 + roff, acc + roff, ctx + roff, dh, min(WA_STAGE, Lenc - s0), s0 == 0,
                       s0 + WA_STAGE >= Lenc, scale, sw[w], m, l,
                       [&](int j, bool v) -> const T* {
                         return kv_layer + ((size_t)(s0 + j) * B + item) * 2 * d + v * d + hoff;
                       });
  }
}

// ---------------------------------------------------------------------------
// (e) decoder_logsoftmax_topk (_decoder_kernel's final cell,
// fused_decoder.py:497-526): max and logsumexp over V; the beam freeze
// lp = fin*pad_row + (1-fin)*lp with pad_row = 0 at column 0 and -1e9
// elsewhere (so a finished row carries its score on the pad token); + the
// row's running score; then the top `topk` (score, id) pairs in descending
// order, ties to the LOWEST id.
// Bound: bytes — reads BK·V float32 logits once (4.1 MB at V 2000, ~1.2 us).
// Design: one block of TK_WARPS warps a row, so a row's serial work is short
// and an SM holds enough warps to hide its latencies. Where V is a multiple
// of 4 up to 512·TK_HOLD and the logits start on 16 bytes (the main path's
// V 2000), each thread reads its values once into registers (TK_HOLD
// float4); otherwise it streams them, keeps its best TK_NV in a sorted list,
// and the later reads come from L1/L2. The max, then the sum of exponentials,
// are shuffle reductions and one exchange across the warps in shared memory.
// Then a threshold instead of a merge of every thread's values: each warp
// sorts its threads' best totals (a bitonic network over the lanes), two
// bitonic merges of the warps' best 8 give T, the topk-th best thread's
// best, which at least topk values reach. Only values at or above T (at most
// topk·TK_NV, a handful on random logits) go to shared memory, and one warp
// writes each at its rank, a count over the few of them (or, past 32, takes
// topk rounds). Totals are the plain version's float expression, and every
// comparison is (total desc, id asc): values that the subtraction of lse
// rounds to one total tie there and go to the lowest id, as in the
// reference (a pre-selection on raw logits would not). topk above 8 runs one warp a row, topk rounds over the row,
// each taking the best total strictly after the previous round's winner in
// that order.
// ---------------------------------------------------------------------------
constexpr int TK_WARPS = 4;   // warps a row (the threshold kernel's block)
constexpr int TK_HOLD = 4;    // float4 a thread holds: V <= 2048 in registers
constexpr int TK_NV = 4 * TK_HOLD;  // values (or listed best values) a thread keeps
constexpr int TK_TOP = 8;     // the threshold kernel's topk at most
constexpr int TK_MAXC = TK_TOP * TK_NV;  // candidates at most: topk threads' values
constexpr int TK_ROWS = 4;    // rows a block of the rounds kernel, one warp each

__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    arg_better(v, i, __shfl_xor_sync(0xffffffffu, v, o), __shfl_xor_sync(0xffffffffu, i, o));
}

__device__ __forceinline__ float tk_total(float lg, int id, float lse, float f, float sc) {
  const float pad = id == 0 ? 0.f : -1e9f;
  return f * pad + (1.f - f) * (lg - lse) + sc;
}

// (v, i) into a lane's list, sorted best first, if it beats the last entry
template <int LK>
__device__ __forceinline__ void tk_insert(float (&lv)[LK], int (&li)[LK], float v, int i) {
  if (!tk_better(v, i, lv[LK - 1], li[LK - 1])) return;
#pragma unroll
  for (int j = 0; j < LK; ++j) {
    if (tk_better(v, i, lv[j], li[j])) {
      const float tv = lv[j];
      const int ti = li[j];
      lv[j] = v;
      li[j] = i;
      v = tv;
      i = ti;
    }
  }
}

// The warp's pairs, one a lane, sorted best first (lane j holds the j-th):
// a bitonic network over the lanes.
__device__ __forceinline__ void tk_warp_sort(float& v, int& i) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1)
#pragma unroll
    for (int j = k / 2; j > 0; j >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, j);
      const int oi = __shfl_xor_sync(0xffffffffu, i, j);
      // in a descending run the lower lane of the pair keeps the better
      if (tk_better(ov, oi, v, i) == (((lane & j) == 0) == ((lane & k) == 0))) {
        v = ov;
        i = oi;
      }
    }
}

// Lanes in groups of 8, each group a sorted list (best first): every group
// becomes the best 8 of its list and the list d lanes away (d 8 or 16), sorted.
// The pairwise better of one list and the other reversed is the best 8 as a
// bitonic sequence, which three exchange stages sort.
__device__ __forceinline__ void tk_group_merge(float& v, int& i, int d) {
  const int lane = threadIdx.x & 31;
  const float ov = __shfl_xor_sync(0xffffffffu, v, d | 7);
  const int oi = __shfl_xor_sync(0xffffffffu, i, d | 7);
  if (tk_better(ov, oi, v, i)) {
    v = ov;
    i = oi;
  }
#pragma unroll
  for (int j = 4; j > 0; j >>= 1) {
    const float pv = __shfl_xor_sync(0xffffffffu, v, j);
    const int pi = __shfl_xor_sync(0xffffffffu, i, j);
    if (tk_better(pv, pi, v, i) == ((lane & j) == 0)) {
      v = pv;
      i = pi;
    }
  }
}

// How many of the n pairs (sv[e], si[e]) come before (v, i): its place in
// the (total desc, id asc) order when (v, i) is one of them.
__device__ __forceinline__ int tk_rank(float v, int i, const float* sv, const int* si, int n) {
  int r = 0;
  for (int e = 0; e < n; ++e) r += tk_better(sv[e], si[e], v, i);
  return r;
}

// The best topk of the n pairs pair(e, v, i) gives, in topk rounds of the
// warp: each round takes the best pair strictly after the previous round's
// winner in the (total desc, id asc) order; lane 0 writes them.
template <typename Pair>
__device__ __forceinline__ void tk_rounds(Pair pair, int n, int topk, float* out_s, int* out_i) {
  const int lane = threadIdx.x & 31;
  float pv = INFINITY;
  int pi = -1;
  for (int j = 0; j < topk; ++j) {
    float bv = -INFINITY;
    int bi = 0x7fffffff;
    for (int e = lane; e < n; e += 32) {
      float v;
      int i;
      pair(e, v, i);
      if (tk_better(pv, pi, v, i)) arg_better(bv, bi, v, i);
    }
    warp_best(bv, bi);
    if (lane == 0) {
      out_s[j] = bv;
      out_i[j] = bi;
    }
    pv = bv;
    pi = bi;
  }
}

template <int LK>
__device__ __forceinline__ void tk_init(float (&lv)[LK], int (&li)[LK]) {
#pragma unroll
  for (int k = 0; k < LK; ++k) {
    lv[k] = -INFINITY;
    li[k] = 0x7fffffff;
  }
}

// topk <= TK_TOP: one block a row. HOLD: V % 4 == 0, V <= 512·TK_HOLD,
// logits 16-byte aligned, the row in registers; else streamed.
template <bool HOLD>
__global__ void __launch_bounds__(32 * TK_WARPS) logsoftmax_topk_kernel(
    const float* __restrict__ logits, const float* __restrict__ scores,
    const float* __restrict__ fin, float* __restrict__ out_s, int* __restrict__ out_i, int V,
    int topk) {
  __shared__ float sm[TK_WARPS], ss[TK_WARPS], wv[TK_WARPS][TK_TOP], cv[TK_MAXC];
  __shared__ int wi[TK_WARPS][TK_TOP], ci[TK_MAXC], ncand;
  const int row = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (kTrivial) {
    for (int j = tid; j < topk; j += blockDim.x) out_s[(size_t)row * topk + j] = scores[row];
    return;
  }
  constexpr int NT = 32 * TK_WARPS;
  const float* lg = logits + (size_t)row * V;
  if (tid == 0) ncand = 0;
  // max, then the sum of exp(v - max): warp shuffles, then across the warps
  float4 x[HOLD ? TK_HOLD : 1];
  float m = -INFINITY, s = 0.f;
  if (HOLD) {
#pragma unroll
    for (int k = 0; k < TK_HOLD; ++k) {
      const int c = k * NT + tid;
      x[k] = c < V / 4 ? __ldg(reinterpret_cast<const float4*>(lg) + c)
                       : make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
      m = fmaxf(m, fmaxf(fmaxf(x[k].x, x[k].y), fmaxf(x[k].z, x[k].w)));
    }
  } else {
    for (int c = tid; c < V; c += NT) m = fmaxf(m, lg[c]);
  }
  m = warp_max(m);
  if (lane == 0) sm[warp] = m;
  __syncthreads();
  m = sm[0];
#pragma unroll
  for (int w = 1; w < TK_WARPS; ++w) m = fmaxf(m, sm[w]);
  if (HOLD) {
#pragma unroll
    for (int k = 0; k < TK_HOLD; ++k)
      if (k * NT + tid < V / 4)
        s += (expf(x[k].x - m) + expf(x[k].y - m)) + (expf(x[k].z - m) + expf(x[k].w - m));
  } else {
    for (int c = tid; c < V; c += NT) s += expf(lg[c] - m);
  }
  s = warp_sum(s);
  if (lane == 0) ss[warp] = s;
  __syncthreads();
  s = ss[0];
#pragma unroll
  for (int w = 1; w < TK_WARPS; ++w) s += ss[w];
  const float lse = m + logf(s), f = fin[row], sc = scores[row];

  // this thread's totals (HOLD: its values; else its best TK_NV) and its best
  float tv[TK_NV];
  int ti[TK_NV];
  tk_init(tv, ti);
  if (HOLD) {
#pragma unroll
    for (int k = 0; k < TK_HOLD; ++k) {
      const int c = k * NT + tid;
      if (c < V / 4) {
        const float e[4] = {x[k].x, x[k].y, x[k].z, x[k].w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          tv[4 * k + u] = tk_total(e[u], 4 * c + u, lse, f, sc);
          ti[4 * k + u] = 4 * c + u;
        }
      }
    }
  } else {
    for (int c = tid; c < V; c += NT) tk_insert(tv, ti, tk_total(lg[c], c, lse, f, sc), c);
  }
  float bv;  // this thread's best, by a tree over its values
  int bi;
  {
    float rv[TK_NV];
    int ri[TK_NV];
#pragma unroll
    for (int k = 0; k < TK_NV; ++k) {
      rv[k] = tv[k];
      ri[k] = ti[k];
    }
    static_assert(TK_NV == 16, "a tree of four levels");
#pragma unroll
    for (int k = 0; k < 8; ++k) arg_better(rv[k], ri[k], rv[k + 8], ri[k + 8]);
#pragma unroll
    for (int k = 0; k < 4; ++k) arg_better(rv[k], ri[k], rv[k + 4], ri[k + 4]);
    arg_better(rv[0], ri[0], rv[2], ri[2]);
    arg_better(rv[1], ri[1], rv[3], ri[3]);
    arg_better(rv[0], ri[0], rv[1], ri[1]);
    bv = rv[0];
    bi = ri[0];
  }

  // T: the topk-th best of the threads' best totals; at least topk values reach it
  tk_warp_sort(bv, bi);
  if (lane < TK_TOP) {  // the warp's best 8, sorted; past topk they do not count
    wv[warp][lane] = lane < topk ? bv : -INFINITY;
    wi[warp][lane] = lane < topk ? bi : 0x7fffffff;
  }
  __syncthreads();
  static_assert(TK_WARPS * TK_TOP == 32, "the warps' lists fill one warp");
  bv = wv[lane / TK_TOP][lane % TK_TOP];
  bi = wi[lane / TK_TOP][lane % TK_TOP];
  tk_group_merge(bv, bi, 8);
  tk_group_merge(bv, bi, 16);
  const float tt = __shfl_sync(0xffffffffu, bv, topk - 1);
  const int tid_t = __shfl_sync(0xffffffffu, bi, topk - 1);
#pragma unroll
  for (int k = 0; k < TK_NV; ++k) {
    if (ti[k] != 0x7fffffff && !tk_better(tt, tid_t, tv[k], ti[k])) {
      const int slot = atomicAdd(&ncand, 1);
      if (slot < TK_MAXC) {
        cv[slot] = tv[k];
        ci[slot] = ti[k];
      }
    }
  }
  __syncthreads();
  if (warp == 0) {
    const int n = min(ncand, TK_MAXC);
    float* os = out_s + (size_t)row * topk;
    int* oi = out_i + (size_t)row * topk;
    if (n <= 32) {  // the usual case: one candidate a lane, written at its rank
      if (lane < n) {
        const int rank = tk_rank(cv[lane], ci[lane], cv, ci, n);
        if (rank < topk) {
          os[rank] = cv[lane];
          oi[rank] = ci[lane];
        }
      }
    } else {  // many ties at T
      tk_rounds([&](int e, float& v, int& i) { v = cv[e]; i = ci[e]; }, n, topk, os, oi);
    }
  }
}

// The row's max and log-sum-exp, streamed (every lane gets them).
__device__ __forceinline__ float tk_lse(const float* lg, int V) {
  const int lane = threadIdx.x & 31;
  float m = -INFINITY;
  for (int c = lane; c < V; c += 32) m = fmaxf(m, lg[c]);
  m = warp_max(m);
  float s = 0.f;
  for (int c = lane; c < V; c += 32) s += expf(lg[c] - m);
  return m + logf(warp_sum(s));
}

// topk > TK_TOP: one warp a row, topk rounds over the row.
__global__ void __launch_bounds__(32 * TK_ROWS) logsoftmax_topk_rounds_kernel(
    const float* __restrict__ logits, const float* __restrict__ scores,
    const float* __restrict__ fin, float* __restrict__ out_s, int* __restrict__ out_i, int BK,
    int V, int topk) {
  const int row = blockIdx.x * TK_ROWS + (threadIdx.x >> 5);
  if (row >= BK) return;
  if (kTrivial) {
    for (int j = threadIdx.x & 31; j < topk; j += 32) out_s[(size_t)row * topk + j] = scores[row];
    return;
  }
  const float* lg = logits + (size_t)row * V;
  const float lse = tk_lse(lg, V), f = fin[row], sc = scores[row];
  tk_rounds([&](int c, float& v, int& i) { v = tk_total(lg[c], c, lse, f, sc); i = c; }, V, topk,
            out_s + (size_t)row * topk, out_i + (size_t)row * topk);
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

// Both attention kernels take the 16-byte chunk path where a head row is a
// whole number of 16-byte chunks and every pointer starts on a 16-byte
// boundary, and the 4-value path otherwise. Head rows wider than the fast
// kernels reach run the wide kernels, which keep the context in scratch
// (BK, d) float32 between stages: the wrapper passes it for any head width
// above 128, and a wide launch without it is refused.
int fd_self_attention(const void* qkv, void* k_layer, void* v_layer, const int* src_t,
                      void* ctx, float* scratch, int BK, int d, int H, int beam, int pos,
                      float scale, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(H, (BK + SA_ROWS - 1) / SA_ROWS), block(32 * SA_ROWS);
  const int esz = dtype == 0 ? 4 : 2, dh = d / H;
  const bool vec = (dh * esz) % 16 == 0 &&
                   ((uintptr_t)qkv | (uintptr_t)k_layer | (uintptr_t)v_layer | (uintptr_t)ctx) % 16 == 0;
  const int cw = vec ? 16 / esz : 4;
  if ((dh + cw - 1) / cw > 32) {  // more chunks than lanes: the wide kernel
    if (!scratch) return (int)cudaErrorInvalidValue;
#define FD_SW(T, V)                                                                            \
  self_attention_wide_kernel<T, V><<<dim3(H, (BK + WA_ROWS - 1) / WA_ROWS), 32 * WA_ROWS, 0,    \
                                     s>>>((const T*)qkv, (T*)k_layer, (T*)v_layer, src_t,       \
                                          (T*)ctx, scratch, BK, d, H, beam, pos, scale)
    if (dtype == 0) {
      if (vec) FD_SW(float, true); else FD_SW(float, false);
    } else {
      if (vec) FD_SW(bf16, true); else FD_SW(bf16, false);
    }
#undef FD_SW
    return last_error();
  }
#define FD_SA(T, V)                                                                            \
  self_attention_kernel<T, V><<<grid, block, 0, s>>>((const T*)qkv, (T*)k_layer, (T*)v_layer,   \
                                                     src_t, (T*)ctx, BK, d, H, beam, pos, scale)
  if (dtype == 0) {
    if (vec) FD_SA(float, true); else FD_SA(float, false);
  } else {
    if (vec) FD_SA(bf16, true); else FD_SA(bf16, false);
  }
#undef FD_SA
  return last_error();
}

int fd_cross_attention(const void* q, const void* kv_layer, void* ctx, float* scratch, int B,
                       int Lenc, int d, int H, int beam, float scale, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int dh = d / H;
  const bool aligned = ((uintptr_t)q | (uintptr_t)kv_layer | (uintptr_t)ctx) % 16 == 0;
  const bool vec = (dh * (dtype == 0 ? 4 : 2)) % 16 == 0 && aligned;
  if (dtype == 1 && aligned && (dh == 16 || dh == 32 || dh == 64 || dh == 128)) {
    const dim3 grid(H, B, (beam + CM_ROWS - 1) / CM_ROWS);
#define FD_CM(DH)                                                                              \
  case DH:                                                                                     \
    cross_attention_mma_kernel<DH><<<grid, 32, 0, s>>>((const bf16*)q, (const bf16*)kv_layer,   \
                                                       (bf16*)ctx, B, Lenc, d, beam, scale);    \
    break;
    switch (dh) { FD_CM(16) FD_CM(32) FD_CM(64) FD_CM(128) }
#undef FD_CM
    return last_error();
  }
  if (dh > 128) {  // one float4 context group a thread no longer covers a row group
    if (!scratch) return (int)cudaErrorInvalidValue;
    const dim3 grid(H, B, (beam + WA_ROWS - 1) / WA_ROWS);
#define FD_CW(T, V)                                                                            \
  cross_attention_wide_kernel<T, V><<<grid, 32 * WA_ROWS, 0, s>>>(                              \
      (const T*)q, (const T*)kv_layer, (T*)ctx, scratch, B, Lenc, d, H, beam, scale)
    if (dtype == 0) {
      if (vec) FD_CW(float, true); else FD_CW(float, false);
    } else {
      if (vec) FD_CW(bf16, true); else FD_CW(bf16, false);
    }
#undef FD_CW
    return last_error();
  }
  const dim3 grid(H, B, (beam + CA_ROWS - 1) / CA_ROWS), block(CA_THREADS);
  const size_t smem = (size_t)ca_smem_floats(dh) * sizeof(float);  // <= 40 KB at dh 128
#define FD_CA(T, V)                                                                            \
  cross_attention_kernel<T, V><<<grid, block, smem, s>>>((const T*)q, (const T*)kv_layer,       \
                                                         (T*)ctx, B, Lenc, d, H, beam, scale)
  if (dtype == 0) {
    if (vec) FD_CA(float, true); else FD_CA(float, false);
  } else {
    if (vec) FD_CA(bf16, true); else FD_CA(bf16, false);
  }
#undef FD_CA
  return last_error();
}

// One block a row up to topk 8: the row held in registers where it fits
// (V % 4 == 0, V <= 512·TK_HOLD, 16-byte aligned), streamed otherwise;
// above, one warp a row in rounds.
int fd_logsoftmax_topk(const float* logits, const float* scores, const float* fin,
                       float* out_s, int* out_i, int BK, int V, int topk, void* stream) {
  if (topk < 1 || topk > V) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (topk > TK_TOP) {
    logsoftmax_topk_rounds_kernel<<<(BK + TK_ROWS - 1) / TK_ROWS, 32 * TK_ROWS, 0, s>>>(
        logits, scores, fin, out_s, out_i, BK, V, topk);
  } else if (V % 4 == 0 && V <= 4 * 32 * TK_WARPS * TK_HOLD && (uintptr_t)logits % 16 == 0) {
    logsoftmax_topk_kernel<true><<<BK, 32 * TK_WARPS, 0, s>>>(logits, scores, fin, out_s, out_i,
                                                              V, topk);
  } else {
    logsoftmax_topk_kernel<false><<<BK, 32 * TK_WARPS, 0, s>>>(logits, scores, fin, out_s,
                                                               out_i, V, topk);
  }
  return last_error();
}

}  // extern "C"
