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
// stream it is given, allocates nothing, and returns cudaGetLastError() so a
// refused launch raises in the wrapper. dtype codes: 0 float32, 1 bfloat16.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

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

// ---------------------------------------------------------------------------
// (a) decoder_linear: Y = act(X·W + b), X (M, K), W (K, N) row-major (in, out),
// b (N) float32, float32 accumulation; Y in the input dtype or float32.
// Replaces the products of _decoder_kernel at fused_decoder.py:237 (QKV),
// :409 (self out), :426 (cross q), :455 (cross out), :463 and :478 (FFN) and
// :500 (vocabulary projection).
// Bound: bytes, narrowly. At BK = 512 rows a product moves M·K + K·N + M·N
// elements for 2·M·K·N operations, ~220 FLOP per byte in bf16, under the
// card's ~295 FLOP/B ridge (QKV: 3.7 MB, 1.1 us, against 0.8 us of
// operations); at 64 rows (batch 8) the weights' bytes bound it outright.
// Design: two shared-memory tiled products, bias and activation fused in the
// epilogue. bf16 with K and N multiples of 8 (every shape of the decode
// step) runs on the tensor cores: linear_tc_kernel, a 64×64 output tile per
// 4-warp block, each warp 2×2 WMMA 16×16×16 bf16 fragments with float32
// accumulators, 32-deep K slices loaded as 16-byte vectors, the next slice
// prefetched into registers while the current one multiplies. float32 (and
// any other bf16 shape) runs linear_kernel on the CUDA cores in exact float32
// FMA: 64×64 tile per 256-thread block, 16-deep slices, 4×4 outputs a thread.
// Neither reaches the card's rate: wgmma/TMA and split-K for the few-block
// shapes (K = 2048 at 64 blocks) are later work.
// ---------------------------------------------------------------------------
constexpr int LBM = 64, LBN = 64, LBK = 16;
constexpr int TBM = 64, TBN = 64, TBK = 32, TPAD = 8;

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

template <typename TO>
__global__ void __launch_bounds__(128) linear_tc_kernel(
    const bf16* __restrict__ X, const bf16* __restrict__ W, const float* __restrict__ bias,
    TO* __restrict__ Y, int M, int N, int K, int act) {
  if (kTrivial) return;
  using namespace nvcuda;
  // row-major tiles, rows padded by 8 elements (16 B) against bank conflicts;
  // every fragment pointer below stays 32-byte aligned
  __shared__ __align__(128) bf16 As[TBM][TBK + TPAD];
  __shared__ __align__(128) bf16 Bs[TBK][TBN + TPAD];
  __shared__ __align__(128) float Cs[TBM][TBN + 4];
  const int tid = threadIdx.x, warp = tid >> 5, wm = warp >> 1, wn = warp & 1;
  const int m0 = blockIdx.y * TBM, n0 = blockIdx.x * TBN;

  // each thread moves 2 A vectors (64 rows × 4 vectors) and 2 B vectors
  // (32 rows × 8 vectors) of 8 bf16 per slice
  uint4 ra[2], rb[2];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = tid + 128 * i;
      const int r = e >> 2, c = (e & 3) * 8, gm = m0 + r, gk = k0 + c;
      ra[i] = (gm < M && gk < K) ? *reinterpret_cast<const uint4*>(X + (size_t)gm * K + gk)
                                 : make_uint4(0, 0, 0, 0);
      const int rr = e >> 3, cc = (e & 7) * 8, gk2 = k0 + rr, gn = n0 + cc;
      rb[i] = (gk2 < K && gn < N) ? *reinterpret_cast<const uint4*>(W + (size_t)gk2 * N + gn)
                                  : make_uint4(0, 0, 0, 0);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  fetch(0);
  for (int k0 = 0; k0 < K; k0 += TBK) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = tid + 128 * i;
      *reinterpret_cast<uint4*>(&As[e >> 2][(e & 3) * 8]) = ra[i];
      *reinterpret_cast<uint4*>(&Bs[e >> 3][(e & 7) * 8]) = rb[i];
    }
    __syncthreads();
    if (k0 + TBK < K) fetch(k0 + TBK);
#pragma unroll
    for (int kk = 0; kk < TBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], &As[wm * 32 + i * 16][kk], TBK + TPAD);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], &Bs[kk][wn * 32 + j * 16], TBN + TPAD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[wm * 32 + i * 16][wn * 32 + j * 16], acc[i][j], TBN + 4,
                              wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < TBM * TBN; e += 128) {
    const int r = e / TBN, c = e % TBN, gm = m0 + r, gn = n0 + c;
    if (gm < M && gn < N) Y[(size_t)gm * N + gn] = from_f<TO>(activate(Cs[r][c] + bias[gn], act));
  }
}

// ---------------------------------------------------------------------------
// (b) decoder_add_layernorm: out = LN(y + r) over d, float32 statistics,
// mean then mean of squared deviations, eps 1e-6, float32 scale/shift
// (_decoder_kernel's layer_norm, fused_decoder.py:226-230, at :410, :456,
// :479). y is float32 (a linear's output), r is the input dtype (the layer
// input) or float32 (the carried out1/out2, kept float32 as the TPU kernel
// keeps them). Writes the float32 result (when out_f is given) and its cast.
// Bound: bytes — at 512×512 it reads 1–2 MB and writes 1.5 MB, ~1 us.
// Design: one 128-thread block per row, the row staged once in shared memory,
// two block reductions.
// ---------------------------------------------------------------------------
template <typename T, typename R>
__global__ void __launch_bounds__(128) add_layernorm_kernel(
    const float* __restrict__ y, const R* __restrict__ r, const float* __restrict__ gamma,
    const float* __restrict__ beta, float* __restrict__ out_f, T* __restrict__ out_t,
    int d, float eps) {
  if (kTrivial) return;
  extern __shared__ float row[];
  const size_t off = (size_t)blockIdx.x * d;
  float s = 0.f;
  for (int e = threadIdx.x; e < d; e += blockDim.x) {
    const float v = y[off + e] + to_f(r[off + e]);
    row[e] = v;
    s += v;
  }
  const float mu = block_sum(s) / d;
  float q = 0.f;
  for (int e = threadIdx.x; e < d; e += blockDim.x) {
    const float c = row[e] - mu;
    q += c * c;
  }
  const float rstd = rsqrtf(block_sum(q) / d + eps);
  for (int e = threadIdx.x; e < d; e += blockDim.x) {
    const float o = (row[e] - mu) * rstd * gamma[e] + beta[e];
    if (out_f) out_f[off + e] = o;
    out_t[off + e] = from_f<T>(o);
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

}  // namespace

extern "C" {

const char* fd_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int fd_linear(const void* x, const void* w, const float* b, void* y, int M, int N, int K,
              int dtype, int out_f32, int act, void* stream) {
  const dim3 grid((N + LBN - 1) / LBN, (M + LBM - 1) / LBM);
  cudaStream_t s = (cudaStream_t)stream;
  // the tensor-core tile moves 8 bf16 at a time along K and N
  const bool tc = dtype == 1 && K % 8 == 0 && N % 8 == 0 &&
                  ((uintptr_t)x | (uintptr_t)w) % 16 == 0;
  if (tc && out_f32) {
    linear_tc_kernel<float><<<grid, 128, 0, s>>>(
        (const bf16*)x, (const bf16*)w, b, (float*)y, M, N, K, act);
  } else if (tc) {
    linear_tc_kernel<bf16><<<grid, 128, 0, s>>>(
        (const bf16*)x, (const bf16*)w, b, (bf16*)y, M, N, K, act);
  } else if (dtype == 0) {
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

int fd_add_layernorm(const float* y, const void* r, const float* gamma, const float* beta,
                     float* out_f, void* out_t, int rows, int d, int dtype, int r_f32,
                     float eps, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = (size_t)d * sizeof(float);
  if (dtype == 0) {
    add_layernorm_kernel<float, float><<<rows, 128, smem, s>>>(
        y, (const float*)r, gamma, beta, out_f, (float*)out_t, d, eps);
  } else if (r_f32) {
    add_layernorm_kernel<bf16, float><<<rows, 128, smem, s>>>(
        y, (const float*)r, gamma, beta, out_f, (bf16*)out_t, d, eps);
  } else {
    add_layernorm_kernel<bf16, bf16><<<rows, 128, smem, s>>>(
        y, (const bf16*)r, gamma, beta, out_f, (bf16*)out_t, d, eps);
  }
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
