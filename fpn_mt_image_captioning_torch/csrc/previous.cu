// The two kernels as they were before their redesign for the H100, kept so
// that one run can time the previous and the present design in turns on the
// same card (chip_smoke.py): ir_block_kernel, the CUDA-core MobileNetV2
// inverted-residual block (float32 FMA for both 1×1 products, the patch
// staged as float32, one 256-thread block an SM), and
// logsoftmax_topk_kernel, one 256-thread block a row with the totals staged
// in shared memory and topk serial rounds of a block arg-max. Neither is on
// any path of the port: csrc/fused_backbone.cu and csrc/fused_decoder.cu
// hold the kernels that run. Entry points pv_ir_block and
// pv_logsoftmax_topk take the same arguments as the present ones did
// (ops/previous.py wraps them).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

__device__ __forceinline__ float relu6(float v) { return fminf(fmaxf(v, 0.f), 6.f); }

constexpr int TW = 8;       // output tile width
constexpr int CE = 32;      // expanded channels per chunk (one per lane)
constexpr int NT = 256;     // threads per block: 8 warps
constexpr int MAX_TH = 8;   // output tile height at most
constexpr int MAX_SMEM = 232448;

// Shared memory of one block, in floats (ops/previous.py:tile_plan computes
// the same).
inline int smem_floats(int th, int s, int cin, int nj) {
  const int p = ((th - 1) * s + 3) * ((TW - 1) * s + 3);
  const int cin4 = (cin + 3) & ~3;
  return p * cin4 + cin4 * CE + p * CE + th * TW * CE + CE * 32 * nj;
}

template <typename T, int S, bool EXPAND, int NJ>
__global__ void __launch_bounds__(NT, 1) ir_block_kernel(
    const T* __restrict__ x, const T* __restrict__ w_exp, const float* __restrict__ b_exp,
    const float* __restrict__ w_dw, const float* __restrict__ b_dw,
    const T* __restrict__ w_proj, const float* __restrict__ b_proj, T* __restrict__ y,
    int H, int W, int Cin, int Cexp, int Cout, int residual, int th, int tiles_x,
    int tiles_y) {
  extern __shared__ __align__(16) float smem[];
  constexpr int NC = 32 * NJ;
  constexpr int PW = (TW - 1) * S + 3;
  const int P = ((th - 1) * S + 3) * PW;
  const int cin4 = (Cin + 3) & ~3;
  const int TO = th * TW;
  float* xs = smem;               // (P, cin4)  input patch
  float* we = xs + P * cin4;      // (cin4, CE) expand weights of the chunk
  float* hs = we + cin4 * CE;     // (P, CE)    expanded chunk
  float* ds = hs + P * CE;        // (TO, CE)   depthwise output, rounded
  float* wps = ds + TO * CE;      // (CE, NC)   project weights of the chunk

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int t = blockIdx.x;
  const int tx0 = t % tiles_x;
  t /= tiles_x;
  const int ty0 = t % tiles_y;
  const int b = t / tiles_y;
  const int Ho = H / S, Wo = W / S;
  const int oy0 = ty0 * th, ox0 = tx0 * TW;
  // SAME: stride 1 pads one row/column before; stride 2 (even extent) none
  const int iy0 = oy0 * S - (S == 1), ix0 = ox0 * S - (S == 1);
  const int n0 = blockIdx.y * NC;

  for (int e = tid; e < P * cin4; e += NT) {
    const int p = e / cin4, k = e - p * cin4;
    const int iy = iy0 + p / PW, ix = ix0 + p % PW;
    float v = 0.f;
    if (k < Cin && iy >= 0 && iy < H && ix >= 0 && ix < W)
      v = to_f(x[(((size_t)b * H + iy) * W + ix) * Cin + k]);
    xs[e] = v;
  }

  // output pixel of (warp, i): tile row i, column warp
  float acc[MAX_TH][NJ];
#pragma unroll
  for (int i = 0; i < MAX_TH; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < Cexp; c0 += CE) {
    if (EXPAND) {
      for (int e = tid; e < cin4 * CE; e += NT) {
        const int k = e / CE, c = e % CE;
        we[e] = (k < Cin && c0 + c < Cexp) ? to_f(w_exp[(size_t)k * Cexp + c0 + c]) : 0.f;
      }
    }
    for (int e = tid; e < CE * NC; e += NT) {
      const int c = e / NC, n = e % NC;
      wps[e] = (c0 + c < Cexp && n0 + n < Cout)
                   ? to_f(w_proj[(size_t)(c0 + c) * Cout + n0 + n]) : 0.f;
    }
    __syncthreads();   // the first time, also the patch

    // (a) expand 1×1 + bias + relu6 over the patch; zero where the pixel is
    // padding (the depthwise must see zeros there, not relu6(b_exp))
    const int c = c0 + lane;
    if (EXPAND) {
      const float bias = c < Cexp ? b_exp[c] : 0.f;
      for (int p0 = warp; p0 < P; p0 += 4 * 8) {
        const float* xr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) xr[i] = xs + min(p0 + 8 * i, P - 1) * cin4;
        float a[4] = {0.f, 0.f, 0.f, 0.f};
        for (int k = 0; k < cin4; k += 4) {
          const float w0 = we[k * CE + lane], w1 = we[(k + 1) * CE + lane];
          const float w2 = we[(k + 2) * CE + lane], w3 = we[(k + 3) * CE + lane];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 v = *reinterpret_cast<const float4*>(xr[i] + k);
            a[i] = fmaf(v.x, w0, a[i]);
            a[i] = fmaf(v.y, w1, a[i]);
            a[i] = fmaf(v.z, w2, a[i]);
            a[i] = fmaf(v.w, w3, a[i]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int p = p0 + 8 * i;
          if (p < P) {
            const int iy = iy0 + p / PW, ix = ix0 + p % PW;
            const bool real = iy >= 0 && iy < H && ix >= 0 && ix < W;
            hs[p * CE + lane] = real ? relu6(a[i] + bias) : 0.f;
          }
        }
      }
    } else {   // expansion 1: the depthwise reads the input (zero padded)
      for (int p = warp; p < P; p += 8) hs[p * CE + lane] = c < Cexp ? xs[p * cin4 + c] : 0.f;
    }
    __syncthreads();

    // (b) depthwise 3×3 + bias + relu6, rounded to the working dtype
    {
      float wd[9];
#pragma unroll
      for (int j = 0; j < 9; ++j) wd[j] = c < Cexp ? w_dw[j * Cexp + c] : 0.f;
      const float bd = c < Cexp ? b_dw[c] : 0.f;
      for (int o = warp; o < TO; o += 8) {
        const int ty = o / TW, tx = o % TW;
        const float* hb = hs + (ty * S * PW + tx * S) * CE + lane;
        float a = bd;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) a += wd[dy * 3 + dx] * hb[(dy * PW + dx) * CE];
        ds[o * CE + lane] = to_f(from_f<T>(relu6(a)));
      }
    }
    __syncthreads();

    // (c) project: this chunk's share of d · W_proj
#pragma unroll 4
    for (int cc = 0; cc < CE; ++cc) {
      float dv[MAX_TH];
#pragma unroll
      for (int i = 0; i < MAX_TH; ++i) dv[i] = i < th ? ds[(warp + 8 * i) * CE + cc] : 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float wv = wps[cc * NC + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < MAX_TH; ++i) acc[i][j] = fmaf(dv[i], wv, acc[i][j]);
      }
    }
    __syncthreads();
  }

  // epilogue: bias, residual (stride 1: patch pixel (i+1, warp+1)), one cast
#pragma unroll
  for (int i = 0; i < MAX_TH; ++i) {
    const int oy = oy0 + i, ox = ox0 + warp;
    if (i >= th || oy >= Ho || ox >= Wo) continue;
    T* yr = y + (((size_t)b * Ho + oy) * Wo + ox) * Cout;
    const float* xr = xs + ((i + 1) * PW + warp + 1) * cin4;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int n = n0 + lane + 32 * j;
      if (n >= Cout) continue;
      float v = acc[i][j] + b_proj[n];
      if (residual) v += xr[n];
      yr[n] = from_f<T>(v);
    }
  }
}

struct Args {
  const void *x, *w_exp;
  const float *b_exp, *w_dw, *b_dw;
  const void* w_proj;
  const float* b_proj;
  void* y;
  int B, H, W, Cin, Cexp, Cout, stride, residual, th;
  cudaStream_t stream;
};

template <typename T, int S, bool EXPAND, int NJ>
int launch(const Args& a) {
  auto kern = ir_block_kernel<T, S, EXPAND, NJ>;
  const int smem = 4 * smem_floats(a.th, S, a.Cin, NJ);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  // set on every launch: the attribute is per device, and the call is cheap
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int Ho = a.H / S, Wo = a.W / S;
  const int tiles_x = (Wo + TW - 1) / TW, tiles_y = (Ho + a.th - 1) / a.th;
  const dim3 grid(a.B * tiles_y * tiles_x, (a.Cout + 32 * NJ - 1) / (32 * NJ));
  kern<<<grid, NT, smem, a.stream>>>(
      (const T*)a.x, (const T*)a.w_exp, a.b_exp, a.w_dw, a.b_dw, (const T*)a.w_proj,
      a.b_proj, (T*)a.y, a.H, a.W, a.Cin, a.Cexp, a.Cout, a.residual, a.th, tiles_x,
      tiles_y);
  return (int)cudaGetLastError();
}

template <typename T, int S, bool EXPAND>
int dispatch_nj(const Args& a, int nj) {
  switch (nj) {
    case 1: return launch<T, S, EXPAND, 1>(a);
    case 2: return launch<T, S, EXPAND, 2>(a);
    case 3: return launch<T, S, EXPAND, 3>(a);
    case 5: return launch<T, S, EXPAND, 5>(a);
    case 10: return launch<T, S, EXPAND, 10>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch(const Args& a, int nj) {
  const bool ex = a.w_exp != nullptr;
  if (a.stride == 1) return ex ? dispatch_nj<T, 1, true>(a, nj) : dispatch_nj<T, 1, false>(a, nj);
  if (a.stride == 2) return ex ? dispatch_nj<T, 2, true>(a, nj) : dispatch_nj<T, 2, false>(a, nj);
  return (int)cudaErrorInvalidValue;
}


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

}  // namespace

extern "C" {

const char* pv_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// x (B, H, W, Cin) NHWC; w_exp (Cin, Cexp) or null (expansion 1, Cexp = Cin);
// b_exp (Cexp); w_dw (9, Cexp) float32; b_dw (Cexp); w_proj (Cexp, Cout);
// b_proj (Cout); y (B, H/stride, W/stride, Cout). H and W even at stride 2.
// th in 1..8 output rows per tile; nj in {1, 2, 3, 5, 10} (32·nj output
// channels per block); dtype 1 (bfloat16) only.
int pv_ir_block(const void* x, const void* w_exp, const float* b_exp, const float* w_dw,
                const float* b_dw, const void* w_proj, const float* b_proj, void* y, int B,
                int H, int W, int Cin, int Cexp, int Cout, int stride, int residual, int th,
                int nj, int dtype, void* stream) {
  if (th < 1 || th > MAX_TH || (stride == 2 && (H % 2 || W % 2)) ||
      (residual && (stride != 1 || Cin != Cout)))
    return (int)cudaErrorInvalidValue;
  const Args a{x, w_exp, b_exp, w_dw, b_dw, w_proj, b_proj, y, B, H, W, Cin, Cexp, Cout,
               stride, residual, th, (cudaStream_t)stream};
  if (dtype == 1) return dispatch<bf16>(a, nj);  // bfloat16 only: the serving dtype
  return (int)cudaErrorInvalidValue;
}


int pv_logsoftmax_topk(const float* logits, const float* scores, const float* fin,
                       float* out_s, int* out_i, int BK, int V, int topk, void* stream) {
  const size_t smem = (size_t)V * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        logsoftmax_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  logsoftmax_topk_kernel<<<BK, 256, smem, (cudaStream_t)stream>>>(
      logits, scores, fin, out_s, out_i, V, topk);
  return (int)cudaGetLastError();
}

}  // extern "C"
