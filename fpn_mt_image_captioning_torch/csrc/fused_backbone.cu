// Hand-written Hopper (sm_90a) kernel for one MobileNetV2 inverted-residual
// block with inference BatchNorm folded into its weights:
//
//   h = relu6(x · W_exp + b_exp)            (absent for expansion-1 blocks)
//   d = relu6(depthwise3x3_s(h) + b_dw)     TF-SAME, stride s in {1, 2}
//   y = d · W_proj + b_proj (+ x)           residual when s = 1, Cin = Cout
//
// It replaces the TPU kernel fpn_mt_image_captioning_tpu/ops/fused_backbone.py:
// _ir_kernel (entry fused_ir_block), which ran one block per pallas_call on a
// bordered, 128-lane-padded layout that Mosaic required. Here the layout is
// plain NHWC with the real channel counts, SAME padding happens in shared
// memory, and the kernel reads only the input columns a stride-2 output
// needs (the TPU kernel computed every column and dropped half afterwards).
//
// What bounds it: bytes, for the wide early blocks. Each block must read its
// input and weights and write its output once; computed from the shapes at
// 512² and batch 64 in bf16 that is 10 MB (blocks 14-15, 16²) to 403 MB
// (block 0, 256²) per launch, 1.03 GB per encode: 0.31 ms at the H100 SXM's
// 3.35 TB/s. Only the narrow late blocks (32² and 16²) are bound by their
// operations at its 989 TFLOP/s bf16 instead. Three cuDNN convolutions also
// write and read the expanded intermediates (6× the input's channels)
// through device memory; this kernel keeps them on chip. Two kernels, by
// dtype:
//
// bfloat16 (the serving dtype), ir_block_mma_kernel: both 1×1 products on
// the tensor cores (mma.sync m16n8k16, bf16 in, float32 accumulate), 256
// threads and at least two blocks an SM (__launch_bounds__(256, 2), shared
// memory sized by ops/fused_backbone.py:tile_plan to fit two):
//
//   * a block is one tile of th × 8 output pixels (th in 16, 8, 4, 2, 1,
//     the largest whose project accumulators and shared memory fit two
//     blocks an SM; 16 only where the image still gives 4 tiles an SM, as
//     a tile pays fixed costs, loads' latency and barriers, that the small
//     early blocks feel) and one slice of the output channels (one slice at
//     every MobileNetV2 shape);
//   * the tile's input patch ((th-1)·s+3) × (7·s+3) pixels stays bf16 in
//     shared memory, K padded to 16 with zeros, loaded with 16-byte cp.async
//     (zero-filled outside the image) where Cin is a multiple of 8;
//   * the expanded channels go in chunks of 32. Each chunk's expand weights
//     (Cin × 32) and project weights (32 × slice) come in by cp.async; the
//     expand is patch · W_exp on mma.sync (warps over 16-pixel m-tiles),
//     + bias, relu6, zero where the pixel is padding (not relu6(b_exp)),
//     kept as float32 in shared memory; the depthwise reads that float32
//     with float32 weights (lane = channel, warps over output pixels) and
//     rounds to bf16, which is exactly the project's A operand; the project
//     adds d · W_proj into float32 accumulators that each warp keeps in
//     registers across the chunks (an m-tile of 16 output pixels times
//     NTW n-tiles of 8 channels);
//   * epilogue: bias, residual (from the bf16 patch) in float32, one rounding.
//
// float32, ir_block_f32_kernel: the same tiling on the CUDA cores in
// float32 FMA (TF32 would break float32's bar), everything staged as float32,
// one 256-thread block per tile of th × 8 pixels and slice of 32·NJ channels.
//
// Plain C interface, loaded with ctypes. The entry point launches on the
// stream it is given, allocates nothing, and returns cudaGetLastError() so a
// refused launch raises in the wrapper; with a non-null `occupancy` it
// launches nothing and writes the blocks an SM the plan's kernel reaches.
// dtype codes: 0 float32, 1 bfloat16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
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
constexpr int CE = 32;      // expanded channels per chunk (one per lane in the depthwise)
constexpr int NT = 256;     // threads per block: 8 warps
constexpr int MAX_TH = 8;   // output tile height at most (float32; bfloat16 twice that)
constexpr int MAX_SMEM = 232448;

// --- float32: CUDA cores ---------------------------------------------------
// Shared memory of one block, in floats (ops/fused_backbone.py:tile_plan
// computes the same).
inline int smem_floats(int th, int s, int cin, int nj) {
  const int p = ((th - 1) * s + 3) * ((TW - 1) * s + 3);
  const int cin4 = (cin + 3) & ~3;
  return p * cin4 + cin4 * CE + p * CE + th * TW * CE + CE * 32 * nj;
}

template <typename T, int S, bool EXPAND, int NJ>
__global__ void __launch_bounds__(NT, 1) ir_block_f32_kernel(
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

// --- bfloat16: tensor cores ------------------------------------------------
// Shared rows carry 8 bf16 (16 bytes) of padding, so the 8 row addresses of
// an ldmatrix land in distinct banks; the expanded chunk's float32 rows are
// CE + 8 floats, so a quad's float2 stores of one fragment row do too.
constexpr int DLD = CE + 8;   // bf16 a row of the expand weights and of the depthwise output
constexpr int HLD = CE + 8;   // floats a row of the expanded chunk

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
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

// The tile's geometry, the same on the host and the device.
struct MmaTile {
  int P, K16, LDX, TO, MT, WPM, SW;
  __host__ __device__ MmaTile(int th, int s, int cin, int ntw) {
    P = ((th - 1) * s + 3) * ((TW - 1) * s + 3);  // patch pixels
    K16 = (cin + 15) & ~15;                      // K of the expand, padded to 16
    LDX = K16 + 8;                               // bf16 a patch row
    TO = th * TW;                                // output pixels
    MT = (TO + 15) / 16;                         // m-tiles of the output: 1, 2, 4 or 8
    WPM = 8 / MT;                                // warps on each
    SW = WPM * ntw * 8;                          // output channels a block
  }
  // rows of the depthwise output: at least one m-tile
  __host__ __device__ int ds_rows() const { return TO > 16 ? TO : 16; }
};

// Shared memory of one block in bytes (ops/fused_backbone.py:_mma_smem
// computes the same): patch, expand weights and expanded chunk (expand
// blocks only), depthwise output, project weights.
__host__ __device__ inline int mma_smem_bytes(int th, int s, int cin, int ntw, bool expand) {
  const MmaTile g(th, s, cin, ntw);
  return 2 * g.P * g.LDX + (expand ? 2 * g.K16 * DLD + 4 * g.P * HLD : 0) +
         2 * g.ds_rows() * DLD + 2 * CE * (g.SW + 8);
}

template <int S, bool EXPAND, int NTW>
__global__ void __launch_bounds__(NT, 2) ir_block_mma_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w_exp, const float* __restrict__ b_exp,
    const float* __restrict__ w_dw, const float* __restrict__ b_dw,
    const bf16* __restrict__ w_proj, const float* __restrict__ b_proj, bf16* __restrict__ y,
    int H, int W, int Cin, int Cexp, int Cout, int residual, int th, int tiles_x,
    int tiles_y) {
  extern __shared__ __align__(16) unsigned char fb_smem[];
  constexpr int PW = (TW - 1) * S + 3;
  const MmaTile gt(th, S, Cin, NTW);
  const int P = gt.P, K16 = gt.K16, LDX = gt.LDX, TO = gt.TO, MT = gt.MT, SW = gt.SW;
  const int SWLD = SW + 8;
  bf16* xs = reinterpret_cast<bf16*>(fb_smem);               // (P, LDX)    patch
  bf16* we = xs + P * LDX;                                   // (K16, DLD)  expand weights
  float* hs = reinterpret_cast<float*>(we + (EXPAND ? K16 * DLD : 0));  // (P, HLD) expanded
  bf16* ds = reinterpret_cast<bf16*>(hs + (EXPAND ? P * HLD : 0));      // (>= 16, DLD) depthwise
  bf16* wps = ds + gt.ds_rows() * DLD;                       // (CE, SWLD)  project weights

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  int tile = blockIdx.x;
  const int tx0 = tile % tiles_x;
  tile /= tiles_x;
  const int ty0 = tile % tiles_y;
  const int b = tile / tiles_y;
  const int Ho = H / S, Wo = W / S;
  const int oy0 = ty0 * th, ox0 = tx0 * TW;
  // SAME: stride 1 pads one row/column before; stride 2 (even extent) none
  const int iy0 = oy0 * S - (S == 1), ix0 = ox0 * S - (S == 1);
  const int n0 = blockIdx.y * SW, nvalid = min(SW, Cout - n0);

  // the patch, zero outside the image and in the K padding
  if (Cin % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0) {
    const int kc = K16 / 8;
    for (int e = tid; e < P * kc; e += NT) {
      const int p = e / kc, k = (e - p * kc) * 8;
      const int iy = iy0 + p / PW, ix = ix0 + p % PW;
      const bool ok = k < Cin && iy >= 0 && iy < H && ix >= 0 && ix < W;
      cp_async16(xs + p * LDX + k, ok ? x + (((size_t)b * H + iy) * W + ix) * Cin + k : x, ok);
    }
  } else {
    for (int e = tid; e < P * K16; e += NT) {
      const int p = e / K16, k = e - p * K16;
      const int iy = iy0 + p / PW, ix = ix0 + p % PW;
      const bool ok = k < Cin && iy >= 0 && iy < H && ix >= 0 && ix < W;
      xs[p * LDX + k] = ok ? x[(((size_t)b * H + iy) * W + ix) * Cin + k] : __float2bfloat16(0.f);
    }
  }
  const bool evec = Cexp % 8 == 0 && reinterpret_cast<uintptr_t>(w_exp) % 16 == 0;
  const bool pvec = Cout % 8 == 0 && reinterpret_cast<uintptr_t>(w_proj) % 16 == 0;

  // this warp's project accumulators: m-tile pm, n-tiles pn .. pn + NTW - 1
  const int pm = warp % MT, pn = (warp / MT) * NTW;
  float acc[NTW][4];
#pragma unroll
  for (int j = 0; j < NTW; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int c0 = 0; c0 < Cexp; c0 += CE) {
    // the chunk's weights: we[k][c] = w_exp[k, c0 + c], wps[k][n] = w_proj[c0 + k, n0 + n]
    if (EXPAND) {
      if (evec) {
        for (int e = tid; e < K16 * (CE / 8); e += NT) {
          const int k = e / (CE / 8), c = (e % (CE / 8)) * 8;
          const bool ok = k < Cin && c0 + c < Cexp;
          cp_async16(we + k * DLD + c, ok ? w_exp + (size_t)k * Cexp + c0 + c : w_exp, ok);
        }
      } else {
        for (int e = tid; e < K16 * CE; e += NT) {
          const int k = e / CE, c = e % CE;
          we[k * DLD + c] = k < Cin && c0 + c < Cexp ? w_exp[(size_t)k * Cexp + c0 + c]
                                                     : __float2bfloat16(0.f);
        }
      }
    }
    if (pvec) {
      for (int e = tid; e < CE * (SW / 8); e += NT) {
        const int k = e / (SW / 8), n = (e % (SW / 8)) * 8;
        const bool ok = c0 + k < Cexp && n < nvalid;
        cp_async16(wps + k * SWLD + n, ok ? w_proj + (size_t)(c0 + k) * Cout + n0 + n : w_proj, ok);
      }
    } else {
      for (int e = tid; e < CE * SW; e += NT) {
        const int k = e / SW, n = e % SW;
        wps[k * SWLD + n] = c0 + k < Cexp && n < nvalid ? w_proj[(size_t)(c0 + k) * Cout + n0 + n]
                                                        : __float2bfloat16(0.f);
      }
    }
    cp_async_wait_all();
    __syncthreads();  // the first time, also the patch

    // (a) expand on the tensor cores: (patch pixels × K16) · (K16 × 32), + bias,
    // relu6, zero where the pixel is padding; float32 into hs
    if (EXPAND) {
      float be[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int c = c0 + 8 * j + 2 * t + u;
          be[j][u] = c < Cexp ? b_exp[c] : 0.f;
        }
      for (int mt = warp; mt < (P + 15) / 16; mt += NT / 32) {
        float h[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) h[j][0] = h[j][1] = h[j][2] = h[j][3] = 0.f;
        const bf16* arow = xs + min(mt * 16 + (lane & 15), P - 1) * LDX + 8 * (lane >> 4);
        const bf16* brow = we + ((lane & 7) + 8 * ((lane >> 3) & 1)) * DLD + 8 * (lane >> 4);
        for (int k0 = 0; k0 < K16; k0 += 16) {
          uint32_t a[4], b0[4], b1[4];
          ldsm_x4(a, arow + k0);
          ldsm_x4_trans(b0, brow + k0 * DLD);
          ldsm_x4_trans(b1, brow + k0 * DLD + 16);
          mma_bf16(h[0], a, b0[0], b0[1]);
          mma_bf16(h[1], a, b0[2], b0[3]);
          mma_bf16(h[2], a, b1[0], b1[1]);
          mma_bf16(h[3], a, b1[2], b1[3]);
        }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int p = mt * 16 + g + 8 * hf;
          if (p < P) {
            const int iy = iy0 + p / PW, ix = ix0 + p % PW;
            const bool real = iy >= 0 && iy < H && ix >= 0 && ix < W;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float v0 = real ? relu6(h[j][2 * hf] + be[j][0]) : 0.f;
              const float v1 = real ? relu6(h[j][2 * hf + 1] + be[j][1]) : 0.f;
              *reinterpret_cast<float2*>(hs + p * HLD + 8 * j + 2 * t) = make_float2(v0, v1);
            }
          }
        }
      }
      __syncthreads();
    }

    // (b) depthwise 3×3 + bias + relu6 in float32 from the float32 expanded
    // chunk (or the zero-padded input), rounded to bf16: the project's A
    {
      const int c = c0 + lane;
      float wd[9];
#pragma unroll
      for (int j = 0; j < 9; ++j) wd[j] = c < Cexp ? w_dw[j * Cexp + c] : 0.f;
      const float bd = c < Cexp ? b_dw[c] : 0.f;
      for (int o = warp; o < TO; o += NT / 32) {
        const int pb = (o / TW) * S * PW + (o % TW) * S;
        float a = bd;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const int p = pb + dy * PW + dx;
            const float hv = EXPAND ? hs[p * HLD + lane]
                                    : (c < Cexp ? to_f(xs[p * LDX + c]) : 0.f);
            a = fmaf(wd[dy * 3 + dx], hv, a);
          }
        ds[o * DLD + lane] = __float2bfloat16(relu6(a));
      }
    }
    __syncthreads();

    // (c) project on the tensor cores: this chunk's (16 pixels × 32) · (32 × 8·NTW)
    // into the warp's accumulators
#pragma unroll
    for (int kk = 0; kk < CE / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, ds + min(pm * 16 + (lane & 15), TO - 1) * DLD + kk * 16 + 8 * (lane >> 4));
      const bf16* brow =
          wps + (kk * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * SWLD + 8 * (lane >> 4);
#pragma unroll
      for (int j = 0; j < NTW; j += 2) {
        if ((pn + j) * 8 < nvalid) {  // warp-uniform: n-tiles past Cout are zeros
          uint32_t bb[4];
          ldsm_x4_trans(bb, brow + (pn + j) * 8);
          mma_bf16(acc[j], a, bb[0], bb[1]);
          mma_bf16(acc[j + 1], a, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();
  }

  // epilogue: bias, residual (stride 1: patch pixel (ty+1, tx+1)) in float32,
  // one rounding
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int o = pm * 16 + g + 8 * hf;
    const int oy = oy0 + o / TW, ox = ox0 + o % TW;
    if (o >= TO || oy >= Ho || ox >= Wo) continue;
    bf16* yr = y + (((size_t)b * Ho + oy) * Wo + ox) * Cout;
    const bf16* xr = xs + ((o / TW + 1) * PW + o % TW + 1) * LDX;
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      const int n = n0 + (pn + j) * 8 + 2 * t;
      if (n >= Cout) continue;
      float v0 = acc[j][2 * hf] + b_proj[n];
      float v1 = n + 1 < Cout ? acc[j][2 * hf + 1] + b_proj[n + 1] : 0.f;
      if (residual) {
        v0 += to_f(xr[n]);
        if (n + 1 < Cout) v1 += to_f(xr[n + 1]);
      }
      if (n + 1 < Cout && Cout % 2 == 0) {
        *reinterpret_cast<__nv_bfloat162*>(yr + n) = __floats2bfloat162_rn(v0, v1);
      } else {
        yr[n] = __float2bfloat16(v0);
        if (n + 1 < Cout) yr[n + 1] = __float2bfloat16(v1);
      }
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
  int* occupancy;  // non-null: report the blocks an SM, launch nothing
};

// Launch kern (or report its occupancy) on the plan's grid: tiles × slices
// of `width` output channels.
template <typename T, typename Kern>
int launch(Kern kern, const Args& a, int S, int smem, int width) {
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  // set on every launch: the attribute is per device, and the call is cheap
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (a.occupancy)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(a.occupancy, kern, NT, smem);
  const int Ho = a.H / S, Wo = a.W / S;
  const int tiles_x = (Wo + TW - 1) / TW, tiles_y = (Ho + a.th - 1) / a.th;
  const dim3 grid(a.B * tiles_y * tiles_x, (a.Cout + width - 1) / width);
  kern<<<grid, NT, smem, a.stream>>>(
      (const T*)a.x, (const T*)a.w_exp, a.b_exp, a.w_dw, a.b_dw, (const T*)a.w_proj, a.b_proj,
      (T*)a.y, a.H, a.W, a.Cin, a.Cexp, a.Cout, a.residual, a.th, tiles_x, tiles_y);
  return (int)cudaGetLastError();
}

template <int S, bool EXPAND>
int dispatch_f32(const Args& a, int nj) {
  const int smem = 4 * smem_floats(a.th, S, a.Cin, nj);
#define FB_NJ(N) \
  case N: return launch<float>(ir_block_f32_kernel<float, S, EXPAND, N>, a, S, smem, 32 * N);
  switch (nj) {
    FB_NJ(1) FB_NJ(2) FB_NJ(3) FB_NJ(5) FB_NJ(10)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FB_NJ
}

template <int S, bool EXPAND>
int dispatch_mma(const Args& a, int ntw) {
  const int smem = mma_smem_bytes(a.th, S, a.Cin, ntw, EXPAND);
  const int width = MmaTile(a.th, S, a.Cin, ntw).SW;
#define FB_NTW(N) \
  case N: return launch<bf16>(ir_block_mma_kernel<S, EXPAND, N>, a, S, smem, width);
  switch (ntw) {
    FB_NTW(2) FB_NTW(4) FB_NTW(6) FB_NTW(10)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FB_NTW
}

template <int S>
int dispatch(const Args& a, int unit, int dtype) {
  const bool ex = a.w_exp != nullptr;
  if (dtype == 0) return ex ? dispatch_f32<S, true>(a, unit) : dispatch_f32<S, false>(a, unit);
  return ex ? dispatch_mma<S, true>(a, unit) : dispatch_mma<S, false>(a, unit);
}

}  // namespace

extern "C" {

const char* fb_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// x (B, H, W, Cin) NHWC; w_exp (Cin, Cexp) or null (expansion 1, Cexp = Cin);
// b_exp (Cexp); w_dw (9, Cexp) float32; b_dw (Cexp); w_proj (Cexp, Cout);
// b_proj (Cout); y (B, H/stride, W/stride, Cout). H and W even at stride 2.
// th in 1..8 output rows per tile (1, 2, 4, 8 or 16 in bfloat16); unit: float32
// NJ in {1, 2, 3, 5, 10} (32·NJ output channels a block), bfloat16 NTW in
// {2, 4, 6, 10} (n-tiles of 8 channels a warp). With a non-null occupancy,
// nothing launches: *occupancy becomes the blocks an SM of that plan.
int fb_ir_block(const void* x, const void* w_exp, const float* b_exp, const float* w_dw,
                const float* b_dw, const void* w_proj, const float* b_proj, void* y, int B,
                int H, int W, int Cin, int Cexp, int Cout, int stride, int residual, int th,
                int unit, int dtype, void* stream, int* occupancy) {
  if (th < 1 || th > (dtype == 1 ? 2 * MAX_TH : MAX_TH) || (dtype == 1 && 16 % th) ||
      (stride == 2 && (H % 2 || W % 2)) || (residual && (stride != 1 || Cin != Cout)) ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Args a{x, w_exp, b_exp, w_dw, b_dw, w_proj, b_proj, y, B, H, W, Cin, Cexp, Cout,
               stride, residual, th, (cudaStream_t)stream, occupancy};
  if (stride == 1) return dispatch<1>(a, unit, dtype);
  if (stride == 2) return dispatch<2>(a, unit, dtype);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
