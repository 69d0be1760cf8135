// Hand-written Hopper (sm_90a) kernels for the port's three measurement
// probes (fpn_mt_image_captioning_torch/scripts/probe_*.py). Each replaces a
// Pallas kernel of the TPU probes in scripts/:
//
//   add_one_kernel          probe_launch_overhead.py:53 (variant A) and
//                           probe_pallas_overhead.py:36 (chain_pallas)
//   add_one_grid7_kernel    probe_launch_overhead.py:80 (variant B)
//   slab_tma_kernel         probe_grid_cell.py:84, 118, 154, 188 (A-D)
//   slab_loads_kernel,      layout D again, through plain 16-byte loads
//   slab_cp_async_kernel    and through cp.async
//
// The decoder-shaped launch of probe_launch_overhead.py:189 (variant C) is
// the port's own decode step on fused_decoder.cu built with -DFD_TRIVIAL_BODIES.
//
// Plain C interface, loaded with ctypes (ops/probes.py). Every entry point
// launches on the stream it is given, allocates nothing, and returns 0 or an
// error code that pr_error_string explains: a cudaError_t, or
// ENCODE_ERROR + the CUresult of a failed cuTensorMapEncodeTiled, or
// ENTRY_ERROR + the cudaError_t of a failed driver entry-point lookup.

#include <cuda.h>  // CUtensorMap and the driver's enums; the driver is reached through
                   // cudaGetDriverEntryPoint, so nothing links against libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr int ENCODE_ERROR = 20000;
constexpr int ENTRY_ERROR = 30000;

// ---------------------------------------------------------------------------
// (3a, 4) y = x + 1 over n float32 — the TPU's one-program kernel
// `o_ref[:] = x_ref[:] + 1.0` on (256, 256).
// Bound: bytes, 2·n·4 (0.16 us at 256×256); the launch, not the body, is what
// the probes price. Design: one element a thread, 256-thread blocks.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(256) add_one_kernel(const float* __restrict__ x,
                                                      float* __restrict__ y, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = x[i] + 1.f;
}

// (3b) the TPU's grid=(7,) with pl.when(program_id == 0): seven blocks, block 0
// writes x + 1 over all n, the other six return at once.
__global__ void __launch_bounds__(1024) add_one_grid7_kernel(const float* __restrict__ x,
                                                             float* __restrict__ y, int n) {
  if (blockIdx.x != 0) return;
  for (int i = threadIdx.x; i < n; i += blockDim.x) y[i] = x[i] + 1.f;
}

// ---------------------------------------------------------------------------
// (5) The slab copy: grid cell (b, i) takes rows 1 + i·rows ... + rows of
// item b of x (B, Hp, Wp, C) bf16 on chip, doubles them and writes them to the
// same rows of the output (rows 0 and Hp-1 of each item are never written, as
// on the TPU). A flagship slab (64 × 272 × 32 bf16, 1.11 MB) is five times a
// block's shared memory, so a cell walks its slab in chunks (about 70 KB) in
// two stages: while one chunk is doubled and stored, the next one loads. A
// slab that the chunks do not divide ends with a chunk moved back to end at
// the slab's last row; it copies some rows twice, with the same values.
// Bound: bytes, each slab row read once and written once (2 · B · 256 · Wp ·
// C · 2 bytes, 0.17 ms at the flagship shape).
//
// slab_tma_kernel is the TPU's DMA with semaphores: TMA (cp.async.bulk.tensor)
// completing on an mbarrier, one tensor map per TPU layout:
//   A  rank 4 (C, Wp, Hp, B), box (C, box_w, chunk, 1)
//   B  rank 3 (C, Wp, B·Hp),  box (C, box_w, chunk)
//   C  rank 4 over the 128-channel copy, as A
//   D  rank 2 (C, B·Hp·Wp),   nbox boxes (C, chunk) along the flat pixels
// A box extent is at most 256 elements, so a row of Wp > 256 takes two boxes
// (the second moved back to end at column Wp). Thread 0 issues every copy;
// all threads double the chunk in shared memory, fence it to the async proxy,
// and thread 0 stores it with TMA and, once the store has read the stage,
// loads the chunk after next into it.
// ---------------------------------------------------------------------------
struct SlabGeom {
  int hp, wp, rows, n_tiles;  // item rows (with the border), columns, slab rows, slabs per item
  int chunk;                  // A-C: rows a chunk; D: pixels a box
  int nbox;                   // A-C: boxes across a row; D: boxes a chunk
  int box_w;                  // A-C: columns a box
  int nchunks;                // chunks a slab
  int box_bytes, slot_bytes;  // bytes a box, and its 128-byte-aligned slot in a stage
};

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

template <int RANK>
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         const int* c) {
  const uint64_t m = reinterpret_cast<uint64_t>(map);
  if constexpr (RANK == 2) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
        "l"(m), "r"(smem_u32(bar)), "r"(c[0]), "r"(c[1])
        : "memory");
  } else if constexpr (RANK == 3) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
        "l"(m), "r"(smem_u32(bar)), "r"(c[0]), "r"(c[1]), "r"(c[2])
        : "memory");
  } else {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
        "l"(m), "r"(smem_u32(bar)), "r"(c[0]), "r"(c[1]), "r"(c[2]), "r"(c[3])
        : "memory");
  }
}

template <int RANK>
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, const int* c) {
  const uint64_t m = reinterpret_cast<uint64_t>(map);
  if constexpr (RANK == 2) {
    asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];" ::
                     "l"(m), "r"(smem_u32(src)), "r"(c[0]), "r"(c[1])
                 : "memory");
  } else if constexpr (RANK == 3) {
    asm volatile(
        "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];" ::"l"(m),
        "r"(smem_u32(src)), "r"(c[0]), "r"(c[1]), "r"(c[2])
        : "memory");
  } else {
    asm volatile(
        "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];" ::
            "l"(m), "r"(smem_u32(src)), "r"(c[0]), "r"(c[1]), "r"(c[2]), "r"(c[3])
        : "memory");
  }
}

// Coordinates (innermost first) of box k of chunk j of cell (b, i).
template <int RANK>
__device__ __forceinline__ void box_coords(const SlabGeom& g, int b, int i, int j, int k, int* c) {
  c[0] = 0;
  if constexpr (RANK == 2) {
    const int span = g.nbox * g.chunk, slab = g.rows * g.wp;
    c[1] = (b * g.hp + 1 + i * g.rows) * g.wp + min(j * span, slab - span) + k * g.chunk;
  } else {
    const int h = 1 + i * g.rows + min(j * g.chunk, g.rows - g.chunk);
    c[1] = k == g.nbox - 1 ? g.wp - g.box_w : k * g.box_w;
    if constexpr (RANK == 3) {
      c[2] = b * g.hp + h;
    } else {
      c[2] = h;
      c[3] = b;
    }
  }
}

// Doubles the 8 bf16 of a 16-byte vector (exact: only the exponent moves).
__device__ __forceinline__ uint4 twice(uint4 v) {
  const __nv_bfloat162 two = __float2bfloat162_rn(2.f);
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int k = 0; k < 4; ++k) p[k] = __hmul2(p[k], two);
  return v;
}

__device__ __forceinline__ unsigned char* align128(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 127) & ~uintptr_t(127));
}

template <int RANK>
__global__ void __launch_bounds__(256) slab_tma_kernel(const __grid_constant__ CUtensorMap in_map,
                                                       const __grid_constant__ CUtensorMap out_map,
                                                       const SlabGeom g) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* stage0 = align128(smem_raw);
  const int stage_bytes = g.nbox * g.slot_bytes;
  uint64_t* bar = reinterpret_cast<uint64_t*>(stage0 + 2 * stage_bytes);
  const int b = blockIdx.x / g.n_tiles, i = blockIdx.x % g.n_tiles;
  auto stage = [&](int s) { return stage0 + s * stage_bytes; };
  auto load = [&](int j) {  // thread 0 only
    const int s = j & 1;
    mbar_expect_tx(&bar[s], g.nbox * g.box_bytes);
    for (int k = 0; k < g.nbox; ++k) {
      int c[4];
      box_coords<RANK>(g, b, i, j, k, c);
      tma_load<RANK>(stage(s) + k * g.slot_bytes, &in_map, &bar[s], c);
    }
  };
  if (threadIdx.x == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    load(0);
    if (g.nchunks > 1) load(1);
  }
  __syncthreads();
  for (int j = 0; j < g.nchunks; ++j) {
    const int s = j & 1;
    mbar_wait(&bar[s], (j >> 1) & 1);
    uint4* v = reinterpret_cast<uint4*>(stage(s));
    for (int e = threadIdx.x; e < stage_bytes / 16; e += blockDim.x) v[e] = twice(v[e]);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int k = 0; k < g.nbox; ++k) {
        int c[4];
        box_coords<RANK>(g, b, i, j, k, c);
        tma_store<RANK>(&out_map, stage(s) + k * g.slot_bytes, c);
      }
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      if (j + 2 < g.nchunks) {
        // the stage is free once its store has read it
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
        load(j + 2);
      }
    }
  }
  if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Layout D through the SM's own loads: the slab is a flat run of rows·Wp
// pixels of `px` bytes starting at row 1 + i·rows of item b (row starts
// 16-byte aligned, which the wrapper checks), walked in chunks of `chunk_bytes`
// (the last moved back to end at the slab's end). Plain: each thread loads
// four 16-byte vectors into registers, then writes them to shared memory; the
// block doubles the chunk from shared memory into the output. One stage.
__global__ void __launch_bounds__(256) slab_loads_kernel(const uint4* __restrict__ x,
                                                         uint4* __restrict__ y, SlabGeom g,
                                                         int px, int chunk_bytes) {
  extern __shared__ unsigned char smem_raw[];
  uint4* buf = reinterpret_cast<uint4*>(align128(smem_raw));
  const int b = blockIdx.x / g.n_tiles, i = blockIdx.x % g.n_tiles;
  const size_t base = (size_t)(b * g.hp + 1 + i * g.rows) * g.wp * px / 16;
  const int slab_bytes = g.rows * g.wp * px;
  const int nv = chunk_bytes / 16;
  const int nchunks = (slab_bytes + chunk_bytes - 1) / chunk_bytes;
  for (int j = 0; j < nchunks; ++j) {
    const size_t off = base + min(j * chunk_bytes, slab_bytes - chunk_bytes) / 16;
    for (int e0 = threadIdx.x; e0 < nv; e0 += 4 * blockDim.x) {
      uint4 r[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * blockDim.x;
        if (e < nv) r[u] = x[off + e];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * blockDim.x;
        if (e < nv) buf[e] = r[u];
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < nv; e += blockDim.x) y[off + e] = twice(buf[e]);
    __syncthreads();
  }
}

// Layout D through cp.async (16 bytes, bypassing L1), two stages: the chunk
// after the current one is in flight while the current one is doubled.
__global__ void __launch_bounds__(256) slab_cp_async_kernel(const uint4* __restrict__ x,
                                                            uint4* __restrict__ y, SlabGeom g,
                                                            int px, int chunk_bytes) {
  extern __shared__ unsigned char smem_raw[];
  uint4* stage0 = reinterpret_cast<uint4*>(align128(smem_raw));
  const int b = blockIdx.x / g.n_tiles, i = blockIdx.x % g.n_tiles;
  const size_t base = (size_t)(b * g.hp + 1 + i * g.rows) * g.wp * px / 16;
  const int slab_bytes = g.rows * g.wp * px;
  const int nv = chunk_bytes / 16;
  const int nchunks = (slab_bytes + chunk_bytes - 1) / chunk_bytes;
  auto offset = [&](int j) { return base + min(j * chunk_bytes, slab_bytes - chunk_bytes) / 16; };
  auto load = [&](int j) {
    uint4* dst = stage0 + (j & 1) * nv;
    const size_t off = offset(j);
    for (int e = threadIdx.x; e < nv; e += blockDim.x)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst + e)),
                   "l"(x + off + e)
                   : "memory");
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  load(0);
  if (nchunks > 1) load(1);
  for (int j = 0; j < nchunks; ++j) {
    if (j + 1 < nchunks)
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    else
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();
    const uint4* src = stage0 + (j & 1) * nv;
    const size_t off = offset(j);
    for (int e = threadIdx.x; e < nv; e += blockDim.x) y[off + e] = twice(src[e]);
    __syncthreads();
    if (j + 2 < nchunks) load(j + 2);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, looked up once; 0 or an error code.
int encode_fn(EncodeTiledFn* fn) {
  static EncodeTiledFn cached = nullptr;
  if (!cached) {
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
    cached = reinterpret_cast<EncodeTiledFn>(p);
  }
  *fn = cached;
  return 0;
}

// A bf16 tensor map of `rank` dims (innermost first, strides in bytes for
// dims 1..rank-1) over `ptr`, boxes `box`; 0 or an error code.
int encode(CUtensorMap* map, void* ptr, int rank, const cuuint64_t* dims,
           const cuuint64_t* strides, const cuuint32_t* box) {
  EncodeTiledFn fn;
  const int rc = encode_fn(&fn);
  if (rc) return rc;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank, ptr, dims, strides,
                        box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_ERROR + (int)r;
}

template <typename K>
int set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

inline int last_error() { return (int)cudaGetLastError(); }

}  // namespace

extern "C" {

const char* pr_error_string(int code) {
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

int pr_add_one(const float* x, float* y, int n, void* stream) {
  add_one_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(x, y, n);
  return last_error();
}

int pr_add_one_grid7(const float* x, float* y, int n, void* stream) {
  add_one_grid7_kernel<<<7, 1024, 0, (cudaStream_t)stream>>>(x, y, n);
  return last_error();
}

// layout: 0 A, 1 B, 2 C (x is the 128-channel copy), 3 D. x and y are
// (B, Hp, Wp, C) bf16, contiguous; `geom` holds the SlabGeom fields in order.
int pr_slab_tma(const void* x, void* y, int layout, int B, int C, const int* geom, void* stream) {
  SlabGeom g;
  g.hp = geom[0];
  g.wp = geom[1];
  g.rows = geom[2];
  g.n_tiles = geom[3];
  g.chunk = geom[4];
  g.nbox = geom[5];
  g.box_w = geom[6];
  g.nchunks = geom[7];
  g.box_bytes = geom[8];
  g.slot_bytes = geom[9];
  const cuuint64_t esz = 2, px = (cuuint64_t)C * esz;
  CUtensorMap in_map, out_map;
  int rank, rc = 0;
  if (layout == 3) {
    rank = 2;
    const cuuint64_t dims[2] = {(cuuint64_t)C, (cuuint64_t)B * g.hp * g.wp};
    const cuuint64_t strides[1] = {px};
    const cuuint32_t box[2] = {(cuuint32_t)C, (cuuint32_t)g.chunk};
    rc = encode(&in_map, (void*)x, rank, dims, strides, box);
    if (!rc) rc = encode(&out_map, y, rank, dims, strides, box);
  } else if (layout == 1) {
    rank = 3;
    const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)g.wp, (cuuint64_t)B * g.hp};
    const cuuint64_t strides[2] = {px, px * g.wp};
    const cuuint32_t box[3] = {(cuuint32_t)C, (cuuint32_t)g.box_w, (cuuint32_t)g.chunk};
    rc = encode(&in_map, (void*)x, rank, dims, strides, box);
    if (!rc) rc = encode(&out_map, y, rank, dims, strides, box);
  } else {
    rank = 4;
    const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)g.wp, (cuuint64_t)g.hp, (cuuint64_t)B};
    const cuuint64_t strides[3] = {px, px * g.wp, px * g.wp * g.hp};
    const cuuint32_t box[4] = {(cuuint32_t)C, (cuuint32_t)g.box_w, (cuuint32_t)g.chunk, 1};
    rc = encode(&in_map, (void*)x, rank, dims, strides, box);
    if (!rc) rc = encode(&out_map, y, rank, dims, strides, box);
  }
  if (rc) return rc;
  const size_t smem = 2 * (size_t)g.nbox * g.slot_bytes + 2 * sizeof(uint64_t) + 128;
  const int cells = B * g.n_tiles;
  cudaStream_t s = (cudaStream_t)stream;
  if (rank == 2) {
    if ((rc = set_smem(slab_tma_kernel<2>, smem))) return rc;
    slab_tma_kernel<2><<<cells, 256, smem, s>>>(in_map, out_map, g);
  } else if (rank == 3) {
    if ((rc = set_smem(slab_tma_kernel<3>, smem))) return rc;
    slab_tma_kernel<3><<<cells, 256, smem, s>>>(in_map, out_map, g);
  } else {
    if ((rc = set_smem(slab_tma_kernel<4>, smem))) return rc;
    slab_tma_kernel<4><<<cells, 256, smem, s>>>(in_map, out_map, g);
  }
  return last_error();
}

// Layout D through plain loads (mechanism 0) or cp.async (1): geom as above
// (hp, wp, rows, n_tiles used); the chunk in bytes, a multiple of 16.
int pr_slab_flat(const void* x, void* y, int mechanism, int B, int C, const int* geom,
                 int chunk_bytes, void* stream) {
  SlabGeom g = {};
  g.hp = geom[0];
  g.wp = geom[1];
  g.rows = geom[2];
  g.n_tiles = geom[3];
  const size_t smem = (size_t)(mechanism ? 2 : 1) * chunk_bytes + 128;
  const int cells = B * g.n_tiles;
  cudaStream_t s = (cudaStream_t)stream;
  int rc;
  if (mechanism == 0) {
    if ((rc = set_smem(slab_loads_kernel, smem))) return rc;
    slab_loads_kernel<<<cells, 256, smem, s>>>((const uint4*)x, (uint4*)y, g, 2 * C,
                                               chunk_bytes);
  } else {
    if ((rc = set_smem(slab_cp_async_kernel, smem))) return rc;
    slab_cp_async_kernel<<<cells, 256, smem, s>>>((const uint4*)x, (uint4*)y, g, 2 * C,
                                                  chunk_bytes);
  }
  return last_error();
}

}  // extern "C"
