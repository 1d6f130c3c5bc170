// K-chunk partial GEMM tiles, shared by the commit GEMM
// (gemm_batch_invariant.cu) and the fast split-K GEMM (gemm_splitk.cu).
//
// One CTA computes the f32 partial  P[c] = x[:, kb:ke] @ w[kb:ke, :]  of one
// output tile over one contiguous K chunk c of a two-level partition
// (nested_bounds): K is cut into `outer` chunks by _split_sizes(K, outer)
// (near-equal, the remainder spread over the leading ones), and each of
// those into `inner` sub-chunks by _split_sizes of its own width, or kept
// whole when it is narrower than `inner` (the trailing sub-chunks then
// empty, their partials zero).  The commit GEMM passes (chunks, 1); the
// split-K GEMM (tp_shards, splits), the reference's _tp_partials over
// _reduce_k_f32.  The partials go to an f32 workspace, chunk-major; the
// caller's second pass combines them in the order its schedule prescribes.
// There are two tiles, chosen by the operand dtype alone, never by M:
//
// * bf16: wgmma_partial_kernel, the tensor cores fed by TMA.  At the decode
//   and verify batch (M <= 32) the call is bound by the weight read (K*N*2
//   bytes), so the design keeps bytes in flight: a ring of TC_STAGES
//   (weight, x) tiles in dynamic shared memory, filled by one producer
//   thread with cp.async.bulk.tensor and mbarriers, and drained by one
//   consumer warpgroup running wgmma.m64n32k16 (bf16 in, f32 accumulate).
//   A and B are swapped: the weight tile (64 output columns, N-contiguous)
//   is the instruction's A operand (MN-major), x's rows are its N = 32, so
//   the batch pads to 32 rows (TMA fills rows past M with zeros) and never
//   changes the instruction.  64-column tiles give N/64 x chunks CTAs: 64 at
//   N = 1024 with 4 chunks, 256 at N = 4096, several per SM.
// * f32: fmaf_partial_kernel, the CUDA cores.  Tensor cores have no IEEE
//   f32 product and the commit path forbids TF32, so each output element is
//   one sequential fmaf chain over k = kb, ..., ke-1.
//
// Reduction order (what makes a row's result independent of M): each output
// element's chunk sum is ONE f32 accumulator walked over the chunk's K steps
// in order (k16 wgmma steps within a 64-wide K step; the MMA's internal
// order per element is fixed by the instruction shape, which is literal).
// Tile sizes, the instruction shape, the K step and the ring depth are
// constexpr literals; the consumer warpgroup owns all of the tile's K; there
// are no atomics.  Chunk bounds are not the tensor's bounds: K steps lie on
// the 64-column grid (TMA wants 16-byte-aligned boxes), and a step that
// crosses a chunk bound zeroes x's columns outside the chunk in shared
// memory before its products, so the neighbouring chunks' weights
// contribute exact zeros.  A row's bits depend only on its own x row, on w
// and on the chunk bounds.
#pragma once

#include <cuda.h>
#include <dlfcn.h>

#include <functional>
#include <mutex>
#include <unordered_map>

#include "common.cuh"

namespace gemm_tile {
// Internal linkage: each library that includes this header keeps its own
// kernels, weight-map cache and shared-memory attribute
// (static locals of inline functions would otherwise be one object across
// the process, shared by both GEMM libraries).
namespace {

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma) fed by TMA
// ---------------------------------------------------------------------------

constexpr int TC_BN = 64;        // output columns per CTA = wgmma M (literal)
constexpr int TC_BM = 32;        // x rows per CTA = wgmma N (literal)
constexpr int TC_BK = 64;        // K step: one 128-byte swizzled bf16 row
constexpr int TC_MMA_K = 16;     // wgmma K (literal for bf16)
constexpr int TC_STAGES = 6;     // ring depth: 48 KB of weight tiles in flight
constexpr int TC_CONSUMERS = 128;                  // one consumer warpgroup
constexpr int TC_THREADS = TC_CONSUMERS + 32;      // + one producer warp
constexpr int TC_W_BYTES = TC_BK * TC_BN * 2;      // 8 KB weight tile
constexpr int TC_X_BYTES = TC_BM * TC_BK * 2;      // 4 KB x tile
constexpr int TC_STAGE_BYTES = TC_W_BYTES + TC_X_BYTES;
constexpr int TC_SMEM = TC_STAGES * TC_STAGE_BYTES + 2 * TC_STAGES * 8;
static_assert(TC_W_BYTES % 1024 == 0 && TC_X_BYTES % 1024 == 0,
              "128-byte swizzled tiles need 1024-byte alignment");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// Wait for the completion of the barrier's phase with this parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// 2-D TMA load of one box at (c0 innermost, c1) into shared memory.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar)) : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle.  Strides in bytes.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

// D(64 x 32, f32) += A(64 x 16) B(16 x 32): A = weight tile, MN-major
// (imm-trans-a 1), B = x tile, K-major (imm-trans-b 0).
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[TC_BM / 2],
                                                uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"  // scale-d: D += A B
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

__host__ __device__ __forceinline__ void chunk_bounds(int K, int chunks,
                                                      int c, int* kb,
                                                      int* ke) {
  const int base = K / chunks, rem = K % chunks;
  *kb = c * base + min(c, rem);
  *ke = *kb + base + (c < rem ? 1 : 0);
}

// Chunk c of the two-level partition: outer chunk c / inner, sub-chunk
// c % inner.  Nested bounds, not _split_sizes(K, outer * inner): the two
// differ wherever a cut is uneven.
__host__ __device__ __forceinline__ void nested_bounds(int K, int outer,
                                                       int inner, int c,
                                                       int* kb, int* ke) {
  int ob, oe;
  chunk_bounds(K, outer, c / inner, &ob, &oe);
  const int s = c % inner, n = oe - ob;
  if (inner <= n) {
    chunk_bounds(n, inner, s, kb, ke);
    *kb += ob;
    *ke += ob;
  } else {  // one pass over the whole outer chunk, in sub-chunk 0
    *kb = ob;
    *ke = s == 0 ? oe : ob;
  }
}

__global__ void __launch_bounds__(TC_THREADS)
wgmma_partial_kernel(const __grid_constant__ CUtensorMap wmap,
                     const __grid_constant__ CUtensorMap xmap,
                     float* __restrict__ part, int M, int N, int K,
                     int outer, int inner) {
  extern __shared__ __align__(1024) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + TC_STAGES * TC_STAGE_BYTES);
  uint64_t* empty = full + TC_STAGES;

  const int m0 = blockIdx.x * TC_BM;  // batch rows fastest: the M tiles of one
  const int n0 = blockIdx.y * TC_BN;  // weight tile run together and share it
  const int c = blockIdx.z;           // through L2
  int kb, ke;
  nested_bounds(K, outer, inner, c, &kb, &ke);
  // K steps lie on the 64-column grid: a TMA box's inner coordinate must be
  // 16-byte aligned, and a chunk bound need not be
  const int k_first = kb - kb % TC_BK;
  const int steps = (ke - k_first + TC_BK - 1) / TC_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < TC_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], TC_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= TC_CONSUMERS) {
    // producer: one thread keeps the ring full
    if (threadIdx.x == TC_CONSUMERS) {
      for (int s = 0; s < steps; ++s) {
        const int st = s % TC_STAGES;
        if (s >= TC_STAGES) mbar_wait(&empty[st], (s / TC_STAGES - 1) & 1);
        uint8_t* tile = smem + st * TC_STAGE_BYTES;
        const int k0 = k_first + s * TC_BK;
        mbar_expect_tx(&full[st], TC_STAGE_BYTES);
        tma_load_2d(tile, &wmap, n0, k0, &full[st]);
        tma_load_2d(tile + TC_W_BYTES, &xmap, k0, m0, &full[st]);
      }
    }
    return;
  }

  // consumer warpgroup: one accumulator per output element, K steps in order
  float acc[TC_BM / 2];
#pragma unroll
  for (int i = 0; i < TC_BM / 2; ++i) acc[i] = 0.f;

  for (int s = 0; s < steps; ++s) {
    const int st = s % TC_STAGES;
    mbar_wait(&full[st], (s / TC_STAGES) & 1);
    uint8_t* wt = smem + st * TC_STAGE_BYTES;
    uint8_t* xt = wt + TC_W_BYTES;
    const int lo = kb - (k_first + s * TC_BK);  // this step's columns in
    const int hi = ke - (k_first + s * TC_BK);  // the chunk: [lo, hi)
    if (lo > 0 || hi < TC_BK) {
      // the step crosses a chunk bound: zero x's columns outside [lo, hi)
      // (128-byte swizzle: 16-byte group g of row r sits at g ^ (r % 8))
      for (int v = threadIdx.x; v < TC_BM * 8; v += TC_CONSUMERS) {
        const int r = v / 8, g = v % 8;
        __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(
            xt + r * 128 + ((g ^ (r % 8)) * 16));
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (g * 8 + e < lo || g * 8 + e >= hi) dst[e] = __float2bfloat16_rn(0.f);
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("bar.sync 1, %0;" ::"n"(TC_CONSUMERS) : "memory");
    }
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < TC_BK / TC_MMA_K; ++kk) {
      // A: 16 weight rows of 128 bytes, 8-row groups 1024 bytes apart (the
      // MN-block stride is unused at M = 64, so it is given the same value)
      const uint64_t a = sw128_desc(wt + kk * TC_MMA_K * 128, 1024, 1024);
      // B: x rows of 128 bytes, K advanced 32 bytes inside the swizzled row
      // (the leading offset is unused by K-major swizzled layouts)
      const uint64_t b = sw128_desc(xt + kk * TC_MMA_K * 2, 16, 1024);
      wgmma_m64n32k16(acc, a, b);
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    mbar_arrive(&empty[st]);
  }

  // D fragment: warp w holds rows (output columns) 16w + lane/4 (+8); each
  // n8 block j holds batch rows 8j + 2*(lane%4) (+1)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_lo = n0 + 16 * warp + lane / 4;
#pragma unroll
  for (int j = 0; j < TC_BM / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = n_lo + (i / 2) * 8;
      const int m = m0 + 8 * j + 2 * (lane % 4) + (i % 2);
      if (m < M && n < N) part[((size_t)c * M + m) * N + n] = acc[4 * j + i];
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores (fmaf)
// ---------------------------------------------------------------------------

constexpr int BM = 32;       // rows of x per CTA (literal)
constexpr int BN = 128;      // columns of w per CTA (literal)
constexpr int BK = 64;       // K step through shared memory (literal)
constexpr int THREADS = 256; // 8 warps: warp w owns tile rows 4w..4w+3,
                             // lane l owns tile columns 4l..4l+3

__global__ void __launch_bounds__(THREADS)
fmaf_partial_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    float* __restrict__ part, int M, int N, int K, int outer,
                    int inner) {
  constexpr int VPR = BN / 4;                   // float4 vectors per w row
  constexpr int W_VECS = BK * BN / 4 / THREADS; // w vectors per thread
  constexpr int X_ELTS = BM * BK / THREADS;     // x elements per thread

  __shared__ __align__(16) float ws[BK][BN];
  __shared__ float xs[BK][BM + 1];  // +1: conflict-free transposed stores

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int c = blockIdx.z;
  int kb, ke;
  nested_bounds(K, outer, inner, c, &kb, &ke);

  const int tid = threadIdx.x;
  const int r0 = (tid / 32) * 4;
  const int c0 = (tid % 32) * 4;
  const bool active = m0 + r0 < M;  // warp-uniform: rows past M do no work

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  float4 wreg[W_VECS];
  float xreg[X_ELTS];

  auto load_tile = [&](int k0) {
#pragma unroll
    for (int i = 0; i < W_VECS; ++i) {
      const int v = tid + i * THREADS;
      const int k = k0 + v / VPR, n = n0 + (v % VPR) * 4;
      wreg[i] = (k < ke && n < N)
                    ? *reinterpret_cast<const float4*>(w + (size_t)k * N + n)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < X_ELTS; ++i) {
      const int e = tid + i * THREADS;
      const int m = m0 + e / BK, k = k0 + e % BK;
      xreg[i] = (m < M && k < ke) ? x[(size_t)m * K + k] : 0.f;
    }
  };

  auto store_tile = [&]() {
#pragma unroll
    for (int i = 0; i < W_VECS; ++i) {
      const int v = tid + i * THREADS;
      *reinterpret_cast<float4*>(&ws[v / VPR][(v % VPR) * 4]) = wreg[i];
    }
#pragma unroll
    for (int i = 0; i < X_ELTS; ++i) {
      const int e = tid + i * THREADS;
      xs[e % BK][e / BK] = xreg[i];
    }
  };

  auto step = [&](int kk) {
    const float4 b = *reinterpret_cast<const float4*>(&ws[kk][c0]);
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = xs[kk][r0 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a, bv[j], acc[i][j]);
    }
  };

  if (kb < ke) load_tile(kb);
  for (int k0 = kb; k0 < ke; k0 += BK) {
    __syncthreads();  // the previous step's reads of ws/xs are done
    store_tile();
    __syncthreads();
    if (k0 + BK < ke) load_tile(k0 + BK);  // in flight during the products
    if (active) {
      const int kn = min(BK, ke - k0);
      if (kn == BK) {
#pragma unroll 16
        for (int kk = 0; kk < BK; ++kk) step(kk);
      } else {
        for (int kk = 0; kk < kn; ++kk) step(kk);
      }
    }
  }

  if (!active || n0 + c0 >= N) return;  // N % 4 == 0: a vector is all in or out
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + r0 + i;
    if (m < M) {
      *reinterpret_cast<float4*>(part + ((size_t)c * M + m) * N + n0 + c0) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// host side: tensor maps and launches
// ---------------------------------------------------------------------------

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// cuTensorMapEncodeTiled, found in the libcuda.so.1 the process already
// loaded (no link-time dependency on it).
inline EncodeTiled encoder() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!h) h = dlopen("libcuda.so.1", RTLD_NOW);
    return h ? reinterpret_cast<EncodeTiled>(dlsym(h, "cuTensorMapEncodeTiled"))
             : nullptr;
  }();
  return fn;
}

// Tensor map of a row-major bf16 (rows, cols) matrix: a (box_rows, 64) box,
// 128-byte swizzle, reads past the edge filled with zeros.
inline bool encode_bf16(const void* ptr, int rows, int cols, int box_rows,
                        CUtensorMap* out) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)TC_BK, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
                dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Weight maps, cached by all that a weight's map encodes (base, K, N; the
// box is fixed), so each weight is encoded once per library.  A map holds
// no data: a base the allocator hands out again at the same shape finds a
// map that is still right.  x's map is encoded on every call.
struct WeightKey {
  const void* ptr;
  int rows, cols;
  bool operator==(const WeightKey& o) const {
    return ptr == o.ptr && rows == o.rows && cols == o.cols;
  }
};
struct WeightKeyHash {
  size_t operator()(const WeightKey& k) const {
    return std::hash<const void*>()(k.ptr) ^
           (static_cast<size_t>(k.rows) << 32 | static_cast<size_t>(k.cols));
  }
};
constexpr size_t MAX_WEIGHT_MAPS = 4096;  // past it the cache starts over
std::unordered_map<WeightKey, CUtensorMap, WeightKeyHash> weight_maps;
std::mutex weight_maps_mutex;

inline bool weight_map(const void* w, int K, int N, CUtensorMap* out) {
  std::lock_guard<std::mutex> lock(weight_maps_mutex);
  const WeightKey key{w, K, N};
  auto it = weight_maps.find(key);
  if (it == weight_maps.end()) {
    CUtensorMap map;
    if (!encode_bf16(w, K, N, TC_BK, &map)) return false;
    if (weight_maps.size() >= MAX_WEIGHT_MAPS) weight_maps.clear();
    it = weight_maps.emplace(key, map).first;
  }
  *out = it->second;
  return true;
}

// Launch the partial pass of x (M, K) @ w (K, N) over the outer * inner
// chunks of nested_bounds.  The operand dtype alone picks the tile.  bf16:
// grid (M tiles, N tiles, outer * inner) of the tensor-core tile; K and N
// multiples of 8 and 16-byte-aligned bases (the wrappers check).
template <typename T>
cudaError_t launch_partials(const void* x, const void* w, float* part, int M,
                            int N, int K, int outer, int inner,
                            cudaStream_t stream);

template <>
inline cudaError_t launch_partials<__nv_bfloat16>(const void* x, const void* w,
                                                  float* part, int M, int N,
                                                  int K, int outer, int inner,
                                                  cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      wgmma_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      TC_SMEM);
  if (attr != cudaSuccess) return attr;
  CUtensorMap wmap, xmap;
  if (!weight_map(w, K, N, &wmap) || !encode_bf16(x, M, K, TC_BM, &xmap))
    return cudaErrorInvalidValue;
  dim3 grid((M + TC_BM - 1) / TC_BM, (N + TC_BN - 1) / TC_BN, outer * inner);
  wgmma_partial_kernel<<<grid, TC_THREADS, TC_SMEM, stream>>>(
      wmap, xmap, part, M, N, K, outer, inner);
  return cudaGetLastError();
}

template <>
inline cudaError_t launch_partials<float>(const void* x, const void* w,
                                          float* part, int M, int N, int K,
                                          int outer, int inner,
                                          cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, outer * inner);
  fmaf_partial_kernel<<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), part, M, N,
      K, outer, inner);
  return cudaGetLastError();
}

}  // namespace
}  // namespace gemm_tile
