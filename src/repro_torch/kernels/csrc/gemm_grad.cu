// The training GEMMs' backward products: C = A @ B in one f32 pass.
//
// Replaces no TPU kernel: the reference differentiates
// repro/core/determinism.py::matmul through XLA, and the port computes the
// two products of that gradient, dX = dY W^T and dW = X^T dY, each one f32
// pass rounded once to bf16 (kernels/ops.py::GemmGrad).  This is the
// commit GEMM's contract at one chunk (gemm_batch_invariant.cu), with a
// tile made for training's shapes: M is the step's token count (2048 in
// the training phase), so the products are bound by the tensor cores, not
// by the weight read that bounds the decode tile of gemm_tile.cuh.
//
// Operands are read in place, as the views autograd hands over:
// * A (M, K) K-major (row stride lda, dY of dX) or M-major (column stride
//   lda, X^T of dW: X as stored);
// * B (K, N) K-major (column stride ldb, W^T of dX: W as stored) or
//   N-major (row stride ldb, dY of dW).
// TMA boxes cover the tensors as they lie in memory, and the wgmma
// shared-memory descriptors' major-ness (transpose flags, legal for 16-bit
// types) absorbs the transpose; TMA's zero fill past each edge pads the
// contraction and the ragged M and N tiles.  A stride or base that TMA
// cannot take (not 16-byte aligned) is the wrapper's to copy.
//
// Design: one CTA computes a GP_BM x GP_BN (128 x 256) output tile.  One
// producer warpgroup (one thread issuing TMA) keeps a ring of GP_STAGES
// (A, B) K steps of GP_BK = 64 in shared memory, with full / empty
// mbarriers; two consumer warpgroups, 64 rows each, issue
// wgmma.m64n256k16 (bf16 in, f32 accumulate) on the stages as they land,
// keeping one step's group in flight.  The epilogue rounds the f32
// accumulators to bf16 and stores the tile from registers, masked at M and
// N: one launch a product, no partial workspace, no combine pass.
// 128 x 256 x 64 moves 48 KB a step for 4.2 MFLOP (85 FLOP per byte from
// L2), 4 stages are 192 KB of the SM's 227 KB.
//
// Reduction order (what keeps a row's bits independent of M): each output
// element is ONE f32 accumulator walked over K in 64-wide steps, in order,
// with k16 instructions in order within a step; the tile, K step, ring
// depth and instruction shape are constexpr literals, never chosen by M;
// no split-K, no atomics.  A row's tile position follows from its index
// alone (tiles start at row 0), so its bits depend only on its own A row
// and on B.
#include "gemm_tile.cuh"

namespace gemm_tile {
namespace {

constexpr int GP_BM = 128;            // output rows per CTA: 2 x wgmma M
constexpr int GP_BN = 256;            // output columns per CTA = wgmma N (literal)
constexpr int GP_BK = 64;             // K step: one 128-byte swizzled bf16 row
constexpr int GP_MMA_K = 16;          // wgmma K (literal for bf16)
constexpr int GP_STAGES = 4;          // ring depth
constexpr int GP_ATOM = 64;           // bf16 elements of one 128-byte swizzle row
constexpr int GP_WG = 128;            // threads of a warpgroup
constexpr int GP_CONSUMERS = 2 * GP_WG;              // two consumer warpgroups
constexpr int GP_THREADS = GP_CONSUMERS + GP_WG;     // + one producer warpgroup
constexpr int GP_A_BYTES = GP_BM * GP_BK * 2;        // 16 KB
constexpr int GP_B_BYTES = GP_BN * GP_BK * 2;        // 32 KB
constexpr int GP_ATOM_BYTES = GP_ATOM * GP_BK * 2;   // an MN-major box: 8 KB
constexpr int GP_STAGE_BYTES = GP_A_BYTES + GP_B_BYTES;
constexpr int GP_SMEM = GP_STAGES * GP_STAGE_BYTES + 2 * GP_STAGES * 8 + 1024;
static_assert(GP_ATOM_BYTES % 1024 == 0 && GP_A_BYTES % 1024 == 0,
              "128-byte swizzled tiles need 1024-byte alignment");

// D(64 x 256, f32) += A(64 x 16) B(16 x 256), both from shared memory; TA
// and TB are the transpose flags (1: MN-major).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[GP_BN / 2], uint64_t a,
                                                 uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"  // scale-d: D += A B
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, "
      "%123, %124, %125, %126, %127}, %128, %129, p, 1, 1, %131, %132;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]),
        "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]),
        "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
        "+f"(d[127])
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
}

// Two f32 values rounded to bf16 at columns col, col + 1 of row r, the
// columns past N left alone (a pair is one 4-byte store when N is even).
__device__ __forceinline__ void store_pair(__nv_bfloat16* out, int r, int col, int N,
                                           float v0, float v1) {
  __nv_bfloat16* p = out + (size_t)r * N + col;
  if ((N & 1) == 0) {
    if (col < N) *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  } else {
    if (col < N) p[0] = __float2bfloat16_rn(v0);
    if (col + 1 < N) p[1] = __float2bfloat16_rn(v1);
  }
}

template <bool A_MN, bool B_MN>
__global__ void __launch_bounds__(GP_THREADS, 1)
grad_product_kernel(const __grid_constant__ CUtensorMap amap,
                    const __grid_constant__ CUtensorMap bmap,
                    __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + GP_STAGES * GP_STAGE_BYTES);
  uint64_t* empty = full + GP_STAGES;

  const int m0 = blockIdx.x * GP_BM;  // M tiles fastest: the CTAs that share a
  const int n0 = blockIdx.y * GP_BN;  // B slab run together and share it in L2
  const int steps = (K + GP_BK - 1) / GP_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < GP_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], GP_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < GP_WG) {
    // producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 0) {
      for (int s = 0; s < steps; ++s) {
        const int st = s % GP_STAGES;
        if (s >= GP_STAGES) mbar_wait(&empty[st], (s / GP_STAGES - 1) & 1);
        uint8_t* a = smem + st * GP_STAGE_BYTES;
        uint8_t* b = a + GP_A_BYTES;
        const int k0 = s * GP_BK;
        mbar_expect_tx(&full[st], GP_STAGE_BYTES);
        if constexpr (A_MN) {
          // (64 rows of M, 64 of K) boxes, K rows of 128 bytes
          for (int j = 0; j < GP_BM / GP_ATOM; ++j)
            tma_load_2d(a + j * GP_ATOM_BYTES, &amap, m0 + j * GP_ATOM, k0, &full[st]);
        } else {
          tma_load_2d(a, &amap, k0, m0, &full[st]);  // 128 rows of 64 K
        }
        if constexpr (B_MN) {
          for (int j = 0; j < GP_BN / GP_ATOM; ++j)
            tma_load_2d(b + j * GP_ATOM_BYTES, &bmap, n0 + j * GP_ATOM, k0, &full[st]);
        } else {
          tma_load_2d(b, &bmap, k0, n0, &full[st]);  // 256 columns of 64 K
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: tile rows 64 wg .. 64 wg + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int wg = threadIdx.x / GP_WG - 1;
  float acc[GP_BN / 2];
#pragma unroll
  for (int i = 0; i < GP_BN / 2; ++i) acc[i] = 0.f;

  for (int s = 0; s < steps; ++s) {
    const int st = s % GP_STAGES;
    mbar_wait(&full[st], (s / GP_STAGES) & 1);
    // either layout keeps a warpgroup's 64 rows in 8 KB of its own
    const uint8_t* a = smem + st * GP_STAGE_BYTES + wg * (GP_A_BYTES / 2);
    const uint8_t* b = smem + st * GP_STAGE_BYTES + GP_A_BYTES;
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < GP_BK / GP_MMA_K; ++kk) {
      // K-major: rows of 128 bytes, 8-row groups 1024 bytes apart, K advanced
      // 32 bytes inside the swizzled row (the leading offset is unused).
      // MN-major: K rows of 128 bytes, 16 of them a k16 step; 8-row K groups
      // 1024 bytes apart (stride offset) and 64-wide MN atoms one box apart
      // (leading offset; A's 64 rows are one atom)
      const uint64_t da = A_MN ? sw128_desc(a + kk * GP_MMA_K * 128, GP_ATOM_BYTES, 1024)
                               : sw128_desc(a + kk * GP_MMA_K * 2, 16, 1024);
      const uint64_t db = B_MN ? sw128_desc(b + kk * GP_MMA_K * 128, GP_ATOM_BYTES, 1024)
                               : sw128_desc(b + kk * GP_MMA_K * 2, 16, 1024);
      wgmma_m64n256k16<A_MN ? 1 : 0, B_MN ? 1 : 0>(acc, da, db);
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    // this step's group stays in flight; the one before it is done, so its
    // stage goes back to the producer
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
    if (s > 0) mbar_arrive(&empty[(s - 1) % GP_STAGES]);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");

  // D fragment: warp w holds rows 16w + lane/4 (+8); n8 block j holds
  // columns 8j + 2*(lane%4) (+1)
  const int warp = (threadIdx.x % GP_WG) / 32, lane = threadIdx.x % 32;
  const int r0 = m0 + 64 * wg + 16 * warp + lane / 4;
#pragma unroll
  for (int j = 0; j < GP_BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (lane % 4);
    if (r0 < M) store_pair(out, r0, col, N, acc[4 * j], acc[4 * j + 1]);
    if (r0 + 8 < M) store_pair(out, r0 + 8, col, N, acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// Tensor map of a bf16 matrix stored as `outer` lines of `inner` elements,
// `ld` elements apart: a (box_outer, 64) box, 128-byte swizzle, reads past
// the edges filled with zeros.
inline bool encode_lines(const void* ptr, int inner, int outer, int ld, int box_outer,
                         CUtensorMap* out) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {(cuuint32_t)GP_BK, (cuuint32_t)box_outer};
  const cuuint32_t unit[2] = {1, 1};
  return encode(out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool A_MN, bool B_MN>
cudaError_t launch_grad(const void* a, const void* b, void* out, int M, int N, int K,
                        int lda, int ldb, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      grad_product_kernel<A_MN, B_MN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      GP_SMEM);
  if (attr != cudaSuccess) return attr;
  CUtensorMap amap, bmap;
  const bool ok_a = A_MN ? encode_lines(a, M, K, lda, GP_ATOM, &amap)
                         : encode_lines(a, K, M, lda, GP_BM, &amap);
  const bool ok_b = B_MN ? encode_lines(b, N, K, ldb, GP_ATOM, &bmap)
                         : encode_lines(b, K, N, ldb, GP_BN, &bmap);
  if (!ok_a || !ok_b) return cudaErrorInvalidValue;
  dim3 grid((M + GP_BM - 1) / GP_BM, (N + GP_BN - 1) / GP_BN);
  grad_product_kernel<A_MN, B_MN><<<grid, GP_THREADS, GP_SMEM, stream>>>(
      amap, bmap, static_cast<__nv_bfloat16*>(out), M, N, K);
  return cudaGetLastError();
}

}  // namespace
}  // namespace gemm_tile

// out (M, N) bf16, row-major = a (M, K) @ b (K, N), bf16.  a_mn: a is
// M-major (a[m, k] at a + k * lda + m), else K-major (a + m * lda + k);
// b_mn: b is N-major (b[k, n] at b + k * ldb + n), else K-major
// (b + n * ldb + k).  lda and ldb multiples of 8, bases 16-byte aligned
// (the wrapper checks).
extern "C" int repro_gemm_grad(const void* a, const void* b, void* out, int M, int N,
                               int K, int a_mn, int lda, int b_mn, int ldb,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (a_mn && b_mn) {
    e = gemm_tile::launch_grad<true, true>(a, b, out, M, N, K, lda, ldb, s);
  } else if (a_mn) {
    e = gemm_tile::launch_grad<true, false>(a, b, out, M, N, K, lda, ldb, s);
  } else if (b_mn) {
    e = gemm_tile::launch_grad<false, true>(a, b, out, M, N, K, lda, ldb, s);
  } else {
    e = gemm_tile::launch_grad<false, false>(a, b, out, M, N, K, lda, ldb, s);
  }
  return (int)e;
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
