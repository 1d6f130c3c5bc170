// K-chunk partial GEMM tile, shared by the commit GEMM
// (gemm_batch_invariant.cu) and the fast split-K GEMM (gemm_splitk.cu).
//
// One CTA computes the f32 partial  P[c] = x[:, kb:ke] @ w[kb:ke, :]  of one
// (BM x BN) output tile over one contiguous K chunk c, where [kb, ke) is
// chunk c of _split_sizes(K, chunks): near-equal chunks, the remainder
// spread over the leading ones.  The chunk's partial goes to an f32
// workspace; the caller's second pass combines the chunks in the order its
// schedule prescribes.
//
// Reduction order (what makes a row's result independent of M): every
// output element is ONE f32 fmaf chain over k = kb, kb+1, ..., ke-1, in that
// order.  Tile sizes are literals, nothing is keyed on M, there are no
// atomics, and the K walk never pads (the last K step stops at ke), so a
// row's bits depend only on its own x row, on w and on the chunk bounds.
//
// Design for this card: operands are read in their own dtype (bf16 or f32)
// with 16-byte loads and converted to f32 in registers on the way into
// shared memory, so no f32 copy of a weight ever exists in device memory.
// The next K step's tile is loaded into registers while the current one is
// multiplied (one tile in flight per CTA besides the one in use).  The
// products run on the CUDA cores (fmaf), not the tensor cores: at the
// decode and verify batch (M <= 32) the weight read bounds the call, and
// this keeps the accumulation an explicit sequential chain.  wgmma/TMA are
// later work.
#pragma once

#include "common.cuh"

namespace gemm_tile {

constexpr int BM = 32;       // rows of x per CTA (literal)
constexpr int BN = 128;      // columns of w per CTA (literal)
constexpr int BK = 64;       // K step through shared memory (literal)
constexpr int THREADS = 256; // 8 warps: warp w owns tile rows 4w..4w+3,
                             // lane l owns tile columns 4l..4l+3

template <typename T>
__global__ void __launch_bounds__(THREADS)
chunk_partial_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     float* __restrict__ part, int M, int N, int K,
                     int chunks) {
  constexpr int VEC = 16 / sizeof(T);             // elements per 16-byte load
  constexpr int VPR = BN / VEC;                   // 16-byte vectors per w row
  constexpr int W_VECS = BK * BN / VEC / THREADS; // w vectors per thread
  constexpr int X_ELTS = BM * BK / THREADS;       // x elements per thread

  __shared__ __align__(16) float ws[BK][BN];
  __shared__ float xs[BK][BM + 1];  // +1: conflict-free transposed stores

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int c = blockIdx.z;
  const int base = K / chunks, rem = K % chunks;
  const int kb = c * base + min(c, rem);
  const int ke = kb + base + (c < rem ? 1 : 0);

  const int tid = threadIdx.x;
  const int r0 = (tid / 32) * 4;
  const int c0 = (tid % 32) * 4;
  const bool active = m0 + r0 < M;  // warp-uniform: rows past M do no work

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  uint4 wreg[W_VECS];
  float xreg[X_ELTS];

  auto load_tile = [&](int k0) {
#pragma unroll
    for (int i = 0; i < W_VECS; ++i) {
      const int v = tid + i * THREADS;
      const int k = k0 + v / VPR, n = n0 + (v % VPR) * VEC;
      wreg[i] = (k < ke && n < N)
                    ? *reinterpret_cast<const uint4*>(w + (size_t)k * N + n)
                    : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < X_ELTS; ++i) {
      const int e = tid + i * THREADS;
      const int m = m0 + e / BK, k = k0 + e % BK;
      xreg[i] = (m < M && k < ke) ? to_f32(x[(size_t)m * K + k]) : 0.f;
    }
  };

  auto store_tile = [&]() {
#pragma unroll
    for (int i = 0; i < W_VECS; ++i) {
      const int v = tid + i * THREADS;
      const T* src = reinterpret_cast<const T*>(&wreg[i]);
      float* dst = &ws[v / VPR][(v % VPR) * VEC];
#pragma unroll
      for (int j = 0; j < VEC; j += 4) {
        *reinterpret_cast<float4*>(dst + j) =
            make_float4(to_f32(src[j]), to_f32(src[j + 1]),
                        to_f32(src[j + 2]), to_f32(src[j + 3]));
      }
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

// Launch the partial pass: grid (N tiles, M tiles, chunks).
template <typename T>
inline cudaError_t launch_partials(const void* x, const void* w, float* part,
                                   int M, int N, int K, int chunks,
                                   cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, chunks);
  chunk_partial_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), part, M, N, K,
      chunks);
  return cudaGetLastError();
}

}  // namespace gemm_tile
