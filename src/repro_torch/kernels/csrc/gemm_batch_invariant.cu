// Commit-path GEMM: the batch-invariant universal schedule.
//
// Replaces: repro/kernels/gemm_batch_invariant.py::gemm_batch_invariant
// (Pallas _kernel: fixed 128x128x512 tiles, one f32 accumulator walked over
// K in a fixed order, no split-K).  Under VERIFY_SCHEDULE the JAX model
// reduces K as CANONICAL_TP_SHARDS (4) contiguous chunks, each one f32
// pass, combined as ((p0+p1)+(p2+p3))  (repro/core/determinism.py,
// _tp_partials + tree_combine).  This kernel computes exactly that
// function for any chunk count: `chunks` = 1 is the Pallas kernel,
// `chunks` = 4 the commit path.
//
// Pass 1 (gemm_tile.cuh): one CTA per (M tile, N tile, chunk) writes the
// chunk's f32 partial.  bf16 operands run on the tensor cores (wgmma fed by
// a TMA ring, batch padded to the instruction's literal N = 32); f32
// operands on the CUDA cores (one fmaf chain per element).  Either way each
// output element's chunk sum is one f32 accumulator walked over the chunk in
// a fixed order, with one instruction path per dtype for every M, so a row's
// bits do not depend on M or on the other rows.
// Pass 2 (below): the balanced-tree combine in f32, in tree_combine's
// association, then one rounding to the output dtype.
//
// Bound on this card: at the verify/decode batch (M <= 32) the weight read
// (K*N*2 bytes in bf16) bounds the call.  The tensor-core tile keeps six
// 8 KB weight tiles in flight per CTA and several CTAs per SM, and the K
// chunks multiply the CTAs so that a narrow projection still spreads over
// the SMs.  The chunk count is the fixed canonical tree, never a function of
// M: this is not split-K.
#include "gemm_tile.cuh"

namespace {

constexpr int MAX_CHUNKS = 8;

template <typename T>
__global__ void tree_combine_kernel(const float* __restrict__ part,
                                    T* __restrict__ out, long long mn,
                                    int chunks) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float v[MAX_CHUNKS];
  for (int c = 0; c < chunks; ++c) v[c] = part[(long long)c * mn + i];
  // tree_combine: pairwise sums of neighbours, an odd last element carried
  int n = chunks;
  while (n > 1) {
    int h = 0;
    for (int j = 0; j + 1 < n; j += 2) v[h++] = v[j] + v[j + 1];
    if (n % 2) v[h++] = v[n - 1];
    n = h;
  }
  store_as(out + i, v[0]);
}

template <typename T>
cudaError_t run(const void* x, const void* w, float* part, void* out, int M,
                int N, int K, int chunks, cudaStream_t stream) {
  cudaError_t e =
      gemm_tile::launch_partials<T>(x, w, part, M, N, K, chunks, stream);
  if (e != cudaSuccess) return e;
  const long long mn = (long long)M * N;
  const int threads = 256;
  tree_combine_kernel<T><<<(unsigned)((mn + threads - 1) / threads), threads,
                           0, stream>>>(part, static_cast<T*>(out), mn,
                                        chunks);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_gemm_batch_invariant(const void* x, const void* w,
                                          void* part, void* out, int M, int N,
                                          int K, int chunks, int dtype,
                                          void* stream) {
  if (chunks < 1 || chunks > MAX_CHUNKS) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  cudaError_t e = dtype == DT_BF16
                      ? run<__nv_bfloat16>(x, w, p, out, M, N, K, chunks, s)
                      : run<float>(x, w, p, out, M, N, K, chunks, s);
  return (int)e;
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
