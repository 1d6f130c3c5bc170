// det: fastpath
// Fast-path GEMM: split-K with the schedule's combine-dtype epilogue.
//
// Replaces: repro/kernels/gemm_splitk.py::gemm_splitk (Pallas _kernel: K cut
// into `splits` chunks, an f32 partial per chunk; when splits > 1 each
// partial is rounded through combine_dtype and folded in split order, the
// running sum re-rounded after every fold).  Chunks follow
// _split_sizes(K, splits), so a K that `splits` does not divide is cut
// unevenly, as repro/core/determinism.py::matmul does on the model path.
//
// Pass 1 (gemm_tile.cuh): one CTA per (M tile, N tile, split) writes that
// split's f32 partial, on the commit GEMM's tiles (tensor cores fed by TMA
// for bf16, CUDA cores for f32): one design to maintain.  Pass 2 (below):
// one thread per output element folds the partials in split order with the
// combine-dtype rounding.  No atomics: the reduction tree is the split count
// and nothing else, which is exactly the batch-dependent schedule the fast
// path is licensed to vary.
//
// Bound on this card: the decode batch is M = 1..8, so the weight read
// (K*N*2 bytes) bounds the call; the splits multiply the CTAs in flight so
// that small-N projections still cover the SMs while each weight byte is
// read once.
#include "gemm_tile.cuh"

namespace {

template <typename T>
__global__ void ordered_fold_kernel(const float* __restrict__ part,
                                    T* __restrict__ out, long long mn,
                                    int splits, int combine) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float acc = part[i];
  if (splits > 1) {
    acc = round_to(acc, combine);
    for (int s = 1; s < splits; ++s) {
      const float p = round_to(part[(long long)s * mn + i], combine);
      acc = round_to(acc + p, combine);
    }
  }
  store_as(out + i, acc);
}

template <typename T>
cudaError_t run(const void* x, const void* w, float* part, void* out, int M,
                int N, int K, int splits, int combine, cudaStream_t stream) {
  cudaError_t e =
      gemm_tile::launch_partials<T>(x, w, part, M, N, K, splits, stream);
  if (e != cudaSuccess) return e;
  const long long mn = (long long)M * N;
  const int threads = 256;
  ordered_fold_kernel<T><<<(unsigned)((mn + threads - 1) / threads), threads,
                           0, stream>>>(part, static_cast<T*>(out), mn, splits,
                                        combine);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_gemm_splitk(const void* x, const void* w, void* part,
                                 void* out, int M, int N, int K, int splits,
                                 int combine, int dtype, void* stream) {
  if (splits < 1 || splits > K) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  cudaError_t e =
      dtype == DT_BF16
          ? run<__nv_bfloat16>(x, w, p, out, M, N, K, splits, combine, s)
          : run<float>(x, w, p, out, M, N, K, splits, combine, s);
  return (int)e;
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
