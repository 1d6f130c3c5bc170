// det: fastpath
// Fast-path GEMM: split-K under a tensor-parallel fold, with the schedule's
// combine-dtype epilogue.
//
// Replaces: repro/kernels/gemm_splitk.py::gemm_splitk (Pallas _kernel: K cut
// into `splits` chunks, an f32 partial per chunk; when splits > 1 each
// partial is rounded through combine_dtype and folded in split order, the
// running sum re-rounded after every fold), and the tensor-parallel branch
// of repro/core/determinism.py::matmul on the model path (_tp_partials over
// _reduce_k_f32): K cut into `tp` chunks (_split_sizes), each reduced under
// the local split schedule above to one f32 value per element; un-pinned,
// the chunk values are rounded through combine_dtype and folded in chunk
// order, the running sum re-rounded after every fold (a ring all-reduce
// whose order follows the mesh width); pinned, they combine by
// tree_combine's balanced f32 tree.  tp = 1 is the plain split-K GEMM.
// Chunks follow _split_sizes at both levels, so a K that does not divide
// evenly is cut unevenly, as the model path cuts it.
//
// Pass 1 (gemm_tile.cuh): one CTA per (M tile, N tile, TP chunk, split)
// writes that sub-chunk's f32 partial over nested_bounds, on the commit
// GEMM's tiles (tensor cores fed by TMA for bf16, CUDA cores for f32): one
// design to maintain.  Pass 2 (below): one thread per output element folds
// the splits within each TP chunk, then the TP chunks, with the
// reference's rounding points.
//
// The partials entry (repro_gemm_splitk_partials) runs pass 1 and then
// only the first level of pass 2: one f32 value per TP chunk, after that
// chunk's split fold and before the cross-chunk fold.  It is a rank's share
// of repro/distributed/sharding.py::tp_matmul (each device reduces its
// canonical K chunks under the schedule's splits and combine_dtype, the
// cross-chunk combine happening across ranks), on the operands' own dtype:
// the chunk values are the ones pass 2 folds in the logical GEMM, bit for
// bit.  No atomics: the reduction tree is the split
// count and the TP width and nothing else, which is exactly the
// batch- and mesh-dependent schedule the fast path is licensed to vary.
//
// Bound on this card: the decode batch is M = 1..8, so the weight read
// (K*N*2 bytes) bounds the call; the splits and TP chunks multiply the CTAs
// in flight so that small-N projections still cover the SMs while each
// weight byte is read once.  The workspace holds tp * splits f32 partials.
#include "gemm_tile.cuh"

namespace {

constexpr int MAX_TP = 16;  // TP chunks a pinned fold keeps in registers

// TP chunk t's value at element i under the local split schedule
// (_reduce_k_f32): its splits' partials rounded through combine_dtype and
// folded in split order, the running sum re-rounded after every fold; one
// f32 pass when the chunk is narrower than `splits`
__device__ __forceinline__ float chunk_value(const float* __restrict__ part,
                                             long long mn, long long i, int K,
                                             int tp, int splits, int t,
                                             int combine) {
  int ob, oe;
  gemm_tile::chunk_bounds(K, tp, t, &ob, &oe);
  const int local = splits <= oe - ob ? splits : 1;
  const float* p = part + (long long)t * splits * mn + i;
  float v = p[0];
  if (local > 1) {
    v = round_to(v, combine);
    for (int s = 1; s < local; ++s)
      v = round_to(v + round_to(p[(long long)s * mn], combine), combine);
  }
  return v;
}

template <typename T>
__global__ void tp_fold_kernel(const float* __restrict__ part,
                               T* __restrict__ out, long long mn, int K,
                               int tp, int splits, int pinned, int combine) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float tree[MAX_TP];
  float acc = 0.f;
  for (int t = 0; t < tp; ++t) {
    const float v = chunk_value(part, mn, i, K, tp, splits, t, combine);
    if (tp == 1) {
      acc = v;
    } else if (pinned) {
      tree[t] = v;
    } else {
      const float r = round_to(v, combine);
      acc = t == 0 ? r : round_to(acc + r, combine);
    }
  }
  if (tp > 1 && pinned) {
    // tree_combine: pairwise sums of neighbours, an odd last element carried
    int n = tp;
    while (n > 1) {
      int h = 0;
      for (int j = 0; j + 1 < n; j += 2) tree[h++] = tree[j] + tree[j + 1];
      if (n % 2) tree[h++] = tree[n - 1];
      n = h;
    }
    acc = tree[0];
  }
  store_as(out + i, acc);
}

// the partials entry's pass 2: vals[t] = chunk t's value, (tp, M, N) f32
__global__ void chunk_values_kernel(const float* __restrict__ part,
                                    float* __restrict__ vals, long long mn,
                                    int K, int tp, int splits, int combine) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  for (int t = 0; t < tp; ++t)
    vals[(long long)t * mn + i] =
        chunk_value(part, mn, i, K, tp, splits, t, combine);
}

template <typename T>
cudaError_t run(const void* x, const void* w, float* part, void* out, int M,
                int N, int K, int tp, int splits, int pinned, int combine,
                cudaStream_t stream) {
  cudaError_t e = gemm_tile::launch_partials<T>(x, w, part, M, N, K, tp,
                                                splits, stream);
  if (e != cudaSuccess) return e;
  const long long mn = (long long)M * N;
  const int threads = 256;
  tp_fold_kernel<T><<<(unsigned)((mn + threads - 1) / threads), threads, 0,
                      stream>>>(part, static_cast<T*>(out), mn, K, tp, splits,
                                pinned, combine);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_partials(const void* x, const void* w, float* part,
                         float* vals, int M, int N, int K, int tp, int splits,
                         int combine, cudaStream_t stream) {
  cudaError_t e = gemm_tile::launch_partials<T>(x, w, part, M, N, K, tp,
                                                splits, stream);
  if (e != cudaSuccess) return e;
  const long long mn = (long long)M * N;
  const int threads = 256;
  chunk_values_kernel<<<(unsigned)((mn + threads - 1) / threads), threads, 0,
                        stream>>>(part, vals, mn, K, tp, splits, combine);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_gemm_splitk(const void* x, const void* w, void* part,
                                 void* out, int M, int N, int K, int tp,
                                 int splits, int pinned, int combine,
                                 int dtype, void* stream) {
  if (tp < 1 || tp > MAX_TP || tp > K || splits < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  cudaError_t e =
      dtype == DT_BF16
          ? run<__nv_bfloat16>(x, w, p, out, M, N, K, tp, splits, pinned,
                               combine, s)
          : run<float>(x, w, p, out, M, N, K, tp, splits, pinned, combine, s);
  return (int)e;
}

extern "C" int repro_gemm_splitk_partials(const void* x, const void* w,
                                          void* part, void* vals, int M,
                                          int N, int K, int tp, int splits,
                                          int combine, int dtype,
                                          void* stream) {
  if (tp < 1 || tp > K || splits < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  float* v = static_cast<float*>(vals);
  cudaError_t e =
      dtype == DT_BF16
          ? run_partials<__nv_bfloat16>(x, w, p, v, M, N, K, tp, splits,
                                        combine, s)
          : run_partials<float>(x, w, p, v, M, N, K, tp, splits, combine, s);
  return (int)e;
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
