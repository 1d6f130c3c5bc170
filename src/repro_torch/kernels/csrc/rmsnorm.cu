// Fused (residual-add +) RMSNorm, one row per CTA.
//
// Replaces repro/kernels/rmsnorm.py::rmsnorm (_kernel, _kernel_residual):
// with a residual, x = round_to_dtype(f32(x) + f32(res)) first; then
// var = mean(x^2) in f32 and out = x * rsqrt(var + eps) * scale in f32,
// rounded to x's dtype.  Only the normalised row is written, as in the TPU
// kernel.
//
// The sum of squares has one fixed tree that depends on D alone: thread t
// of the NT-thread CTA (a literal) adds x[j]^2 for j = t, t + NT, ... in
// order, each warp folds its 32 partials by an xor butterfly, and warp 0
// adds the NW warp sums in warp order.  A row never meets another row, so
// its bits do not depend on M or on its place in the batch.  Loads are
// scalar and strided by NT, so any D works (no vector-width remainder).
//
// Bound on this card: bytes (one read of x, res and scale, one write of
// the output; a handful of flops per element).  The second pass re-reads
// the row, which L1/L2 serve.
#include "common.cuh"

namespace {

constexpr int NT = 256;  // threads per CTA
constexpr int NW = NT / 32;

template <typename T>
__device__ __forceinline__ float load_x(const T* __restrict__ x,
                                        const T* __restrict__ res, size_t i) {
  if (res == nullptr) return to_f32(x[i]);
  T rounded;
  store_as(&rounded, __fadd_rn(to_f32(x[i]), to_f32(res[i])));
  return to_f32(rounded);
}

template <typename T>
__global__ void __launch_bounds__(NT)
    rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ res,
                   const float* __restrict__ scale, T* __restrict__ out, int D,
                   float eps) {
  __shared__ float warp_sums[NW];
  const size_t row = (size_t)blockIdx.x * D;
  const int t = threadIdx.x, w = t / 32, lane = t % 32;
  float ss = 0.f;
  for (int j = t; j < D; j += NT) {
    const float xv = load_x(x, res, row + j);
    ss = fmaf(xv, xv, ss);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, o));
  if (lane == 0) warp_sums[w] = ss;
  __syncthreads();
  float total = warp_sums[0];
#pragma unroll
  for (int i = 1; i < NW; ++i) total = __fadd_rn(total, warp_sums[i]);
  const float inv = rsqrtf(__fadd_rn(__fdiv_rn(total, (float)D), eps));
  for (int j = t; j < D; j += NT) {
    const float xv = load_x(x, res, row + j);
    store_as(out + row + j, __fmul_rn(__fmul_rn(xv, inv), scale[j]));
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* res, const void* scale,
                   void* out, int M, int D, float eps, cudaStream_t s) {
  rmsnorm_kernel<T><<<M, NT, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(res),
      static_cast<const float*>(scale), static_cast<T*>(out), D, eps);
  return cudaGetLastError();
}

}  // namespace

// res may be null (no residual); scale is f32 (D,).
extern "C" int repro_rmsnorm(const void* x, const void* res, const void* scale,
                             void* out, int M, int D, float eps, int dtype,
                             void* stream) {
  if (M == 0) return 0;
  if (D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16)
    return (int)launch<__nv_bfloat16>(x, res, scale, out, M, D, eps, s);
  return (int)launch<float>(x, res, scale, out, M, D, eps, s);
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
