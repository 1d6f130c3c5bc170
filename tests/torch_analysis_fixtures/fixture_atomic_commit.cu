// SEEDED VIOLATION (do not fix): atomics in a commit kernel.
//
// A GEMV whose K chunks fold into the output with atomicAdd: the order in
// which the chunks' partials meet follows the hardware's scheduling, so a
// row's bits can change from run to run.  The checker must flag
//   * kernel_lint/atomic-in-commit-kernel  (atomicAdd in gemv_atomic_kernel)
#include <cuda_runtime.h>

constexpr int CHUNK = 256;

__global__ void gemv_atomic_kernel(const float* x, const float* w, float* y,
                                   int K, int N) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int k0 = blockIdx.y * CHUNK;
  if (n >= N) return;
  float part = 0.f;
  for (int k = k0; k < k0 + CHUNK && k < K; ++k) part = fmaf(x[k], w[k * N + n], part);
  atomicAdd(&y[n], part);  // VIOLATION: the chunks combine in arrival order
}

extern "C" int launch_gemv_atomic(const float* x, const float* w, float* y,
                                  int K, int N, cudaStream_t s) {
  dim3 grid((N + 127) / 128, (K + CHUNK - 1) / CHUNK);
  gemv_atomic_kernel<<<grid, 128, 0, s>>>(x, w, y, K, N);
  return (int)cudaGetLastError();
}
