// SEEDED VIOLATION (do not fix): a launcher that picks the tile by M.
//
// Small batches get a 16-row tile with a finer K step, large ones a 64-row
// tile: the K reduction's chunking, and with it every row's bits, changes
// with how many requests are co-scheduled.  The checker must flag
//   * kernel_lint/adaptive-block-size  (the if on M in launch_gemm_adaptive)
#include <cuda_runtime.h>

template <int BM, int BK>
__global__ void gemm_tile_kernel(const float* x, const float* w, float* y,
                                 int M, int N, int K) {
  const int m = blockIdx.y * BM + threadIdx.y;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M || n >= N) return;
  float acc = 0.f;
  for (int k0 = 0; k0 < K; k0 += BK)
    for (int k = k0; k < k0 + BK && k < K; ++k) acc = fmaf(x[m * K + k], w[k * N + n], acc);
  y[m * N + n] = acc;
}

extern "C" int launch_gemm_adaptive(const float* x, const float* w, float* y,
                                    int M, int N, int K, cudaStream_t s) {
  if (M <= 16) {  // VIOLATION: the tile and the K step follow the batch
    gemm_tile_kernel<16, 64><<<dim3(N / 32, (M + 15) / 16), dim3(32, 16), 0, s>>>(
        x, w, y, M, N, K);
  } else {
    gemm_tile_kernel<64, 256><<<dim3(N / 32, (M + 63) / 64), dim3(32, 16), 0, s>>>(
        x, w, y, M, N, K);
  }
  return (int)cudaGetLastError();
}
