// SEEDED VIOLATION (do not fix): a bf16 accumulator in a reduction kernel.
//
// A row sum whose running total is __nv_bfloat16: every partial rounds to
// 8 significant bits between adds, so the result depends on the fold
// order.  The contract's combine dtype is f32.  The checker must flag
//   * kernel_lint/accum-dtype  (acc in row_sum_kernel)
#include <cuda_bf16.h>

constexpr int THREADS = 128;

__global__ void row_sum_kernel(const __nv_bfloat16* x, __nv_bfloat16* out, int D) {
  const __nv_bfloat16* row = x + (size_t)blockIdx.x * D;
  __nv_bfloat16 acc = __float2bfloat16(0.f);  // VIOLATION: narrower than float
  for (int d = threadIdx.x; d < D; d += THREADS) acc += row[d];
  if (threadIdx.x == 0) out[blockIdx.x] = acc;
}
