// Shared helpers for the port's Hopper kernels (sm_90a).
//
// Every kernel here is launched through a plain C function that returns
// cudaGetLastError() as an int; the Python wrappers (ctypes) raise when it
// is not 0.  Kernels allocate nothing: outputs and scratch come from the
// wrapper (torch.empty), and every launch goes to the caller's stream.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes, shared with repro_torch/kernels/build.py
enum { DT_F32 = 0, DT_BF16 = 1, DT_F16 = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Round an f32 value through a narrower dtype and back (round to nearest
// even), the combine-dtype rounding of the split schedules.
__device__ __forceinline__ float round_to(float v, int code) {
  if (code == DT_BF16) return __bfloat162float(__float2bfloat16_rn(v));
  if (code == DT_F16) return __half2float(__float2half_rn(v));
  return v;
}
