// Fused (residual-add +) RMSNorm.
//
// Replaces repro/kernels/rmsnorm.py::rmsnorm (_kernel, _kernel_residual):
// with a residual, x = round_to_dtype(f32(x) + f32(res)) first; then
// var = mean(x^2) in f32 and out = x * rsqrt(var + eps) * scale in f32,
// rounded to x's dtype.  Only the normalised row is written, as in the TPU
// kernel.  scale is read in its own dtype (bf16 or f32; the conversion to
// f32 is exact), so a call is this one launch.
//
// Bound on this card: bytes (one read of x, res and scale, one write of
// the output; a handful of flops per element).  So the design is about
// bytes in flight and reading each byte once:
//
// * A row is read once, in 16-byte vectors (8 bf16 or 4 f32 elements), and
//   kept in registers between its sum of squares and its output, packed as
//   it came (two bf16 a 32-bit register): lane l of a warp holds vectors
//   l, l + 32, ... of the warp's segment of the row, so a warp's loads are
//   512 contiguous bytes.  A vector that D cuts (and rows that are not
//   16-byte aligned) are read element by element.
// * Work per CTA, from D and the literals below only, never from M: a
//   lane holds the fewest vectors (VPT, a power of two up to RN_MAX_VPT)
//   that let a row fit one CTA of RN_WARPS warps; a row takes nseg warps
//   (a power of two).  Rows of nseg < RN_WARPS warps share a CTA; a row
//   too wide for one CTA at RN_MAX_VPT vectors a lane spans a thread-block
//   cluster of nseg / RN_WARPS CTAs, whose warps exchange their sums
//   through distributed shared memory.  At D = 4096 bf16: VPT 4,
//   one 128-thread CTA a row with all 8 KB of it in flight, and 8 CTAs an
//   SM (64 registers a thread): 64 KB an SM for a large batch.  A 2-CTA
//   cluster a row at this width filled twice the SMs at 32 rows and was
//   0.0006 ms faster there, but an SM then held half the bytes in flight
//   and 16384 rows took 39 % longer (PERF.md).
//
// The sum of squares has one literal tree that depends on D alone (and the
// dtype): each lane adds x[j]^2 (fmaf) over its vectors in order, element
// by element; each warp folds its 32 lane sums by an xor butterfly; the
// row's nseg warp sums are added in segment order.  Elements past D (and
// whole segments past it) add +0, which changes no bit.  A row never meets
// another row, so its bits do not depend on M, on its place in the batch,
// or on how its segments are spread over CTAs.
#include "common.cuh"

#include <cooperative_groups.h>

namespace {

namespace cg = cooperative_groups;

constexpr int RN_WARPS = 4;        // warps per CTA
constexpr int RN_MAX_VPT = 8;      // vectors a lane holds, at most
constexpr int RN_MAX_CLUSTER = 8;  // CTAs a row spans, at most
constexpr int RN_SM_CTAS = 8;      // CTAs an SM holds (64 registers a thread), up to 4 vectors a lane

// How a row of D elements of `elt` bytes is cut: vectors per lane, warps
// per row (segments), CTAs per row.  D alone decides it.
struct Plan {
  int vpt, nseg, cl;
};

Plan plan(int D, int elt) {
  const int V = 16 / elt, nvec = (D + V - 1) / V;
  int vpt = 1;
  while (vpt < RN_MAX_VPT && nvec > 32 * vpt * RN_WARPS) vpt *= 2;
  int nseg = 1;
  while (nseg * 32 * vpt < nvec) nseg *= 2;
  return {vpt, nseg, nseg > RN_WARPS ? nseg / RN_WARPS : 1};
}

// N elements of U in registers, packed as 32-bit words (bf16 pairs, low
// half first, or f32 bits): half the registers of f32 values for bf16.
template <typename U, int N>
struct Packed {
  static constexpr int W = (N * (int)sizeof(U) + 3) / 4;
  unsigned w[W];
  __device__ __forceinline__ float get(int e) const {
    if constexpr (sizeof(U) == 2) return (e & 1) ? bf16_hi(w[e >> 1]) : bf16_lo(w[e >> 1]);
    else return __uint_as_float(w[e]);
  }
  // v rounded to U
  __device__ __forceinline__ void set(int e, float v) {
    if constexpr (sizeof(U) == 2) {
      const unsigned h = __bfloat16_as_ushort(__float2bfloat16_rn(v));
      w[e >> 1] = (e & 1) ? (w[e >> 1] & 0xffffu) | (h << 16) : (w[e >> 1] & 0xffff0000u) | h;
    } else {
      w[e] = __float_as_uint(v);
    }
  }
  // all N from an address aligned to N * sizeof(U), in 16- or 8-byte loads
  __device__ __forceinline__ void load(const U* p) {
    if constexpr (W % 4 == 0) {
#pragma unroll
      for (int k = 0; k < W / 4; ++k) {
        const uint4 t = reinterpret_cast<const uint4*>(p)[k];
        w[4 * k] = t.x;
        w[4 * k + 1] = t.y;
        w[4 * k + 2] = t.z;
        w[4 * k + 3] = t.w;
      }
    } else {
      static_assert(W == 2, "8-byte vectors are 4 bf16");
      const uint2 t = *reinterpret_cast<const uint2*>(p);
      w[0] = t.x;
      w[1] = t.y;
    }
  }
  // elements e < n one by one, 0 past them
  __device__ __forceinline__ void load(const U* p, int n) {
#pragma unroll
    for (int i = 0; i < W; ++i) w[i] = 0u;
#pragma unroll
    for (int e = 0; e < N; ++e)
      if (e < n) set(e, to_f32(p[e]));
  }
};

// V consecutive f32 values stored to p as T (16 bytes)
template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float* f) {
  if constexpr (sizeof(T) == 2) {
    auto pack = [&](int i) {  // elements 2i (low half) and 2i + 1
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      return *reinterpret_cast<const unsigned*>(&h);
    };
    *reinterpret_cast<uint4*>(p) = make_uint4(pack(0), pack(1), pack(2), pack(3));
  } else {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
}

// One CTA of RN_WARPS warps: a cluster of `cl` CTAs per row (cl > 1), or
// RN_WARPS / nseg rows (cl == 1).  vec: every row and scale base is
// 16-byte aligned, so whole vectors load and store in one instruction.
template <typename T, typename S, int VPT>
__global__ void __launch_bounds__(32 * RN_WARPS, VPT > 4 ? RN_SM_CTAS / 2 : RN_SM_CTAS)
    rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ res,
                   const S* __restrict__ scale, T* __restrict__ out, int M, int D,
                   int nseg, int cl, float eps, bool vec) {
  constexpr int V = 16 / (int)sizeof(T);  // elements per vector
  __shared__ float seg_sum[RN_MAX_CLUSTER * RN_WARPS];
  if (cl > 1) cluster_arrive();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int row, seg, first;  // the warp's row, its segment, seg_sum index of segment 0
  if (cl > 1) {
    row = blockIdx.x / cl;
    seg = (blockIdx.x % cl) * RN_WARPS + warp;
    first = 0;
  } else {
    row = blockIdx.x * (RN_WARPS / nseg) + warp / nseg;
    seg = warp % nseg;
    first = warp - seg;
  }
  const bool live = row < M;
  const size_t r0 = (size_t)row * D;

  Packed<T, V> xp[VPT];  // the row's vectors of this lane (x + res, rounded)
  Packed<S, V> sp[VPT];  // the scale's
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int j0 = ((seg * VPT + k) * 32 + lane) * V;  // the vector's first element
    Packed<T, V> rp;
    if (live && vec && j0 + V <= D) {
      xp[k].load(x + r0 + j0);
      sp[k].load(scale + j0);
      if (res != nullptr) rp.load(res + r0 + j0);
    } else {
      const int n = live ? min(V, D - j0) : 0;
      xp[k].load(x + r0 + j0, n);
      sp[k].load(scale + j0, n);
      if (res != nullptr) rp.load(res + r0 + j0, n);
    }
    if (res != nullptr) {
#pragma unroll
      for (int e = 0; e < V; ++e) xp[k].set(e, __fadd_rn(xp[k].get(e), rp.get(e)));
    }
  }

  // the tree: lane (vectors, elements in order), warp (xor butterfly), row
  // (segments in order)
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < VPT; ++k)
#pragma unroll
    for (int e = 0; e < V; ++e) ss = fmaf(xp[k].get(e), xp[k].get(e), ss);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, o));
  if (cl > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster_wait();  // every CTA of the cluster has started
    if (lane < cl) cluster.map_shared_rank(seg_sum, lane)[seg] = ss;
    cluster.sync();  // every segment's sum is in every CTA; none is written after
  } else {
    if (lane == 0) seg_sum[warp] = ss;
    __syncthreads();
  }
  float total = 0.f;
  for (int i = 0; i < nseg; ++i) total = __fadd_rn(total, seg_sum[first + i]);
  const float inv = rsqrtf(__fadd_rn(__fdiv_rn(total, (float)D), eps));

  if (!live) return;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int j0 = ((seg * VPT + k) * 32 + lane) * V;
    float of[V];
#pragma unroll
    for (int e = 0; e < V; ++e) of[e] = __fmul_rn(__fmul_rn(xp[k].get(e), inv), sp[k].get(e));
    if (vec && j0 + V <= D) {
      store_vec<T, V>(out + r0 + j0, of);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (j0 + e < D) store_as(out + r0 + j0 + e, of[e]);
    }
  }
}

template <typename T, typename S, int VPT>
cudaError_t launch_vpt(const void* x, const void* res, const void* scale, void* out,
                       int M, int D, const Plan& p, float eps, bool vec,
                       cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cl > 1 ? M * p.cl : (M + RN_WARPS / p.nseg - 1) / (RN_WARPS / p.nseg));
  cfg.blockDim = dim3(32 * RN_WARPS);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.cl > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, rmsnorm_kernel<T, S, VPT>, static_cast<const T*>(x),
                            static_cast<const T*>(res), static_cast<const S*>(scale),
                            static_cast<T*>(out), M, D, p.nseg, p.cl, eps, vec);
}

template <typename T, typename S>
cudaError_t launch(const void* x, const void* res, const void* scale, void* out,
                   int M, int D, float eps, cudaStream_t s) {
  const Plan p = plan(D, (int)sizeof(T));
  if (p.cl > RN_MAX_CLUSTER || (long long)M * p.cl > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto aligned = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; };
  const bool vec = (size_t)D * sizeof(T) % 16 == 0 && aligned(x) && aligned(out) &&
                   aligned(scale) && (res == nullptr || aligned(res));
  switch (p.vpt) {
    case 1: return launch_vpt<T, S, 1>(x, res, scale, out, M, D, p, eps, vec, s);
    case 2: return launch_vpt<T, S, 2>(x, res, scale, out, M, D, p, eps, vec, s);
    case 4: return launch_vpt<T, S, 4>(x, res, scale, out, M, D, p, eps, vec, s);
    default: return launch_vpt<T, S, RN_MAX_VPT>(x, res, scale, out, M, D, p, eps, vec, s);
  }
}

}  // namespace

// res may be null (no residual); scale (D,) is in scale_dtype, x, res and
// out in dtype (bf16 or f32 each).
extern "C" int repro_rmsnorm(const void* x, const void* res, const void* scale,
                             void* out, int M, int D, float eps, int dtype,
                             int scale_dtype, void* stream) {
  if (M < 0 || D < 1) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16) {
    if (scale_dtype == DT_BF16)
      return (int)launch<__nv_bfloat16, __nv_bfloat16>(x, res, scale, out, M, D, eps, s);
    return (int)launch<__nv_bfloat16, float>(x, res, scale, out, M, D, eps, s);
  }
  if (scale_dtype == DT_BF16)
    return (int)launch<float, __nv_bfloat16>(x, res, scale, out, M, D, eps, s);
  return (int)launch<float, float>(x, res, scale, out, M, D, eps, s);
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
