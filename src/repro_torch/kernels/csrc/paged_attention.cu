// Paged decode attention: K/V read in place through the block table.
//
// Two kernels, after repro/kernels/paged_attention.py:
//
// * paged_attention (commit path) replaces paged_attention / _paged_kernel
//   (+ _gather_view): one f32 softmax per (row, query head) over the row's
//   table reach, keys masked unless 0 <= pos <= q_pos, max clamped at
//   -1e30, denominator at 1e-30, f32 output.  One CTA per (row, KV head);
//   warp g of the CTA serves query head h*G + g.  The walk is literal and
//   fixed: table entries in order, keys of a block in order, an online
//   softmax per key.  The TPU kernel instead assembles the whole view and
//   takes one softmax; both compute the same function, and this one is
//   held to the plain version by tolerance and to itself bitwise.  Nothing
//   depends on B (rows never interact), there is no split and no atomic.
//
// * paged_attention_fast (`# det: fastpath`) replaces paged_attention_fast
//   / _paged_fast_kernel: the table reach is cut into kv_splits equal runs
//   of blocks.  One CTA per (row, KV head, split) keeps the TPU kernel's
//   rounding points: the split max m_c first, then e = exp(s - m_c) rounded
//   to combine_dtype BEFORE it is summed (d_c, accumulated in f32) and
//   multiplied into V (o_c, f32).  A second kernel merges the splits in f32
//   in split order, as the TPU kernel's VMEM scratch does.
//
// Bound on this card: bytes.  Decode reads every valid key and value once
// per (row, KV head) and does 4*D flops per key and query head, far below
// the H100's flop/byte balance.  The design reads each block's K/V rows
// once per CTA (the G query-head warps of a CTA hit the same lines, which
// L1 serves), skips table entries that point at the null block (all of its
// positions are -1, so skipping them changes no bit), and loads its own
// block ids from the table.  A split gives a long context more CTAs.
//
// Contract on shapes (the wrapper checks them): D % 32 == 0, D <= 256,
// G = H / KV <= 32; q and the pools share one dtype (bf16 or f32).
#include "common.cuh"

namespace {

// E = D / 32 elements per lane is a template parameter (1..8, D <= 256),
// so the per-lane q, V accumulator arrays stay in registers.

struct PagedArgs {
  const int* pos;   // (NB, bs) absolute positions, -1 = empty
  const int* tab;   // (B, nblk) block ids, -1 = unallocated
  const int* qpos;  // (B,)
  int H, KV, D, bs, nblk;
  float scale;
};

template <int E, typename T>
__device__ __forceinline__ float dot_row(const float* qv, const T* k) {
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) s = fmaf(qv[e], to_f32(k[e]), s);
  // xor butterfly: every lane ends with the same bits (f32 + commutes)
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

template <int E, typename T>
__device__ __forceinline__ void load_q(const T* q, const PagedArgs& a, int b,
                                       int qh, int lane, float* qv) {
  const T* src = q + ((size_t)b * a.H + qh) * a.D + lane * E;
#pragma unroll
  for (int e = 0; e < E; ++e) qv[e] = to_f32(src[e]) * a.scale;
}

template <typename T, int E>
__global__ void paged_attention_kernel(const T* __restrict__ q,
                                       const T* __restrict__ kp,
                                       const T* __restrict__ vp,
                                       PagedArgs a, float* __restrict__ out) {
  const int b = blockIdx.x, h = blockIdx.y;
  const int G = a.H / a.KV;
  const int g = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qh = h * G + g;
  float qv[E], acc[E];
  load_q<E>(q, a, b, qh, lane, qv);
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  float m = -1e30f, l = 0.f;
  const int qp = a.qpos[b];
  for (int t = 0; t < a.nblk; ++t) {
    const int bid = a.tab[(size_t)b * a.nblk + t];
    if (bid < 0) continue;  // null block: every position masked
    for (int j = 0; j < a.bs; ++j) {
      const int p = a.pos[(size_t)bid * a.bs + j];
      if (p < 0 || p > qp) continue;  // masked key: contributes exactly 0
      const size_t off = (((size_t)bid * a.bs + j) * a.KV + h) * a.D + lane * E;
      const float s = dot_row<E>(qv, kp + off);
      const float m_new = fmaxf(m, s);
      const float alpha = expf(m - m_new);
      const float pj = expf(s - m_new);
      l = l * alpha + pj;
    #pragma unroll
      for (int e = 0; e < E; ++e)
        acc[e] = fmaf(pj, to_f32(vp[off + e]), acc[e] * alpha);
      m = m_new;
    }
  }
  const float denom = fmaxf(l, 1e-30f);
  float* dst = out + ((size_t)b * a.H + qh) * a.D + lane * E;
#pragma unroll
  for (int e = 0; e < E; ++e) dst[e] = acc[e] / denom;
}

// det: fastpath
template <typename T, int E>
__global__ void paged_split_kernel(const T* __restrict__ q,
                                   const T* __restrict__ kp,
                                   const T* __restrict__ vp, PagedArgs a,
                                   int combine, float* __restrict__ m_part,
                                   float* __restrict__ d_part,
                                   float* __restrict__ o_part) {
  const int b = blockIdx.x, h = blockIdx.y, sp = blockIdx.z;
  const int splits = gridDim.z;
  const int G = a.H / a.KV;
  const int g = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qh = h * G + g;
  float qv[E], o[E];
  load_q<E>(q, a, b, qh, lane, qv);
  const int qp = a.qpos[b];
  const int per = a.nblk / splits;
  const int t0 = sp * per, t1 = t0 + per;

  // pass 1: the split's max score (clamped at -1e30)
  float m_c = -1e30f;
  for (int t = t0; t < t1; ++t) {
    const int bid = a.tab[(size_t)b * a.nblk + t];
    if (bid < 0) continue;
    for (int j = 0; j < a.bs; ++j) {
      const int p = a.pos[(size_t)bid * a.bs + j];
      if (p < 0 || p > qp) continue;
      const size_t off = (((size_t)bid * a.bs + j) * a.KV + h) * a.D + lane * E;
      m_c = fmaxf(m_c, dot_row<E>(qv, kp + off));
    }
  }
  // pass 2: e rounded to combine_dtype before the sum and the V product
  float d_c = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) o[e] = 0.f;
  for (int t = t0; t < t1; ++t) {
    const int bid = a.tab[(size_t)b * a.nblk + t];
    if (bid < 0) continue;
    for (int j = 0; j < a.bs; ++j) {
      const int p = a.pos[(size_t)bid * a.bs + j];
      if (p < 0 || p > qp) continue;
      const size_t off = (((size_t)bid * a.bs + j) * a.KV + h) * a.D + lane * E;
      const float ex = round_to(expf(dot_row<E>(qv, kp + off) - m_c), combine);
      d_c += ex;
    #pragma unroll
      for (int e = 0; e < E; ++e) o[e] = fmaf(ex, to_f32(vp[off + e]), o[e]);
    }
  }
  // workspace layout: (B, KV, splits, G[, D])
  const size_t row = (((size_t)b * a.KV + h) * splits + sp) * G + g;
  if (lane == 0) {
    m_part[row] = m_c;
    d_part[row] = d_c;
  }
#pragma unroll
  for (int e = 0; e < E; ++e) o_part[row * a.D + lane * E + e] = o[e];
}

// det: fastpath
template <int E>
__global__ void paged_merge_kernel(const float* __restrict__ m_part,
                                   const float* __restrict__ d_part,
                                   const float* __restrict__ o_part, int H,
                                   int KV, int D, int splits,
                                   float* __restrict__ out) {
  const int b = blockIdx.x, h = blockIdx.y;
  const int G = H / KV;
  const int g = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t row0 = (((size_t)b * KV + h) * splits) * G + g;
  float m = m_part[row0], d = d_part[row0], acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = o_part[row0 * D + lane * E + e];
  for (int sp = 1; sp < splits; ++sp) {
    const size_t row = row0 + (size_t)sp * G;
    const float m_c = m_part[row];
    const float m_new = fmaxf(m, m_c);
    const float a_prev = expf(m - m_new), a_c = expf(m_c - m_new);
    d = d * a_prev + d_part[row] * a_c;
  #pragma unroll
    for (int e = 0; e < E; ++e)
      acc[e] = acc[e] * a_prev + o_part[row * D + lane * E + e] * a_c;
    m = m_new;
  }
  const float denom = fmaxf(d, 1e-30f);
  float* dst = out + ((size_t)b * H + h * G + g) * D + lane * E;
#pragma unroll
  for (int e = 0; e < E; ++e) dst[e] = acc[e] / denom;
}

PagedArgs make_args(const void* pos, const void* tab, const void* qpos, int H,
                    int KV, int D, int bs, int nblk, float scale) {
  PagedArgs a;
  a.pos = static_cast<const int*>(pos);
  a.tab = static_cast<const int*>(tab);
  a.qpos = static_cast<const int*>(qpos);
  a.H = H;
  a.KV = KV;
  a.D = D;
  a.bs = bs;
  a.nblk = nblk;
  a.scale = scale;
  return a;
}

// Launch with E = D / 32 as a compile-time constant.
template <typename T, int E>
cudaError_t launch_commit(const void* q, const void* kp, const void* vp,
                          const PagedArgs& a, float* out, int B,
                          cudaStream_t s) {
  paged_attention_kernel<T, E><<<dim3(B, a.KV), 32 * (a.H / a.KV), 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), a, out);
  return cudaGetLastError();
}

template <typename T, int E>
cudaError_t launch_fast(const void* q, const void* kp, const void* vp,
                        const PagedArgs& a, int combine, float* mp, float* dp,
                        float* op, float* out, int B, int splits,
                        cudaStream_t s) {
  const int threads = 32 * (a.H / a.KV);
  paged_split_kernel<T, E><<<dim3(B, a.KV, splits), threads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), a, combine, mp, dp, op);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  paged_merge_kernel<E><<<dim3(B, a.KV), threads, 0, s>>>(
      mp, dp, op, a.H, a.KV, a.D, splits, out);
  return cudaGetLastError();
}

#define REPRO_DISPATCH_E(D, CALL)                 \
  switch ((D) / 32) {                             \
    case 1: { constexpr int E_ = 1; CALL; }       \
    case 2: { constexpr int E_ = 2; CALL; }       \
    case 3: { constexpr int E_ = 3; CALL; }       \
    case 4: { constexpr int E_ = 4; CALL; }       \
    case 5: { constexpr int E_ = 5; CALL; }       \
    case 6: { constexpr int E_ = 6; CALL; }       \
    case 7: { constexpr int E_ = 7; CALL; }       \
    case 8: { constexpr int E_ = 8; CALL; }       \
    default: return (int)cudaErrorInvalidValue;   \
  }

}  // namespace

extern "C" int repro_paged_attention(const void* q, const void* kp,
                                     const void* vp, const void* pos,
                                     const void* tab, const void* qpos,
                                     void* out, int B, int H, int KV, int D,
                                     int bs, int nblk, float scale, int dtype,
                                     void* stream) {
  if (B == 0) return 0;
  if (D % 32) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const PagedArgs a = make_args(pos, tab, qpos, H, KV, D, bs, nblk, scale);
  float* o = static_cast<float*>(out);
  if (dtype == DT_BF16) {
    REPRO_DISPATCH_E(D, return (int)(launch_commit<__nv_bfloat16, E_>(
                            q, kp, vp, a, o, B, s)));
  }
  REPRO_DISPATCH_E(D, return (int)(launch_commit<float, E_>(q, kp, vp, a, o,
                                                               B, s)));
}

extern "C" int repro_paged_attention_fast(
    const void* q, const void* kp, const void* vp, const void* pos,
    const void* tab, const void* qpos, void* m_part, void* d_part,
    void* o_part, void* out, int B, int H, int KV, int D, int bs, int nblk,
    int splits, float scale, int combine, int dtype, void* stream) {
  if (B == 0) return 0;
  if (D % 32 || splits < 1 || nblk % splits) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const PagedArgs a = make_args(pos, tab, qpos, H, KV, D, bs, nblk, scale);
  float* mp = static_cast<float*>(m_part);
  float* dp = static_cast<float*>(d_part);
  float* op = static_cast<float*>(o_part);
  float* o = static_cast<float*>(out);
  if (dtype == DT_BF16) {
    REPRO_DISPATCH_E(D, return (int)(launch_fast<__nv_bfloat16, E_>(
                            q, kp, vp, a, combine, mp, dp, op, o, B, splits,
                            s)));
  }
  REPRO_DISPATCH_E(D, return (int)(launch_fast<float, E_>(
                          q, kp, vp, a, combine, mp, dp, op, o, B, splits,
                          s)));
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
