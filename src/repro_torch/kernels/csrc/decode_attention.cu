// Flash-decode GQA attention over a dense per-row K/V cache.
//
// Replaces repro/kernels/decode_attention.py::decode_attention (_kernel):
// one query token per row attends over k/v (B, S, KV, D), keys masked
// unless s < lengths[b].  The key axis is cut into kv_splits chunks
// (_split_sizes: the remainder spreads over the leading chunks).  Per chunk
// an f32 (m, d, o) triple: m_c the chunk's max score (clamped at -1e30),
// e = exp(s - m_c) kept in f32, d_c = sum e, o_c = sum e * v.  The running
// d and o are rounded through combine_dtype at the first chunk and after
// every merge, in split order; the output o / max(d, 1e-30) is written in
// q's dtype.  q is scaled by D^-0.5 in f32 here, as in the TPU kernel.
// These are NOT the fast paged kernel's rounding points (that one rounds e).
//
// One CTA per (row, KV head); it walks the chunks in order itself, so the
// split axis that the TPU ran as a sequential grid dimension becomes a loop
// and nothing is carried between CTAs.  Within a chunk, NW warps take keys
// w, w + NW, ... in order; a warp reads one key row per step (lane l holds
// elements [l*E, l*E + E), coalesced), takes the dot with each of the G
// query heads of its KV head (xor-butterfly sum: every lane ends with the
// same bits), and keeps its own running d and o per head.  Two passes over
// the chunk: the max first, then e, d and o.  The warps' partials are added
// in warp order.  So every sum's order is fixed by D, the chunk length and
// NW (a literal): never by B or a row's place in the batch.  Masked keys
// are skipped (their e is exactly 0 in the plain version).
//
// Bound on this card: bytes.  A decode step reads every valid key and
// value once and does 4*D flops per key and query head, far below the
// H100's flop/byte balance.  The G heads of one KV head share each K/V row
// read, and the second pass hits L1/L2 for the rows the first pass read.
//
// Contract on shapes (the wrapper checks them): D % 32 == 0, D <= 256,
// G = H / KV <= GMAX; q, k, v share one dtype (bf16 or f32).
#include "common.cuh"

namespace {

constexpr int NW = 8;    // warps per CTA
constexpr int GMAX = 8;  // query heads per KV head held in registers

template <int E, typename T>
__device__ __forceinline__ float head_score(const float (&qv)[E],
                                            const T* __restrict__ krow) {
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) s = fmaf(qv[e], to_f32(krow[e]), s);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
  return s;
}

// The chunk's max score of head g, from the warps' maxima (exact in any
// order).
__device__ __forceinline__ float chunk_max(const float* m_part, int G, int g) {
  float m = -1e30f;
  for (int i = 0; i < NW; ++i) m = fmaxf(m, m_part[i * G + g]);
  return m;
}

template <typename T, int E>
__global__ void __launch_bounds__(NW * 32)
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const int* __restrict__ lengths,
                            T* __restrict__ out, int H, int KV, int S,
                            int splits, float scale, int combine) {
  constexpr int D = 32 * E;
  const int b = blockIdx.x, h = blockIdx.y;
  const int G = H / KV;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  extern __shared__ float smem[];
  float* o_run = smem;                 // (G, D) running o
  float* o_part = o_run + G * D;       // (NW, G, D) warp partials
  float* d_part = o_part + NW * G * D; // (NW, G)
  float* m_part = d_part + NW * G;     // (NW, G)
  float* d_run = m_part + NW * G;      // (G,)
  float* m_run = d_run + G;            // (G,)

  // each lane's slice of every head's scaled query, in registers
  float qv[GMAX][E];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g < G) {
      const T* src = q + ((size_t)b * H + h * G + g) * D + lane * E;
#pragma unroll
      for (int e = 0; e < E; ++e) qv[g][e] = __fmul_rn(to_f32(src[e]), scale);
    }
  }
  const int len = min(max(lengths[b], 0), S);
  const size_t row_stride = (size_t)KV * D;
  const T* kb = k + (size_t)b * S * row_stride + (size_t)h * D + lane * E;
  const T* vb = v + (size_t)b * S * row_stride + (size_t)h * D + lane * E;
  const int base = S / splits, rem = S % splits;

  int start = 0;
  for (int c = 0; c < splits; ++c) {
    const int size = base + (c < rem ? 1 : 0);
    const int end = min(start + size, len);  // valid keys: [start, end)

    // pass 1: the chunk's max score per head
    float mw[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) mw[g] = -1e30f;
    for (int s = start + w; s < end; s += NW) {
      const T* krow = kb + (size_t)s * row_stride;
#pragma unroll
      for (int g = 0; g < GMAX; ++g)
        if (g < G) mw[g] = fmaxf(mw[g], head_score<E>(qv[g], krow));
    }
    if (lane == 0)
      for (int g = 0; g < G; ++g) m_part[w * G + g] = mw[g];
    __syncthreads();
    float mc[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) mc[g] = g < G ? chunk_max(m_part, G, g) : 0.f;

    // pass 2: e = exp(s - m_c) in f32, this warp's d and o per head
    float dw[GMAX], ow[GMAX][E];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      dw[g] = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) ow[g][e] = 0.f;
    }
    for (int s = start + w; s < end; s += NW) {
      const T* krow = kb + (size_t)s * row_stride;
      const T* vrow = vb + (size_t)s * row_stride;
      float vv[E];
#pragma unroll
      for (int e = 0; e < E; ++e) vv[e] = to_f32(vrow[e]);
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g < G) {
          const float ex = expf(head_score<E>(qv[g], krow) - mc[g]);
          dw[g] = __fadd_rn(dw[g], ex);
#pragma unroll
          for (int e = 0; e < E; ++e) ow[g][e] = fmaf(ex, vv[e], ow[g][e]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < G) {
        if (lane == 0) d_part[w * G + g] = dw[g];
#pragma unroll
        for (int e = 0; e < E; ++e)
          o_part[(w * G + g) * D + lane * E + e] = ow[g][e];
      }
    }
    __syncthreads();

    // merge the chunk into the running triple, rounded through combine
    for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
      const int g = i / D;
      float oc = o_part[i];
      for (int j = 1; j < NW; ++j) oc = __fadd_rn(oc, o_part[j * G * D + i]);
      if (c == 0) {
        o_run[i] = round_to(oc, combine);
      } else {
        const float m_c = chunk_max(m_part, G, g);
        const float m_new = fmaxf(m_run[g], m_c);
        const float a1 = expf(m_run[g] - m_new), a2 = expf(m_c - m_new);
        o_run[i] = round_to(
            __fadd_rn(__fmul_rn(a1, o_run[i]), __fmul_rn(a2, oc)), combine);
      }
    }
    float d_new = 0.f, m_new = 0.f;
    if (threadIdx.x < G) {
      const int g = threadIdx.x;
      const float m_c = chunk_max(m_part, G, g);
      float dc = d_part[g];
      for (int j = 1; j < NW; ++j) dc = __fadd_rn(dc, d_part[j * G + g]);
      if (c == 0) {
        m_new = m_c;
        d_new = round_to(dc, combine);
      } else {
        m_new = fmaxf(m_run[g], m_c);
        const float a1 = expf(m_run[g] - m_new), a2 = expf(m_c - m_new);
        d_new = round_to(
            __fadd_rn(__fmul_rn(a1, d_run[g]), __fmul_rn(a2, dc)), combine);
      }
    }
    __syncthreads();  // every thread has read m_run before it changes
    if (threadIdx.x < G) {
      d_run[threadIdx.x] = d_new;
      m_run[threadIdx.x] = m_new;
    }
    __syncthreads();
    start += size;
  }

  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D, dd = i % D;
    store_as(out + ((size_t)b * H + h * G + g) * D + dd,
             o_run[i] / fmaxf(d_run[g], 1e-30f));
  }
}

template <typename T, int E>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* lengths, void* out, int B, int H, int KV, int S,
                   int splits, float scale, int combine, cudaStream_t s) {
  const int G = H / KV;
  const size_t smem =
      sizeof(float) * ((size_t)(NW + 1) * G * 32 * E + 2 * NW * G + 2 * G);
  auto kern = decode_attention_kernel<T, E>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(B, KV), NW * 32, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lengths),
      static_cast<T*>(out), H, KV, S, splits, scale, combine);
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

extern "C" int repro_decode_attention(const void* q, const void* k,
                                      const void* v, const void* lengths,
                                      void* out, int B, int H, int KV, int S,
                                      int D, int splits, float scale,
                                      int combine, int dtype, void* stream) {
  if (B == 0) return 0;
  if (D % 32 || KV < 1 || H % KV || H / KV > GMAX || splits < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16) {
    REPRO_DISPATCH_E(D, return (int)(launch<__nv_bfloat16, E_>(
                            q, k, v, lengths, out, B, H, KV, S, splits, scale,
                            combine, s)));
  }
  REPRO_DISPATCH_E(D, return (int)(launch<float, E_>(
                          q, k, v, lengths, out, B, H, KV, S, splits, scale,
                          combine, s)));
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
