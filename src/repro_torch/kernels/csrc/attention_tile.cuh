// Building blocks of the port's decode-attention kernels (sm_90a): the
// paged pair (paged_attention.cu) and the dense-cache kernel
// (decode_attention.cu).
//
// A tile is 16 keys of one KV head: lane pair (2j, 2j+1) of a warp takes
// key j, each lane half of its D elements, so a warp scores a whole tile
// against one query row at once (tile_dot), and each lane then accumulates
// E = ceil(D / 32) elements of o, [lane * E, lane * E + E), from the tile's
// V rows (accumulate_v).  K rows are stored in shared memory rotated by 2j
// chunks of 16 bytes (rotated), so the lanes of a shared-memory phase read
// distinct bank groups.  Tiles reach shared memory by cp.async, 16 bytes a
// thread; the kernels keep a ring of them in flight.
//
// Head dims: D % 16 == 0, 16 <= D <= 256, so a row is a whole number of
// 16-byte chunks (bf16: D * 2 bytes, 224 at D = 112) and every cp.async
// row stays 16-byte aligned.  Where D = 32 * E (D = 64, 96, 128, ...) every
// element of every lane lies in the row, the default of the templates'
// D = 32 * E, and nothing is masked: those instantiations are the same
// code as before.  Otherwise (D = 112: E = 4, lanes 28-31) the tail lanes'
// elements at or past D are masked (live): never loaded, accumulated or
// stored, so they add no term, not even a +0.0, to any real element.
//
// Everything here has internal linkage (an unnamed namespace): state in a
// header that two kernel libraries include must not be shared between them
// (static locals of inline functions are one object per process, even
// across RTLD_LOCAL libraries).
#pragma once

#include "common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int TILE_KEYS = 16;     // keys per tile: a lane pair per key
constexpr int MAX_SMEM = 232448;  // dynamic shared memory a CTA may use

static_assert(2 * TILE_KEYS == 32, "a lane pair per key of a tile");

// bytes of one K or V row (D elements)
template <typename T, int E, int D = 32 * E>
__host__ __device__ constexpr int row_bytes() { return D * (int)sizeof(T); }

// Whether element e of lane `lane`, row element lane * E + e, lies in the
// row: always at D = 32 * E, else not in the masked tail.
template <int E, int D>
__device__ __forceinline__ bool live(int lane, int e) {
  if constexpr (D == 32 * E) {
    return true;
  } else {
    return lane * E + e < D;
  }
}

// ---------------------------------------------------------------------------
// async copies, warp reductions
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::
                   "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::
                   "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// xor butterflies: every lane ends with the same bits (f32 + and max commute)
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// the max over a warp whose lane pairs (2j, 2j+1) hold equal values
__device__ __forceinline__ float pair_max(float v) {
#pragma unroll
  for (int o = 16; o > 1; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// scores and V rows from shared memory
// ---------------------------------------------------------------------------

// K rows are stored rotated: 16-byte chunk c of key j at chunk position
// (c + 2j) mod NCH of its row, so the lane pairs of different keys that
// read chunk c at once hit different bank groups.
template <int NCH>
__device__ __forceinline__ int rotated(int c, int j) {
  const int p = c + (2 * j) % NCH;
  return p >= NCH ? p - NCH : p;
}

// acc[0..3] += q . one 16-byte chunk of a K row
__device__ __forceinline__ void chunk_dot(const uint4& w, const float* qc,
                                          float* acc, const __nv_bfloat16*) {
  const float4 qa = *reinterpret_cast<const float4*>(qc);
  const float4 qb = *reinterpret_cast<const float4*>(qc + 4);
  acc[0] = fmaf(qa.x, bf16_lo(w.x), acc[0]);
  acc[1] = fmaf(qa.y, bf16_hi(w.x), acc[1]);
  acc[2] = fmaf(qa.z, bf16_lo(w.y), acc[2]);
  acc[3] = fmaf(qa.w, bf16_hi(w.y), acc[3]);
  acc[0] = fmaf(qb.x, bf16_lo(w.z), acc[0]);
  acc[1] = fmaf(qb.y, bf16_hi(w.z), acc[1]);
  acc[2] = fmaf(qb.z, bf16_lo(w.w), acc[2]);
  acc[3] = fmaf(qb.w, bf16_hi(w.w), acc[3]);
}

__device__ __forceinline__ void chunk_dot(const uint4& w, const float* qc,
                                          float* acc, const float*) {
  const float4 qa = *reinterpret_cast<const float4*>(qc);
  acc[0] = fmaf(qa.x, __uint_as_float(w.x), acc[0]);
  acc[1] = fmaf(qa.y, __uint_as_float(w.y), acc[1]);
  acc[2] = fmaf(qa.z, __uint_as_float(w.z), acc[2]);
  acc[3] = fmaf(qa.w, __uint_as_float(w.w), acc[3]);
}

// The dot of key j of a tile (K rows rotated, at ks) with query row qrow
// (f32, scaled, in shared memory), 0 unless j < kt.  Lane 2j + hh sums the
// chunks c = hh, hh + 2, ... of the row; the pair adds its halves, so both
// lanes of the pair return the same bits.  Every lane of the warp must
// call it.
template <typename T, int E, int D = 32 * E>
__device__ __forceinline__ float tile_dot(const float* qrow, const char* ks,
                                          int kt, int lane) {
  constexpr int ROWB = row_bytes<T, E, D>();
  constexpr int NCH = ROWB / 16;
  constexpr int EPC = 16 / (int)sizeof(T);  // elements per chunk
  const int j = lane >> 1, hh = lane & 1;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (j < kt) {
    const char* krow = ks + j * ROWB;
#pragma unroll
    for (int k = 0; k < NCH / 2; ++k) {
      const int c = 2 * k + hh;
      const uint4 w = *reinterpret_cast<const uint4*>(krow + rotated<NCH>(c, j) * 16);
      chunk_dot(w, qrow + c * EPC, acc, static_cast<const T*>(nullptr));
    }
  }
  float s = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  s += __shfl_xor_sync(FULL, s, 1);
  return s;
}

// elements [lane * E, lane * E + E) of a V row, as f32, in the widest
// aligned loads; a masked element (D < 32 * E) is not read and reads 0
template <typename T, int E, int D = 32 * E>
__device__ __forceinline__ void load_dims(const char* vrow, int lane, float* v) {
  const T* p = reinterpret_cast<const T*>(vrow) + lane * E;
  if constexpr (D != 32 * E && D % E == 0) {
    // whole lanes: the first D / E lanes hold the row, the rest none
    if (lane < D / E) {
      load_dims<T, E>(vrow, lane, v);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = 0.f;
    }
  } else if constexpr (D != 32 * E) {
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = live<E, D>(lane, e) ? to_f32(p[e]) : 0.f;
  } else if constexpr (sizeof(T) == 2 && E % 4 == 0) {
#pragma unroll
    for (int k = 0; k < E / 4; ++k) {
      const uint2 w = reinterpret_cast<const uint2*>(p)[k];
      v[4 * k] = bf16_lo(w.x);
      v[4 * k + 1] = bf16_hi(w.x);
      v[4 * k + 2] = bf16_lo(w.y);
      v[4 * k + 3] = bf16_hi(w.y);
    }
  } else if constexpr (sizeof(T) == 2 && E % 2 == 0) {
#pragma unroll
    for (int k = 0; k < E / 2; ++k) {
      const unsigned w = reinterpret_cast<const unsigned*>(p)[k];
      v[2 * k] = bf16_lo(w);
      v[2 * k + 1] = bf16_hi(w);
    }
  } else if constexpr (sizeof(T) == 4 && E % 4 == 0) {
#pragma unroll
    for (int k = 0; k < E / 4; ++k) {
      const float4 w = reinterpret_cast<const float4*>(p)[k];
      v[4 * k] = w.x;
      v[4 * k + 1] = w.y;
      v[4 * k + 2] = w.z;
      v[4 * k + 3] = w.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = to_f32(p[e]);
  }
}

// o[e] += weight of key jj (held by lane 2 jj) * V[jj][lane * E + e], keys
// in tile order; a masked element takes no term
template <typename T, int E, int D = 32 * E>
__device__ __forceinline__ void accumulate_v(const char* vs, float w, int kt,
                                             int lane, float* o) {
  constexpr int ROWB = row_bytes<T, E, D>();
  for (int jj = 0; jj < kt; ++jj) {
    const float wj = __shfl_sync(FULL, w, 2 * jj);
    float v[E];
    load_dims<T, E, D>(vs + jj * ROWB, lane, v);
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (live<E, D>(lane, e)) o[e] = fmaf(wj, v[e], o[e]);
  }
}

// The G * D elements of q for one (row, KV head), in 16-byte loads: at
// most QCH a thread at 32 * G threads.  load() issues them; store() writes
// them to shared memory, [G][D], as f32 scaled in f32 (the plain version's
// rounding point), once the other prologue loads are in flight too.
template <typename T, int E, int D = 32 * E>
struct QTile {
  static constexpr int EPC = 16 / (int)sizeof(T);  // elements per 16 bytes
  static constexpr int QCH = (E * (int)sizeof(T) + 15) / 16;
  uint4 w[QCH];
  __device__ __forceinline__ void load(const T* src, int G) {
    const int n = G * D / EPC;
#pragma unroll
    for (int k = 0; k < QCH; ++k) {
      const int c = threadIdx.x + k * blockDim.x;
      if (c < n) w[k] = reinterpret_cast<const uint4*>(src)[c];
    }
  }
  __device__ __forceinline__ void store(float* dst, int G, float scale) const {
    const int n = G * D / EPC;
#pragma unroll
    for (int k = 0; k < QCH; ++k) {
      const int c = threadIdx.x + k * blockDim.x;
      if (c >= n) continue;
      float4* d4 = reinterpret_cast<float4*>(dst + c * EPC);
      if constexpr (sizeof(T) == 2) {
        d4[0] = make_float4(bf16_lo(w[k].x) * scale, bf16_hi(w[k].x) * scale,
                            bf16_lo(w[k].y) * scale, bf16_hi(w[k].y) * scale);
        d4[1] = make_float4(bf16_lo(w[k].z) * scale, bf16_hi(w[k].z) * scale,
                            bf16_lo(w[k].w) * scale, bf16_hi(w[k].w) * scale);
      } else {
        d4[0] = make_float4(__uint_as_float(w[k].x) * scale, __uint_as_float(w[k].y) * scale,
                            __uint_as_float(w[k].z) * scale, __uint_as_float(w[k].w) * scale);
      }
    }
  }
};

// ---------------------------------------------------------------------------
// launch helpers
// ---------------------------------------------------------------------------

// Raises a kernel's dynamic shared memory limit to `bytes` once it needs
// more than the default 48 KB; `granted` is the launcher's own record.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, int* granted) {
  if (bytes > MAX_SMEM) return cudaErrorInvalidValue;
  if (bytes <= *granted) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) *granted = bytes;
  return e;
}

}  // namespace

// Calls CALL with D_ = D and E_ = ceil(D / 32) as compile-time constants,
// D % 16 == 0 in 16..256: D = 32 * E_ (32, 64, ..., 256) and the masked
// widths 16, 48, ..., 240 (112: kimi-k2's heads), each an instantiation of
// its own.
#define REPRO_CASE_D(DV, CALL) \
  case DV: { constexpr int D_ = DV, E_ = (DV + 31) / 32; CALL; }
#define REPRO_DISPATCH_D(D, CALL)                                             \
  switch (D) {                                                                \
    REPRO_CASE_D(16, CALL) REPRO_CASE_D(32, CALL) REPRO_CASE_D(48, CALL)       \
    REPRO_CASE_D(64, CALL) REPRO_CASE_D(80, CALL) REPRO_CASE_D(96, CALL)       \
    REPRO_CASE_D(112, CALL) REPRO_CASE_D(128, CALL) REPRO_CASE_D(144, CALL)    \
    REPRO_CASE_D(160, CALL) REPRO_CASE_D(176, CALL) REPRO_CASE_D(192, CALL)    \
    REPRO_CASE_D(208, CALL) REPRO_CASE_D(224, CALL) REPRO_CASE_D(240, CALL)    \
    REPRO_CASE_D(256, CALL)                                                   \
    default: return (int)cudaErrorInvalidValue;                               \
  }
