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
// Bound on this card: bytes.  A call must read q, every valid key and value
// row once per (row, KV head) and the lengths, and write the output
// (chip_smoke.py::decode_bound counts exactly these).  A key costs
// 2 * D * 2 bytes (bf16) and 4 * G * D flops for the G query heads of its
// KV head, far under the card's flop/byte balance, so the CUDA cores
// suffice (scoring the bf16 tiles on the tensor cores instead, mma.sync
// with K by ldmatrix, was 1-2 % faster at B = 64 and the long context and
// no faster elsewhere) and the design is about keeping bytes in flight and
// reading nothing else (attention_tile.cuh holds the pieces it shares with
// the paged kernels; a 6- or 8-tile ring, which holds fewer CTAs an SM,
// was slower everywhere):
//
// 1. Work follows the valid keys.  Each chunk's valid keys [start_c,
//    min(end_c, len)) are cut into tiles of DA_TILE_KEYS keys from the
//    chunk's start, so no tile crosses a chunk bound and a chunk's last
//    tile is masked at the chunk's valid end.  No key at s >= len is read,
//    and chunks that start at or past len (the trailing empty ones) are not
//    visited: the cost does not follow S or the number of chunks.
// 2. Bytes in flight.  A tile of one KV head is 16 rows of D contiguous
//    elements at a stride of KV * D: its K and V rows stream through a ring
//    of DA_STAGES tiles in shared memory with cp.async, 16 bytes a thread,
//    so DA_STAGES - 1 tiles are in flight while one is used.  No table, so
//    nothing is read besides q, the keys, the values and the length.
// 3. One update per tile.  The CTA's G warps score a whole tile at once,
//    warp g against query head h * G + g (a lane pair per key, each lane
//    half of D; q in shared memory, scaled in f32), and update their
//    online softmax once per tile; each lane accumulates D / 32 elements of
//    o from the tile's V rows.  A rank finds its next tile by moving a
//    cursor, not by searching the chunks.
// 4. Enough CTAs.  A (row, KV head) is spread over a thread-block cluster
//    of DA_CLUSTER CTAs along the key axis (512 CTAs at B = 8, KV = 8,
//    where one CTA per (row, KV head) gave 64); the ranks' partials merge
//    through distributed shared memory after one cluster barrier per round
//    of up to DA_MAX_ROUND chunks (one round at FAST_PATH_POLICY's split
//    counts): one launch, no workspace.
//
// The partition and merge order (the port's commit-path rules: literal
// partition, one fixed merge order, no atomics, f32 accumulators, no
// autotuning), because this kernel is the gathered lane's commit path in
// BATCH_INVARIANT mode:
// * tile t of a chunk belongs to cluster rank t % DA_CLUSTER, a literal: the
//   partition depends on nothing but the tile's index in its chunk, never
//   on B, kv_splits, the lengths or the card;
// * a rank walks its tiles of a chunk in order, one online-softmax update
//   per tile, and ends the chunk with a partial (m, l, o) in f32;
// * the chunk's triple is its ranks' partials merged with their max first:
//   M = max over ranks of m (from -1e30), then d_c = sum_r l_r exp(m_r - M)
//   and o_c = sum_r o_r exp(m_r - M), summed in rank order 0, 1, ...; rank
//   R merges elements [R * D / DA_CLUSTER, (R + 1) * D / DA_CLUSTER) of o
//   (every rank stores its partial's share into the shared memory of the
//   rank that merges it before the barrier) and every rank d and m;
// * the chunk triples then merge into the running triple in split order,
//   with d and o rounded through combine_dtype at the first chunk and
//   after every merge, exactly as the plain version.
// A rank with no tile in a chunk yields the neutral partial (m = -1e30,
// l = 0, o = 0), whose merge changes no bit: once any rank has a valid key,
// M is at least that key's finite score and the neutral weight
// exp(-1e30 - M) is exactly 0 in f32; if none has, every weight is 1 and
// the sums stay 0.  A trailing empty chunk (start >= len, after chunk 0) is
// skipped, which changes no bit either: its triple is (-1e30, 0, 0), so
// m_new = m, a1 = 1, a2 = exp(-1e30 - m) = 0 and d, o, already values of
// combine_dtype, round to themselves (an exact zero may at most lose its
// sign, which compares equal).  So a row's bits depend on its own q, keys,
// values and length: not on B, not on the other rows, and at kv_splits 1
// not on S.
//
// Contract on shapes (the wrapper checks them, the entry point refuses the
// rest): D % 32 == 0, D <= 256, G = H / KV <= GMAX; q, k, v share one
// dtype (bf16 or f32) and are 16-byte aligned; 1 <= kv_splits <= S.
#include "attention_tile.cuh"

#include <cooperative_groups.h>

namespace {

namespace cg = cooperative_groups;

// The key-axis partition: literals, never derived from B, kv_splits, the
// lengths or the card.
constexpr int DA_CLUSTER = 8;          // CTAs per (row, KV head): one cluster
constexpr int DA_TILE_KEYS = 16;       // keys per tile: a lane pair per key
constexpr int DA_STAGES = 4;           // tiles in the shared-memory ring
constexpr int DA_MAX_ROUND = 8;        // chunks merged per cluster barrier, at most
constexpr int GMAX = 8;                // query heads per KV head

static_assert(DA_TILE_KEYS == TILE_KEYS, "a lane pair per key of a tile");
static_assert(32 % DA_CLUSTER == 0, "each rank merges the D / 32 elements of whole lanes");

struct DecodeArgs {
  const int* lengths;  // (B,) valid keys per row
  int H, KV, S, splits, combine;
  float scale;
};

// The partial of one (chunk, rank, query head) that a rank receives: m, l
// and the rank's slice of o, D / DA_CLUSTER elements.
template <int E>
__host__ __device__ constexpr int slot_floats() { return 2 + 32 * E / DA_CLUSTER; }

// Chunks merged per cluster barrier: kv_splits, at most DA_MAX_ROUND, so
// the shared memory a CTA asks for (and with it the CTAs an SM holds)
// follows what the call needs; at GMAX heads, D = 256 and f32 a CTA still
// fits (204 KB).  The rounds change when the ranks meet, not what they add
// or in which order.
__host__ __device__ int round_chunks(int splits) {
  return splits < DA_MAX_ROUND ? splits : DA_MAX_ROUND;
}

// Dynamic shared memory of a CTA, byte offsets (all multiples of 16).
struct Layout {
  int q, ring, recv, bytes;
};

template <typename T, int E>
__host__ __device__ Layout layout(int G, int splits) {
  Layout L{};
  int off = 0;
  L.q = off;    off += G * 32 * E * 4;                                    // f32 scaled q
  L.ring = off; off += DA_STAGES * 2 * DA_TILE_KEYS * row_bytes<T, E>();  // K, V
  L.recv = off; off += round_chunks(splits) * DA_CLUSTER * G * slot_floats<E>() * 4;
  L.bytes = off;
  return L;
}

// The chunks of a row (_split_sizes of S) and this rank's tiles in them.
struct Chunks {
  int base, rem, len, r;
  __device__ int start(int c) const { return c * base + min(c, rem); }
  // valid keys of chunk c: [start(c), vend(c))
  __device__ int vend(int c) const { return min(start(c + 1), len); }
  // the chunks that hold a valid key, and chunk 0 always (a row of length 0
  // gives the neutral triple, as in the plain version)
  __device__ int count() const {
    if (len <= 0) return 1;
    const int last = len - 1, big = rem * (base + 1);  // keys in the longer chunks
    return 1 + (last < big ? last / (base + 1) : rem + (last - big) / base);
  }
  // tiles of this rank in chunk c: t = r, r + DA_CLUSTER, ... below the
  // chunk's tile count
  __device__ int tiles(int c) const {
    const int n = (max(vend(c) - start(c), 0) + DA_TILE_KEYS - 1) / DA_TILE_KEYS;
    return n > r ? (n - 1 - r) / DA_CLUSTER + 1 : 0;
  }
};

// This rank's tiles of a round's chunks [c0, c1), in chunk order: tile u
// of the round is tile t = r + (u - first) * DA_CLUSTER of chunk c, whose
// rank-r tiles are u = first .. first + n - 1.  seek() moves forward only
// (the ring issues and uses tiles in order), so a tile costs no search.
struct Cursor {
  int c, first, n;
  __device__ Cursor(const Chunks& ch, int c0) : c(c0), first(0), n(ch.tiles(c0)) {}
  __device__ __forceinline__ void seek(const Chunks& ch, int u) {
    while (u >= first + n) {
      first += n;
      n = ch.tiles(++c);
    }
  }
  __device__ __forceinline__ int key0(const Chunks& ch, int u) const {
    return ch.start(c) + (ch.r + (u - first) * DA_CLUSTER) * DA_TILE_KEYS;
  }
};

// Grid (DA_CLUSTER, KV, B), one cluster per (row, KV head); 32 * G threads,
// warp g serving query head h * G + g.
template <typename T, int E>
__global__ void __cluster_dims__(DA_CLUSTER, 1, 1) __launch_bounds__(32 * GMAX)
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, DecodeArgs a,
                            T* __restrict__ out) {
  extern __shared__ __align__(16) char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive();
  constexpr int D = 32 * E;
  constexpr int ROWB = row_bytes<T, E>();
  constexpr int NCH = ROWB / 16;
  constexpr int TILEB = DA_TILE_KEYS * ROWB;
  constexpr int LPR = 32 / DA_CLUSTER, SLICE = LPR * E;
  constexpr int SLOT = slot_floats<E>();
  const int r = (int)cluster.block_rank();
  const int h = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KV;
  const int g = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Layout L = layout<T, E>(G, a.splits);
  float* qs = reinterpret_cast<float*>(smem + L.q);
  char* ring = smem + L.ring;
  float* recv = reinterpret_cast<float*>(smem + L.recv);  // [round chunk][rank][G][SLOT]

  QTile<T, E> qt;
  qt.load(q + ((size_t)b * a.H + (size_t)h * G) * D, G);
  const Chunks ch{a.S / a.splits, a.S % a.splits, min(max(a.lengths[b], 0), a.S), r};
  const int nc = ch.count();
  const int rc = round_chunks(a.splits);
  // key s of this (row, KV head) at byte s * kstride of kb / vb
  const size_t kstride = (size_t)a.KV * ROWB;
  const size_t head0 = ((size_t)b * a.S * a.KV + h) * ROWB;
  const char* kb = reinterpret_cast<const char*>(k) + head0;
  const char* vb = reinterpret_cast<const char*>(v) + head0;
  const float* qrow = qs + g * D;
  qt.store(qs, G, a.scale);  // read after the ring's first barrier

  // The partial of (round chunk i, this rank, head g) into the shared
  // memory of the ranks that merge it: lane l's E elements of o go to rank
  // l / LPR.  Every lane of the warp calls it.
  auto publish = [&](int i, float m, float l, const float* o) {
    float* dst = cluster.map_shared_rank(recv, lane / LPR) +
                 (((size_t)i * DA_CLUSTER + r) * G + g) * SLOT;
    if (lane % LPR == 0) {
      dst[0] = m;
      dst[1] = l;
    }
#pragma unroll
    for (int e = 0; e < E; ++e) dst[2 + (lane % LPR) * E + e] = o[e];
  };

  // the running triple of head g, elements [r * SLICE + lane * E, + E) of
  // o (lanes < LPR)
  float m_run = -1e30f, d_run = 0.f, o_run[E];
#pragma unroll
  for (int e = 0; e < E; ++e) o_run[e] = 0.f;
  cluster_wait();  // every CTA of the cluster has started
  for (int c0 = 0; c0 < nc; c0 += rc) {
    const int c1 = min(nc, c0 + rc);
    int ntiles = 0;
    for (int c = c0; c < c1; ++c) {
      const int n = ch.tiles(c);
      if (n == 0) {  // the neutral partial
        const float zero[E] = {};
        publish(c - c0, -1e30f, 0.f, zero);
      }
      ntiles += n;
    }

    // this rank's tiles of the round, in chunk order, through the ring
    Cursor ci(ch, c0), cu(ch, c0);  // of the tiles issued, and used
    auto issue = [&](int u) {
      if (u < ntiles) {
        ci.seek(ch, u);
        const int key0 = ci.key0(ch, u);
        const int kt = min(DA_TILE_KEYS, ch.vend(ci.c) - key0);
        char* ks = ring + (u % DA_STAGES) * 2 * TILEB;
        char* vs = ks + TILEB;
        const size_t row0 = (size_t)key0 * kstride;
        for (int idx = threadIdx.x; idx < kt * NCH; idx += blockDim.x) {
          const int j = idx / NCH, c = idx - j * NCH;
          const size_t src = row0 + (size_t)j * kstride + (size_t)c * 16;
          cp_async16(ks + j * ROWB + rotated<NCH>(c, j) * 16, kb + src);
          cp_async16(vs + j * ROWB + c * 16, vb + src);
        }
      }
      cp_async_commit();  // an empty group keeps the group count uniform
    };
    float m = -1e30f, l = 0.f, o[E] = {};
#pragma unroll
    for (int u = 0; u < DA_STAGES - 1; ++u) issue(u);
    for (int u = 0; u < ntiles; ++u) {
      cp_async_wait<DA_STAGES - 2>();  // this thread's copies of tile u landed
      __syncthreads();                 // everyone's; everyone done with u - 1
      issue(u + DA_STAGES - 1);        // refills the slot of tile u - 1
      cu.seek(ch, u);
      const int kt = min(DA_TILE_KEYS, ch.vend(cu.c) - cu.key0(ch, u));
      if (u == cu.first) {  // a chunk's first tile: a fresh partial
        m = -1e30f;
        l = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) o[e] = 0.f;
      }
      const char* ks = ring + (u % DA_STAGES) * 2 * TILEB;
      const float dot = tile_dot<T, E>(qrow, ks, kt, lane);
      const float s = (lane >> 1) < kt ? dot : -INFINITY;
      const float mn = fmaxf(m, pair_max(s));  // >= -1e30: finite
      const float alpha = expf(m - mn);
      const float p = expf(s - mn);  // 0 for a masked key
      l = l * alpha + ((lane & 1) ? 0.f : p);  // this lane's keys
#pragma unroll
      for (int e = 0; e < E; ++e) o[e] *= alpha;
      accumulate_v<T, E>(ks + TILEB, p, kt, lane, o);
      m = mn;
      if (u == cu.first + cu.n - 1) publish(cu.c - c0, m, warp_sum(l), o);
    }
    cp_async_wait<0>();
    cluster.sync();  // every rank's partials are visible

    // merge the round's chunks in split order: each chunk's ranks, max
    // first and sums in rank order, then the running triple through
    // combine_dtype
    if (lane < LPR) {
      for (int c = c0; c < c1; ++c) {
        const float* part = recv + (size_t)(c - c0) * DA_CLUSTER * G * SLOT;
        float M = -1e30f;
        for (int rr = 0; rr < DA_CLUSTER; ++rr) M = fmaxf(M, part[((size_t)rr * G + g) * SLOT]);
        float dc = 0.f, oc[E];
#pragma unroll
        for (int e = 0; e < E; ++e) oc[e] = 0.f;
        for (int rr = 0; rr < DA_CLUSTER; ++rr) {
          const float* p = part + ((size_t)rr * G + g) * SLOT;
          const float w = expf(p[0] - M);  // exactly 0 for a neutral partial
          dc += p[1] * w;
#pragma unroll
          for (int e = 0; e < E; ++e) oc[e] += p[2 + lane * E + e] * w;
        }
        if (c == 0) {
          m_run = M;
          d_run = round_to(dc, a.combine);
#pragma unroll
          for (int e = 0; e < E; ++e) o_run[e] = round_to(oc[e], a.combine);
        } else {
          const float m_new = fmaxf(m_run, M);
          const float a1 = expf(m_run - m_new), a2 = expf(M - m_new);
          d_run = round_to(__fadd_rn(__fmul_rn(a1, d_run), __fmul_rn(a2, dc)), a.combine);
#pragma unroll
          for (int e = 0; e < E; ++e)
            o_run[e] = round_to(__fadd_rn(__fmul_rn(a1, o_run[e]), __fmul_rn(a2, oc[e])),
                                a.combine);
          m_run = m_new;
        }
      }
    }
    // no rank stores the next round's partials before every rank has read
    // this round's (c1 < nc is the same in every CTA of the cluster)
    if (c1 < nc) cluster.sync();
  }

  if (lane < LPR) {
    const float den = fmaxf(d_run, 1e-30f);
    T* dst = out + ((size_t)b * a.H + (size_t)h * G + g) * D + r * SLICE + lane * E;
#pragma unroll
    for (int e = 0; e < E; ++e) store_as(dst + e, o_run[e] / den);
  }
}

// Launch with E = D / 32 as a compile-time constant.  B enters the grid
// only as its count of rows.
template <typename T, int E>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const DecodeArgs& a, void* out, int B, cudaStream_t s) {
  static int granted = 48 * 1024;
  const int G = a.H / a.KV;
  const int smem = layout<T, E>(G, a.splits).bytes;
  const cudaError_t e = allow_smem(decode_attention_kernel<T, E>, smem, &granted);
  if (e != cudaSuccess) return e;
  decode_attention_kernel<T, E><<<dim3(DA_CLUSTER, a.KV, B), 32 * G, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), a,
      static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_decode_attention(const void* q, const void* k,
                                      const void* v, const void* lengths,
                                      void* out, int B, int H, int KV, int S,
                                      int D, int splits, float scale,
                                      int combine, int dtype, void* stream) {
  const int G = KV > 0 ? H / KV : 0;
  if (B < 0 || B > 65535 || KV < 1 || KV > 65535 || H % KV || G < 1 || G > GMAX ||
      D % 32 || D < 32 || D > 256 || S < 1 || splits < 1 || splits > S ||
      reinterpret_cast<uintptr_t>(q) % 16 || reinterpret_cast<uintptr_t>(k) % 16 ||
      reinterpret_cast<uintptr_t>(v) % 16)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DecodeArgs a{static_cast<const int*>(lengths), H, KV, S, splits, combine, scale};
  if (dtype == DT_BF16) {
    REPRO_DISPATCH_E(D, return (int)(launch<__nv_bfloat16, E_>(q, k, v, a, out, B, s)));
  }
  REPRO_DISPATCH_E(D, return (int)(launch<float, E_>(q, k, v, a, out, B, s)));
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
