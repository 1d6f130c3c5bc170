// Paged decode attention: K/V read in place through the block table.
//
// Two kernels, after repro/kernels/paged_attention.py:
//
// * paged_attention_kernel (commit path) replaces paged_attention /
//   _paged_kernel (+ _gather_view): one f32 softmax per (row, query head)
//   over the row's table reach, keys masked unless 0 <= pos <= q_pos, max
//   clamped at -1e30, denominator at 1e-30, f32 output.
//
// * paged_split_kernel + paged_merge_kernel (`# det: fastpath`) replace
//   paged_attention_fast / _paged_fast_kernel: the table reach is cut into
//   kv_splits equal runs of blocks, with the TPU kernel's rounding points:
//   per split the max m_c over the whole split first, then
//   e = exp(s - m_c) rounded to combine_dtype BEFORE it is summed (d_c, in
//   f32) and multiplied into V (o_c, f32); the merge kernel merges the
//   splits in f32 in split order, as the TPU kernel's VMEM scratch does.
//
// Bound on this card: bytes.  A call must read q, every valid key and value
// row once per (row, KV head), the positions of the blocks it reads and the
// tables, and write the f32 output (chip_smoke.py::attention_bound counts
// exactly these).  A key costs 2 * D * 2 bytes (bf16) and 4 * G * D flops
// for the G query heads of its KV head: 4 flop/byte at G = 4, far under the
// card's ~295, so the CUDA cores suffice and the design is about keeping
// bytes in flight and reading nothing else:
//
// 1. Work follows the valid blocks.  Each CTA takes a fixed slice of the
//    row's table columns, reads it once (one load per entry, each warp's 32
//    entries in one instruction) and compacts the entries that hold a
//    block into a list in shared memory, in column order.  A -1 entry costs
//    that read and nothing else: no K/V/pos traffic, no tile.  The list is
//    built PA_WINDOW entries at a time, so any table reach fits.
// 2. Bytes in flight.  The listed blocks are cut into tiles of PA_TILE_KEYS
//    keys (a block of bs keys is ceil(bs / PA_TILE_KEYS) tiles); a tile's K
//    rows, V rows (D contiguous elements each) and positions stream through
//    a ring of PA_STAGES tiles in shared memory with cp.async, 16 bytes a
//    thread (positions 4 bytes a thread), so PA_STAGES - 1 tiles are in
//    flight while one is used: 24 KB a CTA at bs 16, D 128, bf16, and about
//    4 CTAs an SM at B = 8.  The fast kernel's passes, which stream K or V
//    alone, use the ring as 2 * PA_STAGES slots of one of them.
// 3. One update per tile.  Warp g serves query head h * G + g: lane pair
//    (2j, 2j+1) takes key j of the tile and each lane half of its D
//    elements (q in shared memory, scaled in f32), so a tile's scores come
//    at once; the online softmax then updates once per tile, and each lane
//    accumulates D / 32 elements of o from the tile's V rows.  K rows are
//    stored rotated by 2j chunks of 16 bytes, so the 8 lanes of a
//    shared-memory phase read 8 distinct bank groups.
// 4. Enough CTAs.  A (row, KV head) is spread over a thread-block cluster
//    along the key axis (PA_CLUSTER CTAs for the commit kernel, PF_CLUSTER
//    per split for the fast one), whose partials merge through distributed
//    shared memory in cluster-rank order after one cluster barrier: one
//    launch and no workspace for the commit kernel (a workspace would cost
//    a second launch and an allocation per call, and the engine is
//    host-bound), and at B = 8 512 CTAs for 132 SMs, where one CTA per
//    (row, KV head) gave 64.
// On the card the copies and the fixed cost of a launch, not the
// arithmetic, take most of the time (PERF.md).
//
// The commit kernel's partition and merge order (the port's commit-path
// rules: literal partition, one fixed merge order, no atomics, f32
// accumulators, no autotuning):
// * table column t belongs to cluster rank (t / PA_CHUNK_BLOCKS) %
//   PA_CLUSTER; both are literals below, so the partition depends on
//   nothing but the column index: not on B, kv_splits, the contexts or the
//   card;
// * a rank walks its columns in increasing order, tile by tile, keys of a
//   tile summed by a fixed xor butterfly; it ends with a partial (m, l, o);
// * the partials merge with their max first: M = max over ranks of m
//   (from -1e30), then l = sum_c l_c exp(m_c - M) and o = sum_c o_c
//   exp(m_c - M), summed in rank order 0, 1, ...; rank c merges elements
//   [c * D / PA_CLUSTER, (c + 1) * D / PA_CLUSTER) of o, which every rank
//   stores into its shared memory before the one cluster barrier; the
//   output is o / max(l, 1e-30).
// A rank whose columns hold no valid key yields the neutral partial
// (m = -1e30, l = 0, o = 0).  Merging it changes no bit: once any rank has
// a valid key, M is at least that key's finite score, so the neutral
// weight exp(-1e30 - M) is exactly 0 in f32 and adding 0 * l_c and 0 * o_c
// leaves every sum as it was (an exact zero may at most lose its sign,
// which compares equal); if no rank has one, M = -1e30, every weight is 1,
// l = o = 0 and the output is 0, as the plain version's.  So a row's bits
// depend on its own table, positions and q only: not on B, not on the
// other rows, and not on how many -1 columns follow its blocks (the table
// reach).
//
// The fast kernel keeps each score of pass 1 (K) in shared memory for
// pass 2 (V), so K is read once.  The split's max is exact and independent
// of order: each CTA of the cluster publishes its max, and every CTA takes
// the max of all of them.  A CTA whose slice spans more than one window,
// or whose valid keys exceed the score buffer (PF_SCORE_FLOATS / G keys
// per query head: 512 at G = 4, 8 KB), computes its scores again from K
// in pass 2 (the same code, so the same values); only then is K read twice.
// The merge kernel is a programmatic dependent launch: it is set up while
// the split kernel runs and waits for that grid's completion on the card.
//
// Contract on shapes (the wrapper checks them, the entry points refuse the
// rest): D % 32 == 0, D <= 256, G = H / KV <= 32; q and the pools share one
// dtype (bf16 or f32); q and the pools 16-byte aligned.
#include "attention_tile.cuh"

#include <cooperative_groups.h>

namespace {

namespace cg = cooperative_groups;

// The commit kernel's key-axis partition: literals, never derived from B,
// kv_splits, the contexts or the card.
constexpr int PA_CLUSTER = 8;       // CTAs per (row, KV head): one cluster
constexpr int PA_CHUNK_BLOCKS = 1;  // table columns per chunk (chunks go round-robin)
constexpr int PA_TILE_KEYS = 16;    // keys per tile: a lane pair per key
constexpr int PA_STAGES = 4;        // tiles in the shared-memory ring
constexpr int PA_WINDOW = 512;      // table entries compacted at a time

// The fast kernel's cluster and score buffer (`# det: fastpath`).
constexpr int PF_CLUSTER = 2;          // CTAs per split
constexpr int PF_SCORE_FLOATS = 2048;  // pass-1 scores kept for pass 2

static_assert(PA_TILE_KEYS == TILE_KEYS, "a lane pair per key of a tile");
static_assert(32 % PA_CLUSTER == 0 && 32 % PF_CLUSTER == 0,
              "each rank merges the D / 32 elements of whole lanes");

struct PagedArgs {
  const int* pos;   // (NB, bs) absolute positions, -1 = empty
  const int* tab;   // (B, nblk) block ids, -1 = unallocated
  const int* qpos;  // (B,)
  int H, KV, D, bs, nblk;
  float scale;
};

// The partial of one (rank, query head) that a rank receives: `head`
// floats (m and l, or d) and the rank's slice of o, D / cluster elements.
template <int E, int CLUSTER, int HEAD>
__host__ __device__ constexpr int slot_floats() { return HEAD + 32 * E / CLUSTER; }

// Dynamic shared memory of a CTA, byte offsets (all multiples of 16).
struct Layout {
  int q, list, wsum, misc, pos, ring, recv, score, bytes;
};

// fast: the split kernel's (maxima, score buffer, PF_CLUSTER partials),
// else the commit kernel's (PA_CLUSTER partials)
template <typename T, int E>
__host__ __device__ Layout layout(int G, bool fast) {
  const int recv = fast ? PF_CLUSTER * G * slot_floats<E, PF_CLUSTER, 1>()
                        : PA_CLUSTER * G * slot_floats<E, PA_CLUSTER, 2>();
  Layout L{};
  int off = 0;
  L.q = off;     off += G * 32 * E * 4;                            // f32 scaled q
  L.list = off;  off += PA_WINDOW * 4;                             // listed block ids
  L.wsum = off;  off += 32 * 4;                                    // per-warp counts
  L.misc = off;  off += PF_CLUSTER * 32 * 4;                       // ranks' maxima
  L.pos = off;   off += 2 * PA_STAGES * PA_TILE_KEYS * 4;          // ring: positions
  L.ring = off;  off += PA_STAGES * 2 * PA_TILE_KEYS * row_bytes<T, E>();  // K, V
  L.recv = off;  off += (recv + 3) / 4 * 16;                       // partials received
  L.score = off; off += fast ? PF_SCORE_FLOATS * 4 : 0;
  L.bytes = off;
  return L;
}

// ---------------------------------------------------------------------------
// the table slice and its compaction
// ---------------------------------------------------------------------------

// The table columns of one CTA: rank r of R takes chunks of CH columns
// round-robin from [lo, hi); slice entry i is column
// lo + ((i / CH) * R + r) * CH + i % CH, and a column >= hi is empty.
struct Slice {
  const int* row;  // the row's table
  int lo, hi, r, R, CH;
  __device__ int count() const { return (hi - lo + R * CH - 1) / (R * CH) * CH; }
  __device__ int col(int i) const { return lo + ((i / CH) * R + r) * CH + i % CH; }
};

// Lists the block ids of slice entries [i0, i1) (at most PA_WINDOW) in
// slice order, dropping -1 entries; returns their count, the same in every
// thread.  Each entry is read once.
__device__ int compact(const Slice& sl, int i0, int i1, int* list, int* wsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarp = blockDim.x >> 5;
  int total = 0;
  for (int base = i0; base < i1; base += blockDim.x) {
    const int i = base + threadIdx.x;
    int bid = -1;
    if (i < i1) {
      const int c = sl.col(i);
      if (c < sl.hi) bid = sl.row[c];
    }
    const unsigned keep = __ballot_sync(FULL, bid >= 0);
    if (lane == 0) wsum[warp] = __popc(keep);
    __syncthreads();
    int before = total, all = total;
    for (int w = 0; w < nwarp; ++w) {
      if (w < warp) before += wsum[w];
      all += wsum[w];
    }
    if (bid >= 0) list[before + __popc(keep & ((1u << lane) - 1u))] = bid;
    total = all;
    __syncthreads();  // wsum is rewritten by the next round
  }
  return total;
}

// ---------------------------------------------------------------------------
// the tile ring
// ---------------------------------------------------------------------------

// Streams ntiles tiles (nv listed blocks of tpb tiles each) through the
// ring: tile u's K rows, V rows and positions land in slot u % SLOTS while
// the next SLOTS - 1 tiles are in flight; a slot is refilled only after
// every thread has used it.  The ring holds PA_STAGES slots of K and V, or
// twice as many of one of them.  use(u, k, v, pos, kt) consumes a tile of
// kt <= PA_TILE_KEYS keys, in every thread, in tile order.
template <typename T, int E, bool WITH_K, bool WITH_V, typename Use>
__device__ __forceinline__ void stream_tiles(const T* kp, const T* vp,
                                             const int* pos, int bs, int KV,
                                             int h, const int* list,
                                             int ntiles, int tpb, char* ring,
                                             int* pring, Use&& use) {
  constexpr int ROWB = row_bytes<T, E>();
  constexpr int NCH = ROWB / 16;
  constexpr int TILEB = PA_TILE_KEYS * ROWB;
  constexpr bool BOTH = WITH_K && WITH_V;
  constexpr int SLOTS = BOTH ? PA_STAGES : 2 * PA_STAGES;
  constexpr int SLOTB = BOTH ? 2 * TILEB : TILEB;
  auto keys = [&](int u) { return min(PA_TILE_KEYS, bs - (u % tpb) * PA_TILE_KEYS); };
  auto issue = [&](int u) {
    if (u < ntiles) {
      const int slot = u % SLOTS;
      const int bid = list[u / tpb];
      const int j0 = (u % tpb) * PA_TILE_KEYS;
      const int kt = keys(u);
      char* ks = ring + slot * SLOTB;
      char* vs = BOTH ? ks + TILEB : ks;
      const size_t row0 = ((size_t)bid * bs + j0) * KV + h;  // pool row of key j0
      for (int idx = threadIdx.x; idx < kt * NCH; idx += blockDim.x) {
        const int j = idx / NCH, c = idx - j * NCH;
        const size_t src = (row0 + (size_t)j * KV) * ROWB + (size_t)c * 16;
        if (WITH_K)
          cp_async16(ks + j * ROWB + rotated<NCH>(c, j) * 16,
                     reinterpret_cast<const char*>(kp) + src);
        if (WITH_V)
          cp_async16(vs + j * ROWB + c * 16, reinterpret_cast<const char*>(vp) + src);
      }
      if ((int)threadIdx.x < kt)
        cp_async4(pring + slot * PA_TILE_KEYS + threadIdx.x,
                  pos + (size_t)bid * bs + j0 + threadIdx.x);
    }
    cp_async_commit();  // an empty group keeps the group count uniform
  };
#pragma unroll
  for (int u = 0; u < SLOTS - 1; ++u) issue(u);
  for (int u = 0; u < ntiles; ++u) {
    cp_async_wait<SLOTS - 2>();  // this thread's copies of tile u landed
    __syncthreads();             // everyone's; everyone done with u - 1
    issue(u + SLOTS - 1);        // refills the slot of tile u - 1
    const char* base = ring + (u % SLOTS) * SLOTB;
    use(u, base, BOTH ? base + TILEB : base, pring + (u % SLOTS) * PA_TILE_KEYS, keys(u));
  }
  cp_async_wait<0>();
  __syncthreads();
}

// ---------------------------------------------------------------------------
// scores
// ---------------------------------------------------------------------------

// The score of key j of a tile against query row qrow (f32, scaled), masked
// to -inf unless j < kt and 0 <= pos[j] <= qp.  Every lane of the warp must
// call it.
template <typename T, int E>
__device__ __forceinline__ float tile_score(const float* qrow, const char* ks,
                                            const int* ps, int kt, int qp,
                                            int lane) {
  const float s = tile_dot<T, E>(qrow, ks, kt, lane);
  const int j = lane >> 1;
  const bool ok = j < kt && ps[j] >= 0 && ps[j] <= qp;
  return ok ? s : -INFINITY;
}

// ---------------------------------------------------------------------------
// the commit kernel
// ---------------------------------------------------------------------------

// Grid (PA_CLUSTER, KV, B), one cluster per (row, KV head); 32 * G threads,
// warp g serving query head h * G + g.
template <typename T, int E>
__global__ void __cluster_dims__(PA_CLUSTER, 1, 1) __launch_bounds__(1024, 1)
    paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                           const T* __restrict__ vp, PagedArgs a,
                           float* __restrict__ out) {
  extern __shared__ __align__(16) char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive();
  const int r = (int)cluster.block_rank();
  const int h = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KV;
  constexpr int D = 32 * E;
  const int g = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Layout L = layout<T, E>(G, false);
  float* qs = reinterpret_cast<float*>(smem + L.q);
  int* list = reinterpret_cast<int*>(smem + L.list);
  int* wsum = reinterpret_cast<int*>(smem + L.wsum);
  int* pring = reinterpret_cast<int*>(smem + L.pos);
  char* ring = smem + L.ring;

  QTile<T, E> qt;
  qt.load(q + ((size_t)b * a.H + (size_t)h * G) * D, G);
  const int qp = a.qpos[b];
  const Slice sl{a.tab + (size_t)b * a.nblk, 0, a.nblk, r, PA_CLUSTER, PA_CHUNK_BLOCKS};
  const int n = sl.count();
  const int tpb = (a.bs + PA_TILE_KEYS - 1) / PA_TILE_KEYS;
  const float* qrow = qs + g * D;

  float m = -1e30f, l = 0.f, o[E];
#pragma unroll
  for (int e = 0; e < E; ++e) o[e] = 0.f;
  for (int w0 = 0; w0 < n; w0 += PA_WINDOW) {
    const int nv = compact(sl, w0, min(n, w0 + PA_WINDOW), list, wsum);
    if (w0 == 0) qt.store(qs, G, a.scale);  // read after stream_tiles' barrier
    stream_tiles<T, E, true, true>(
        kp, vp, a.pos, a.bs, a.KV, h, list, nv * tpb, tpb, ring, pring,
        [&](int, const char* ks, const char* vs, const int* ps, int kt) {
          const float s = tile_score<T, E>(qrow, ks, ps, kt, qp, lane);
          const float mn = fmaxf(m, pair_max(s));  // >= -1e30: finite
          const float alpha = expf(m - mn);
          const float p = expf(s - mn);  // 0 for a masked key
          l = l * alpha + ((lane & 1) ? 0.f : p);  // this lane's keys
#pragma unroll
          for (int e = 0; e < E; ++e) o[e] *= alpha;
          accumulate_v<T, E>(vs, p, kt, lane, o);
          m = mn;
        });
  }
  l = warp_sum(l);

  // The merge.  Rank c merges elements [c * SLICE, (c + 1) * SLICE) of
  // every head's o, which lanes [c * LPR, (c + 1) * LPR) hold: each lane
  // stores its partial's share into the shared memory of the rank that
  // merges it, then one cluster barrier, then each rank merges its slice
  // from its own shared memory: the max M of the ranks' m, then
  // l = sum_c l_c exp(m_c - M) and o = sum_c o_c exp(m_c - M) in rank order.
  constexpr int LPR = 32 / PA_CLUSTER, SLICE = LPR * E;
  constexpr int SLOT = slot_floats<E, PA_CLUSTER, 2>();  // m, l, o slice
  float* recv = reinterpret_cast<float*>(smem + L.recv);  // [PA_CLUSTER][G][SLOT]
  float* mine = cluster.map_shared_rank(recv, lane / LPR) + ((size_t)r * G + g) * SLOT;
  cluster_wait();
  if (lane % LPR == 0) {
    mine[0] = m;
    mine[1] = l;
  }
#pragma unroll
  for (int e = 0; e < E; ++e) mine[2 + (lane % LPR) * E + e] = o[e];
  cluster.sync();  // every rank's stores are visible; none is read remotely after
  if (lane < LPR) {
    float M = -1e30f;
    for (int c = 0; c < PA_CLUSTER; ++c) M = fmaxf(M, recv[((size_t)c * G + g) * SLOT]);
    float Lsum = 0.f, O[E];
#pragma unroll
    for (int e = 0; e < E; ++e) O[e] = 0.f;
    for (int c = 0; c < PA_CLUSTER; ++c) {
      const float* p = recv + ((size_t)c * G + g) * SLOT;
      const float wc = expf(p[0] - M);  // exactly 0 for a neutral partial
      Lsum += p[1] * wc;
#pragma unroll
      for (int e = 0; e < E; ++e) O[e] += p[2 + lane * E + e] * wc;
    }
    const float den = fmaxf(Lsum, 1e-30f);
    float* dst = out + ((size_t)b * a.H + (size_t)h * G + g) * D + r * SLICE + lane * E;
#pragma unroll
    for (int e = 0; e < E; ++e) dst[e] = O[e] / den;
  }
}

// ---------------------------------------------------------------------------
// the fast kernel (det: fastpath)
// ---------------------------------------------------------------------------

// Grid (PF_CLUSTER * splits, KV, B), one cluster per (row, KV head, split);
// 32 * G threads.  Writes the split's (m_c, d_c, o_c) to the workspace
// (B, KV, splits, G[, D]).
// det: fastpath
template <typename T, int E>
__global__ void __cluster_dims__(PF_CLUSTER, 1, 1) __launch_bounds__(1024, 1)
    paged_split_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                       const T* __restrict__ vp, PagedArgs a, int splits,
                       int combine, float* __restrict__ m_part,
                       float* __restrict__ d_part, float* __restrict__ o_part) {
  extern __shared__ __align__(16) char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive();
  // the merge kernel may launch now; it waits for this grid's completion
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int r = (int)cluster.block_rank(), sp = blockIdx.x / PF_CLUSTER;
  const int h = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KV;
  constexpr int D = 32 * E;
  const int g = threadIdx.x >> 5, lane = threadIdx.x & 31, j = lane >> 1;
  const Layout L = layout<T, E>(G, true);
  float* qs = reinterpret_cast<float*>(smem + L.q);
  int* list = reinterpret_cast<int*>(smem + L.list);
  int* wsum = reinterpret_cast<int*>(smem + L.wsum);
  float* cmax = reinterpret_cast<float*>(smem + L.misc);
  int* pring = reinterpret_cast<int*>(smem + L.pos);
  char* ring = smem + L.ring;
  const int cap = PF_SCORE_FLOATS / G;  // score slots per query head
  float* sc = reinterpret_cast<float*>(smem + L.score) + g * cap;

  QTile<T, E> qt;
  qt.load(q + ((size_t)b * a.H + (size_t)h * G) * D, G);
  const int qp = a.qpos[b];
  const int per = a.nblk / splits;
  const Slice sl{a.tab + (size_t)b * a.nblk, sp * per, (sp + 1) * per, r, PF_CLUSTER, 1};
  const int n = sl.count();
  const int tpb = (a.bs + PA_TILE_KEYS - 1) / PA_TILE_KEYS;
  const float* qrow = qs + g * D;

  // pass 1: the scores (kept when the slice is one window and they fit)
  // and this CTA's max
  bool keep = false;
  int nv = 0;
  float mloc = -INFINITY;
  for (int w0 = 0; w0 < n; w0 += PA_WINDOW) {
    nv = compact(sl, w0, min(n, w0 + PA_WINDOW), list, wsum);
    if (w0 == 0) qt.store(qs, G, a.scale);  // read after stream_tiles' barrier
    keep = n <= PA_WINDOW && nv * tpb * PA_TILE_KEYS <= cap;
    stream_tiles<T, E, true, false>(
        kp, vp, a.pos, a.bs, a.KV, h, list, nv * tpb, tpb, ring, pring,
        [&](int u, const char* ks, const char*, const int* ps, int kt) {
          const float s = tile_score<T, E>(qrow, ks, ps, kt, qp, lane);
          if (keep && !(lane & 1)) sc[u * PA_TILE_KEYS + j] = s;
          mloc = fmaxf(mloc, s);  // this lane's keys
        });
  }
  mloc = warp_max(mloc);

  // the split's max m_c: each CTA stores its max into every CTA's shared
  // memory, and each takes the max of them all (exact, any order)
  cluster_wait();
  if (lane < PF_CLUSTER) cluster.map_shared_rank(cmax, lane)[r * G + g] = mloc;
  cluster.sync();
  float mc = -INFINITY;
  for (int c = 0; c < PF_CLUSTER; ++c) mc = fmaxf(mc, cmax[c * G + g]);
  mc = fmaxf(mc, -1e30f);

  // pass 2: e rounded to combine_dtype before the sum and the V product
  float d = 0.f, o[E];
#pragma unroll
  for (int e = 0; e < E; ++e) o[e] = 0.f;
  auto use = [&](int u, const char* ks, const char* vs, const int* ps, int kt) {
    const float s = keep ? sc[u * PA_TILE_KEYS + j]
                         : tile_score<T, E>(qrow, ks, ps, kt, qp, lane);
    const float ex = round_to(expf(s - mc), combine);  // 0 for a masked key
    d += (lane & 1) ? 0.f : ex;  // this lane's keys
    accumulate_v<T, E>(vs, ex, kt, lane, o);
  };
  if (keep) {  // one window: its list is still in place
    stream_tiles<T, E, false, true>(kp, vp, a.pos, a.bs, a.KV, h, list, nv * tpb,
                                    tpb, ring, pring, use);
  } else {
    for (int w0 = 0; w0 < n; w0 += PA_WINDOW) {
      nv = compact(sl, w0, min(n, w0 + PA_WINDOW), list, wsum);
      stream_tiles<T, E, true, true>(kp, vp, a.pos, a.bs, a.KV, h, list, nv * tpb,
                                     tpb, ring, pring, use);
    }
  }
  d = warp_sum(d);

  // the cluster's partials summed in rank order into the split's: rank c
  // sums elements [c * SLICE, (c + 1) * SLICE) of o (lanes [c * LPR,
  // (c + 1) * LPR) store theirs into its shared memory), and every rank d
  constexpr int LPR = 32 / PF_CLUSTER, SLICE = LPR * E;
  constexpr int SLOT = slot_floats<E, PF_CLUSTER, 1>();  // d, o slice
  float* recv = reinterpret_cast<float*>(smem + L.recv);  // [PF_CLUSTER][G][SLOT]
  float* mine = cluster.map_shared_rank(recv, lane / LPR) + ((size_t)r * G + g) * SLOT;
  if (lane % LPR == 0) mine[0] = d;
#pragma unroll
  for (int e = 0; e < E; ++e) mine[1 + (lane % LPR) * E + e] = o[e];
  cluster.sync();  // every rank's stores are visible; none is read remotely after
  if (lane < LPR) {
    float dd = 0.f, O[E];
#pragma unroll
    for (int e = 0; e < E; ++e) O[e] = 0.f;
    for (int c = 0; c < PF_CLUSTER; ++c) {
      const float* p = recv + ((size_t)c * G + g) * SLOT;
      dd += p[0];
#pragma unroll
      for (int e = 0; e < E; ++e) O[e] += p[1 + lane * E + e];
    }
    const size_t row = (((size_t)b * a.KV + h) * splits + sp) * G + g;
    if (r == 0 && lane == 0) {
      m_part[row] = mc;
      d_part[row] = dd;
    }
#pragma unroll
    for (int e = 0; e < E; ++e) o_part[row * D + r * SLICE + lane * E + e] = O[e];
  }
}

// Merges the splits in f32 in split order.  Grid (B, KV),
// 32 * G threads.
// det: fastpath
template <int E>
__global__ void paged_merge_kernel(const float* __restrict__ m_part,
                                   const float* __restrict__ d_part,
                                   const float* __restrict__ o_part, int H,
                                   int KV, int D, int splits,
                                   float* __restrict__ out) {
  // launched as a programmatic dependent of the split kernel: wait until
  // that grid has completed and its workspace writes are visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
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

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

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

// Launch with E = D / 32 as a compile-time constant.  B enters the grid
// only as its count of rows.
template <typename T, int E>
cudaError_t launch_commit(const void* q, const void* kp, const void* vp,
                          const PagedArgs& a, float* out, int B,
                          cudaStream_t s) {
  static int granted = 48 * 1024;
  const int G = a.H / a.KV;
  const int smem = layout<T, E>(G, false).bytes;
  const cudaError_t e = allow_smem(paged_attention_kernel<T, E>, smem, &granted);
  if (e != cudaSuccess) return e;
  paged_attention_kernel<T, E><<<dim3(PA_CLUSTER, a.KV, B), 32 * G, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), a, out);
  return cudaGetLastError();
}

template <typename T, int E>
cudaError_t launch_fast(const void* q, const void* kp, const void* vp,
                        const PagedArgs& a, int combine, float* mp, float* dp,
                        float* op, float* out, int B, int splits,
                        cudaStream_t s) {
  static int granted = 48 * 1024;
  const int G = a.H / a.KV;
  const int smem = layout<T, E>(G, true).bytes;
  cudaError_t e = allow_smem(paged_split_kernel<T, E>, smem, &granted);
  if (e != cudaSuccess) return e;
  paged_split_kernel<T, E><<<dim3(PF_CLUSTER * splits, a.KV, B), 32 * G, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), a, splits, combine, mp, dp, op);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // a programmatic dependent launch: the merge grid is set up while the
  // split grid runs, and waits for it in griddepcontrol.wait
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B, a.KV);
  cfg.blockDim = dim3(32 * G);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, paged_merge_kernel<E>, static_cast<const float*>(mp),
                            static_cast<const float*>(dp), static_cast<const float*>(op),
                            a.H, a.KV, a.D, splits, out);
}

// What both kernels take (the wrapper checks the same before a launch).
bool shapes_ok(const void* q, const void* kp, const void* vp, int B, int H,
               int KV, int D, int bs, int nblk) {
  const int G = KV > 0 ? H / KV : 0;
  return B >= 0 && B <= 65535 && KV >= 1 && KV <= 65535 && H % KV == 0 &&
         G >= 1 && G <= 32 && D % 32 == 0 && D >= 32 && D <= 256 && bs >= 1 &&
         nblk >= 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(kp) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(vp) % 16 == 0;
}

}  // namespace

extern "C" int repro_paged_attention(const void* q, const void* kp,
                                     const void* vp, const void* pos,
                                     const void* tab, const void* qpos,
                                     void* out, int B, int H, int KV, int D,
                                     int bs, int nblk, float scale, int dtype,
                                     void* stream) {
  if (!shapes_ok(q, kp, vp, B, H, KV, D, bs, nblk)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
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
  if (!shapes_ok(q, kp, vp, B, H, KV, D, bs, nblk) || splits < 1 || nblk % splits)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
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
