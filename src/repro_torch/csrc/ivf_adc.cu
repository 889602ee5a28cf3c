// Bucket-resident IVF-ADC + top-k for Hopper (sm_90a): the per-query grid
// and the two grouped grids.
//
// Replaces the Pallas kernels of src/repro/kernels/ivf_adc.py: ivf_adc
// (body _ivf_adc_kernel), ivf_adc_blocked (_ivf_adc_blocked_kernel) and
// ivf_adc_run_resident (_ivf_adc_run_resident_kernel). For query q and
// visit step t all three score every slot of block b = visit[q, t]:
//   score = sum_j lut[q(, p), j, codes[b, slot, j]] + coarse[q, p],
//   p = t / steps_per_probe,
// knock out slots whose id is -1, and keep the best k per query. They
// return the same ids and scores, bit for bit (invariant 5 of
// docs/ARCHITECTURE.md).
//
// The TPU kernels turn the table lookup into a one-hot matrix product
// because Mosaic has no vector gather. Hopper gathers directly: a table
// (m * ksub entries in float32, bfloat16, or int8 with m scales) sits in
// shared memory and each lane looks its slot's codes up, reading the uint8
// codes as they are stored. What bounds every grid: one shared-memory
// lookup and one float32 add a term, m terms a scored slot, against the
// visited code blocks read once, blk * (m + 4) bytes each.
//
// Per-query grid (ivf_adc_partial): one block per (query, chunk of visit
// steps), so a single query still fills the SMs; each of the 8 warps takes
// one visit step at a time, one slot a lane, reading the codes from device
// memory.
//
// Grouped grids (ivf_adc_tiles): build_block_schedule (core/ivf.py) sorts
// the (query, step) pairs by block and cuts each block's run into groups of
// qblk pairs, dropping the pairs that visit the pad block. On the TPU a grid
// step gathers a (qblk, m * ksub) panel of tables for the group's block; on
// Hopper the unit that stays resident is the table, and the code blocks
// stream past it:
// * A block owns a tile of qt table rows (queries for shared tables,
//   (query, probe) rows for per-probe tables) and stages their tables and
//   coarse terms in shared memory once, the tables by cp.async. qt comes
//   from the launch plan (kernels/ivf_adc.py grouped_plan, the byte count
//   of tile_layout below): as many tables as leave room for two blocks an
//   SM beside the code ring and the boards, at m = 64, ksub = 256: 1
//   float32, 2 bf16 or 4 int8 (2, 5 and 11 fit one block, but 8 warps an
//   SM leave the code stream's latency unhidden; PERF.md section 6 has the
//   times by tile width).
// * The wrapper buckets the scheduled pairs by tile, block order kept
//   within a tile (kernels/ivf_adc.py tile_index, cached with the
//   schedule): one 16-byte record a pair (block, query, step, and a head
//   flag beside the probe). A segment is a run of a tile's pairs that
//   share one fetch: one schedule group in the blocked grid, one schedule
//   run in the run-resident grid (at most kSegMax pairs; a longer one is
//   cut). Its first pair carries the head flag.
// * The tile's pairs are cut into chunks of chunk_pairs pairs, the same
//   for every tile (tile_index sizes them from the batch's pair count to
//   give a few waves of blocks), so that a tile spreads over the SMs
//   when there are fewer tiles than SMs (Q = 1: one tile) and a query with
//   many pairs does not hold up the grid; the grid has as many chunks a
//   tile as the largest tile needs, and a block whose chunk is empty
//   writes empty boards and leaves. A chunk's pairs are cut among the 8
//   warps; a segment belongs to the warp whose range holds its head. A warp reads
//   32 records at a time (one coalesced load), walks its segments, and
//   streams each segment's code block (blk * m bytes) and slot ids through
//   a two-stage cp.async ring of its own: the next segment's copy is in
//   flight while the warp scores the current one, one pair at a time, one
//   slot a lane, against the pair's table in shared memory. Where m is a
//   multiple of 16 a block's 16-byte code chunks are swizzled within a row,
//   so that a quarter warp's 16-byte reads hit distinct banks, and a lane
//   issues 16 lookups before their adds; otherwise a lane reads its row by
//   words (m a multiple of 4) or bytes. No barrier in the loop.
// * Scores go straight to boards: one sorted board a tile row in shared
//   memory (SortedBoard's layout, topk_board.cuh) behind a threshold, its
//   k-th entry packed into one 64-bit word that a warp reads with one load.
//   A warp keeps the candidates that beat the threshold in a list of 32 of
//   its own and, when the list is full (or the row changes, or at the
//   end), takes the row's lock and folds them in as one bitonic batch:
//   early on nearly every pair has a beater, and one fold a pair,
//   serialized by the lock, cost more than the lookups at Q = 32. A chunk writes its
//   rows' boards to part_*, and ivf_adc_merge_slices / ivf_adc_merge_sorted
//   fold each query's boards (its probes' rows x chunks) in one or two
//   levels. Two launches a call (three with the first merge level); nothing
//   is written per pair.
// The two grids differ only in the fetch unit: the run-resident grid reads
// a block once per (tile, run), the blocked grid once per (tile, group).
// What bounds them on phase 4 of chip_smoke.py is the lookups: random codes
// meet about 3.5 lanes on one bank, so a warp's lookup takes about 3.5
// shared-memory cycles; the kernel runs at about 6 lookups a clock per SM.
//
// Numbers: each slot sums its m terms in j order in float32 with
// __fadd_rn, and the int8 term is __fmul_rn(q8, scale), so no multiply-add
// is contracted (adc_lut.cuh); the coarse term is added last. Every grid
// and the plain versions in kernels/ivf_adc.py do the same operations in
// the same order.
//
// Skipped work: a slot with id -1 (pad or tombstone) and a probe whose
// coarse term is at or below NEG_INF/2 (a knocked-out probe) are not
// scored. The reference scores them near NEG_INF and its wrapper turns any
// such score into (-inf, -1); an unfilled board entry ends as the same
// (-inf, -1), after every real candidate, so the result is the same.
//
// Top-k: boards (topk_board.cuh) are keyed by the visit position
// t * blk + slot, and the merges map positions back to row ids. Ties: the
// lower visit position first, as the reference's top-k over the visit
// order gives, whatever order the pairs were scored in.
#include "adc_lut.cuh"
#include "topk_board.cuh"

using namespace thistle;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSegMax = 16;  // pairs of a segment at most (kernels/ivf_adc.py SEG_MAX)
constexpr int kMergeThreads = 256;

size_t partial_smem(int dt, int m, int ksub, int k) {
  return (sizeof(float) + sizeof(int)) * (size_t)kWarps * k + sizeof(float) * (size_t)m +
         lut_bytes(dt) * (size_t)m * ksub;
}

// Warp 0 folds the other warps' boards into its own and writes the raw
// result to part_* at `off`.
__device__ void fold_warps_and_write(WarpBoard& board, const float* board_s,
                                     const int* board_key, int k, float* part_s,
                                     int* part_key, long off) {
  __syncthreads();
  if ((threadIdx.x >> 5) == 0) {
    fold_parts(board, board_s + k, board_key + k, (long)(kWarps - 1) * k);
    board.write_raw(part_s + off, part_key + off);
  }
}

template <int DT>
__global__ void __launch_bounds__(kThreads)
    ivf_adc_partial(const uint8_t* __restrict__ codes, const int* __restrict__ ids,
                    const int* __restrict__ visit, const void* __restrict__ luts,
                    const float* __restrict__ scales, const float* __restrict__ coarse, int T,
                    int blk, int m, int ksub, int spp, int per_probe, int k, int steps_per_chunk,
                    float* __restrict__ part_s, int* __restrict__ part_key) {
  using LT = typename LutT<DT>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  float* board_s = reinterpret_cast<float*>(smem);                  // [kWarps][k]
  int* board_key = reinterpret_cast<int*>(board_s + kWarps * k);    // [kWarps][k]
  float* sc = reinterpret_cast<float*>(board_key + kWarps * k);     // [m]
  LT* lut = reinterpret_cast<LT*>(sc + m);                          // [m * ksub]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q = blockIdx.x;
  const int chunk = blockIdx.y;
  const int nprobe = T / spp;
  const int t_begin = chunk * steps_per_chunk;
  const int t_end = min(T, t_begin + steps_per_chunk);
  const int table = m * ksub;

  WarpBoard board;
  board.init(board_s + warp * k, board_key + warp * k, k);

  int loaded = -1;  // probe whose table is in shared memory
  for (int p = t_begin / spp; t_begin < t_end && p <= (t_end - 1) / spp; ++p) {
    const float cp = coarse[(long)q * nprobe + p];
    if (cp <= 0.5f * kNegInf) continue;  // knocked-out probe (block-uniform)
    if (loaded < 0 || per_probe) {
      __syncthreads();  // every warp is done with the previous table
      const long row = per_probe ? (long)q * nprobe + p : (long)q;
      const LT* src = static_cast<const LT*>(luts) + row * table;
      for (int e = tid; e < table; e += kThreads) lut[e] = src[e];
      if (DT == kI8)
        for (int e = tid; e < m; e += kThreads) sc[e] = scales[row * m + e];
      __syncthreads();
      loaded = p;
    }
    const int ta = max(t_begin, p * spp);
    const int tb = min(t_end, (p + 1) * spp);
    for (int t = ta + warp; t < tb; t += kWarps) {
      const long b = visit[(long)q * T + t];
      for (int s0 = 0; s0 < blk; s0 += 32) {
        const int slot = s0 + lane;
        const int id = slot < blk ? ids[b * blk + slot] : -1;
        float s = 0.f;
        if (id >= 0)
          s = __fadd_rn(adc_sum<DT, false, true>(codes + (b * blk + slot) * m, m, ksub, lut, sc),
                        cp);
        board.fold_lanes(s, t * blk + slot, id >= 0);
      }
    }
  }
  fold_warps_and_write(board, board_s, board_key, k, part_s, part_key,
                       ((long)q * gridDim.y + chunk) * k);
}

// ------------------------------------------------------------ grouped grids

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) / 16 * 16; }

// Byte offsets of a tile block's shared memory: qt tables (each 16-byte
// aligned), the code ring (kWarps x 2 stages of a block's codes and slot
// ids), then qt each of: packed thresholds (8 bytes), sorted boards of
// P = 32 sorted_slots(k) entries (scores, then keys), locks, the row's cw
// coarse terms (nprobe for a shared table, 1 for a per-probe one); each
// warp's candidate list (32 scores and keys); the int8 scales (m floats a
// row). kernels/ivf_adc.py tile_smem_bytes mirrors `total`.
struct TileLayout {
  size_t tstride;  // bytes a table
  size_t codes;    // bytes of a stage's codes; its slot ids follow
  size_t stage;    // bytes a stage
  size_t ring, thr, board_s, board_key, lock, coarse, cand, scales, total;
};

__host__ __device__ inline TileLayout tile_layout(int esize, bool i8, int qt, int m, int ksub,
                                                  int blk, int k, int cw) {
  TileLayout L;
  const size_t P = 32 * (size_t)sorted_slots(k);
  L.tstride = align16((size_t)esize * m * ksub);
  L.codes = align16((size_t)blk * m);
  L.stage = L.codes + align16((size_t)4 * blk);
  L.ring = (size_t)qt * L.tstride;
  L.thr = L.ring + (size_t)kWarps * 2 * L.stage;
  L.board_s = L.thr + 8 * (size_t)qt;
  L.board_key = L.board_s + 4 * (size_t)qt * P;
  L.lock = L.board_key + 4 * (size_t)qt * P;
  L.coarse = L.lock + 4 * (size_t)qt;
  L.cand = L.coarse + 4 * (size_t)qt * cw;
  L.scales = L.cand + (size_t)kWarps * 32 * 8;
  L.total = L.scales + (i8 ? 4 * (size_t)qt * m : 0);
  return L;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// (score, key) as one 64-bit word of the boards' order: a candidate beats
// a threshold exactly when its word is greater. The score maps to an
// unsigned int of the same order (-0.0 as +0.0, which `better` compares
// equal), the key to 0x7fffffff - key (the lower key first).
__device__ __forceinline__ unsigned long long pack(float s, int key) {
  unsigned u = __float_as_uint(s + 0.0f);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (unsigned)(0x7fffffff - key);
}

// The 16-byte chunk of a code row that chunk h of row r is stored at: h
// XOR a function of r that gives the eight rows of a quarter warp eight
// distinct bank groups when the row's cpr = m / 16 chunks are a power of
// two (cpr = 4: (r >> 1) & 3); identity otherwise.
__device__ __forceinline__ int swizzle(int r, int cpr) {
  return (cpr & (cpr - 1)) == 0 ? ((r * cpr) >> 3) & (cpr - 1) : 0;
}

// Slot `slot`'s score from a staged, swizzled code block (m a multiple of
// 16): 16 lookups issued, then their 16 adds in j order.
template <int DT>
__device__ __forceinline__ float staged_sum(const unsigned char* stage, int slot, int m,
                                            int ksub, const typename LutT<DT>::T* tab,
                                            const float* sc) {
  const int cpr = m >> 4;
  const int swz = swizzle(slot, cpr);
  const unsigned char* row = stage + (size_t)slot * m;
  float acc = -0.0f;
  for (int h = 0; h < cpr; ++h) {
    const uint4 c = *reinterpret_cast<const uint4*>(row + ((h ^ swz) << 4));
    const uint32_t w[4] = {c.x, c.y, c.z, c.w};
    float t[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const int j = 16 * h + u;
      t[u] = lut_term<DT, false>(tab, (long)j * ksub + ((w[u >> 2] >> (8 * (u & 3))) & 0xffu),
                                 scale_of<DT, false>(sc, j));
    }
#pragma unroll
    for (int u = 0; u < 16; ++u) acc = __fadd_rn(acc, t[u]);
  }
  return acc;
}

// One warp folds its lanes' candidates ((-inf, kEmptyKey) = none) into a
// tile row's board under the row's lock, and moves the row's threshold.
template <int E>
__device__ __forceinline__ void fold_locked(float* bs, int* bk, unsigned long long* thr,
                                            int* lock, float cs, int ck, int k) {
  const int lane = threadIdx.x & 31;
  if (lane == 0)
    while (atomicCAS(lock, 0, 1) != 0) {
    }
  __syncwarp();
  __threadfence_block();
  SortedBoard<E> b;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    b.s[e] = reinterpret_cast<volatile float*>(bs)[e * 32 + lane];
    b.key[e] = reinterpret_cast<volatile int*>(bk)[e * 32 + lane];
  }
  b.offer(cs, ck, k);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    bs[e * 32 + lane] = b.s[e];
    bk[e * 32 + lane] = b.key[e];
    if (e * 32 + lane == k - 1)
      *reinterpret_cast<volatile unsigned long long*>(thr) = pack(b.s[e], b.key[e]);
  }
  __threadfence_block();
  __syncwarp();
  if (lane == 0) atomicExch(lock, 0);
}

// The same as a call, for boards of E = sorted_slots(k) slots a lane: the
// board's registers stay out of the scoring loop (folds are rare once the
// threshold has risen).
__device__ __noinline__ void fold_call(int E, float* bs, int* bk, unsigned long long* thr,
                                       int* lock, float cs, int ck, int k) {
  switch (E) {
    case 1: fold_locked<1>(bs, bk, thr, lock, cs, ck, k); break;
    case 2: fold_locked<2>(bs, bk, thr, lock, cs, ck, k); break;
    case 4: fold_locked<4>(bs, bk, thr, lock, cs, ck, k); break;
    default: fold_locked<8>(bs, bk, thr, lock, cs, ck, k); break;
  }
}

// The grouped grids' scoring pass: block (tile, chunk) scores the segments
// whose head lies in chunk `chunk` (chunk_pairs pairs) of tile `tile`'s
// pairs, [tile_pairs[tile], tile_pairs[tile + 1]) of `meta`, and writes
// each of its rows' best k to part_*[(row * n_chunks + chunk) * k],
// row = q or q * nprobe + p, n_chunks = gridDim.y. VEC:
// blk * m % 16 == 0 and blk % 4 == 0 with 16-byte aligned codes and ids,
// whose blocks come by cp.async (swizzled where m % 16 == 0); otherwise
// byte by byte.
template <int DT, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
    ivf_adc_tiles(const uint8_t* __restrict__ codes, const int* __restrict__ ids,
                  const void* __restrict__ luts_v, const float* __restrict__ scales,
                  const float* __restrict__ coarse, const int4* __restrict__ meta,
                  const int* __restrict__ tile_pairs, int rows, int nprobe, int per_probe,
                  int blk, int m, int ksub, int qt, int k, int chunk_pairs,
                  float* __restrict__ part_s, int* __restrict__ part_key) {
  using LT = typename LutT<DT>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  const int cw = per_probe ? 1 : nprobe;  // coarse terms a table row
  const TileLayout L = tile_layout(sizeof(LT), DT == kI8, qt, m, ksub, blk, k, cw);
  LT* tab = reinterpret_cast<LT*>(smem);
  unsigned long long* thr = reinterpret_cast<unsigned long long*>(smem + L.thr);
  float* board_s = reinterpret_cast<float*>(smem + L.board_s);
  int* board_key = reinterpret_cast<int*>(smem + L.board_key);
  int* lock = reinterpret_cast<int*>(smem + L.lock);
  float* cs = reinterpret_cast<float*>(smem + L.coarse);
  float* sc = reinterpret_cast<float*>(smem + L.scales);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* cand_s = reinterpret_cast<float*>(smem + L.cand) + warp * 64;  // [32]
  int* cand_key = reinterpret_cast<int*>(cand_s + 32);                 // [32]
  const int tile = blockIdx.x;
  const int chunk = blockIdx.y;
  const int n_chunks = gridDim.y;
  const int r0 = tile * qt;
  const int nr = min(qt, rows - r0);
  const int E = sorted_slots(k);
  const int P = 32 * E;
  const int table = m * ksub;
  const size_t tstride = L.tstride / sizeof(LT);  // entries

  // ---- this chunk of the tile's pairs; an empty one has empty boards
  const int pb = tile_pairs[tile];
  const int pe = tile_pairs[tile + 1];
  const int ca = (int)min((long)pe, pb + (long)chunk * chunk_pairs);
  const int cb = min(pe, ca + chunk_pairs);
  if (ca == cb) {  // block-uniform
    for (int r = warp; r < nr; r += kWarps) {
      const size_t off = ((size_t)(r0 + r) * n_chunks + chunk) * k;
      for (int e = lane; e < k; e += 32) {
        part_s[off + e] = -INFINITY;
        part_key[off + e] = kEmptyKey;
      }
    }
    return;
  }

  // ---- the tile's tables, coarse terms, int8 scales and empty boards
  const LT* luts = static_cast<const LT*>(luts_v);
  const size_t tb = sizeof(LT) * (size_t)table;
  if (tb % 16 == 0) {
    const int per = (int)(tb / 16);
    for (int e = tid; e < nr * per; e += kThreads) {
      const int r = e / per;
      const int c = e - r * per;
      cp_async16(reinterpret_cast<unsigned char*>(tab + r * tstride) + 16 * c,
                 reinterpret_cast<const unsigned char*>(luts + (size_t)(r0 + r) * table) +
                     16 * c);
    }
  } else {
    for (int e = tid; e < nr * table; e += kThreads) {
      const int r = e / table;
      tab[r * tstride + (e - r * table)] = luts[(size_t)r0 * table + e];
    }
  }
  cp_async_commit();
  for (int e = tid; e < nr * cw; e += kThreads) cs[e] = coarse[(size_t)r0 * cw + e];
  if (DT == kI8)
    for (int e = tid; e < nr * m; e += kThreads) sc[e] = scales[(size_t)r0 * m + e];
  for (int e = tid; e < qt * P; e += kThreads) {
    board_s[e] = -INFINITY;
    board_key[e] = kEmptyKey;
  }
  for (int r = tid; r < qt; r += kThreads) {
    thr[r] = pack(-INFINITY, kEmptyKey);
    lock[r] = 0;
  }

  // ---- this warp's range of the chunk
  const int per_w = (cb - ca + kWarps - 1) / kWarps;
  const int wa = min(cb, ca + warp * per_w);
  const int wb = min(cb, wa + per_w);
  cp_async_wait<0>();
  __syncthreads();

  unsigned char* ring = smem + L.ring + (size_t)warp * 2 * L.stage;
  const bool swz = m % 16 == 0;  // staged swizzled, read 16 bytes at a time
  // block b's codes and slot ids into stage `stg` of this warp's ring
  auto fetch = [&](int b, int stg) {
    unsigned char* dst = ring + (size_t)stg * L.stage;
    const uint8_t* src = codes + (size_t)b * blk * m;
    int* dst_id = reinterpret_cast<int*>(dst + L.codes);
    if (VEC && swz) {
      const int cpr = m >> 4;
      for (int e = lane; e < blk * cpr; e += 32) {
        const int r = e / cpr;
        const int h = e - r * cpr;
        cp_async16(dst + (size_t)r * m + ((h ^ swizzle(r, cpr)) << 4), src + 16 * (size_t)e);
      }
    } else if (VEC) {
      for (int e = lane; e < blk * m / 16; e += 32) cp_async16(dst + 16 * e, src + 16 * (size_t)e);
    }
    if (VEC) {
      for (int e = lane; e < blk / 4; e += 32)
        cp_async16(dst_id + 4 * e, ids + (size_t)b * blk + 4 * e);
    } else {
      for (int e = lane; e < blk * m; e += 32) dst[e] = src[e];
      for (int e = lane; e < blk; e += 32) dst_id[e] = ids[(size_t)b * blk + e];
    }
  };

  // A window of 32 records from `base`, one a lane; positions past the
  // tile's end read as heads (segment ends).
  int base = wa;
  int4 rec;
  unsigned heads;
  auto load_window = [&](int at) {
    base = at;
    const int i = at + lane;
    rec = i < pe ? __ldg(meta + i) : make_int4(0, 0, 0, 1);
    heads = __ballot_sync(kFullMask, rec.w & 1);
  };
  // The warp's candidate list: up to 32 candidates of row `row_c` that
  // beat its threshold when they were scored, folded as one batch when the
  // list is full, when a candidate of another row comes, and at the end.
  int n_c = 0;  // warp-uniform
  int row_c = 0;
  auto flush = [&]() {
    if (n_c == 0) return;
    __syncwarp();
    const bool in = lane < n_c;
    fold_call(E, board_s + (size_t)row_c * P, board_key + (size_t)row_c * P, thr + row_c,
              lock + row_c, in ? cand_s[lane] : -INFINITY, in ? cand_key[lane] : kEmptyKey, k);
    n_c = 0;
  };

  load_window(wa);
  // the first head at or after wa: a segment holds at most kSegMax pairs,
  // so there is one within the window
  int s = base + __ffs(heads) - 1;
  if (s < wb) fetch(__shfl_sync(kFullMask, rec.x, s - base), 0);
  cp_async_commit();
  for (int n = 0; s < wb; ++n) {  // warp-uniform
    const int ls = s - base;  // <= 31 - kSegMax: the segment and its end are in the window
    const unsigned after = heads & ~((2u << ls) - 1u);
    const int e = after ? base + __ffs(after) - 1 : base + 32;
    if (e < wb) fetch(__shfl_sync(kFullMask, rec.x, e - base), (n + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();  // this segment's block has landed
    __syncwarp();
    const unsigned char* stage = ring + (size_t)(n & 1) * L.stage;
    const int* sid = reinterpret_cast<const int*>(stage + L.codes);
    for (int i = s; i < e; ++i) {
      const int q = __shfl_sync(kFullMask, rec.y, i - base);
      const int t = __shfl_sync(kFullMask, rec.z, i - base);
      const int p = __shfl_sync(kFullMask, rec.w, i - base) >> 1;
      const int rl = (per_probe ? q * nprobe + p : q) - r0;
      const float cp = cs[rl * cw + (per_probe ? 0 : p)];
      if (cp <= 0.5f * kNegInf) continue;  // knocked-out probe (warp-uniform)
      const LT* tabr = tab + rl * tstride;
      const float* scr = sc + (size_t)rl * m;
      for (int s0 = 0; s0 < blk; s0 += 32) {
        const int slot = s0 + lane;
        const int id = slot < blk ? sid[slot] : -1;
        float score = -INFINITY;
        if (id >= 0) {
          const float a = VEC && swz ? staged_sum<DT>(stage, slot, m, ksub, tabr, scr)
                              : adc_sum<DT, false, false>(stage + (size_t)slot * m, m, ksub,
                                                          tabr, scr);
          score = __fadd_rn(a, cp);
        }
        const int key = t * blk + slot;
        const unsigned long long th = *reinterpret_cast<volatile unsigned long long*>(thr + rl);
        const bool beat = id >= 0 && pack(score, key) > th;
        const unsigned bm = __ballot_sync(kFullMask, beat);
        if (bm) {  // warp-uniform
          if (rl != row_c || n_c + __popc(bm) > 32) {
            flush();
            row_c = rl;
          }
          if (beat) {
            const int pos = n_c + __popc(bm & ((1u << lane) - 1u));
            cand_s[pos] = score;
            cand_key[pos] = key;
          }
          n_c += __popc(bm);
          if (n_c == 32) flush();
        }
      }
    }
    __syncwarp();  // the stage is read before the next fetch refills it
    s = e;
    if (s < wb && s - base > 31 - kSegMax) load_window(s);
  }
  flush();
  cp_async_wait<0>();
  __syncthreads();

  for (int r = warp; r < nr; r += kWarps) {
    const size_t off = ((size_t)(r0 + r) * n_chunks + chunk) * k;
    for (int e = lane; e < k; e += 32) {
      part_s[off + e] = board_s[(size_t)r * P + e];
      part_key[off + e] = board_key[(size_t)r * P + e];
    }
  }
}

// Visit position -> global row id, through the visited block's slot ids.
struct SlotId {
  const int* ids;
  const int* visit_row;
  int blk;
  __device__ int operator()(int key) const {
    if (key == kEmptyKey) return -1;
    return ids[(long)visit_row[key / blk] * blk + key % blk];
  }
};

__global__ void __launch_bounds__(kThreads)
    ivf_adc_merge(const float* __restrict__ part_s, const int* __restrict__ part_key,
                  const int* __restrict__ ids, const int* __restrict__ visit, int Q, int T,
                  int blk, int n_chunks, int k, float* __restrict__ out_s,
                  int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int q = blockIdx.x * kWarps + warp;
  if (q >= Q) return;  // warp-uniform
  float* bs = reinterpret_cast<float*>(smem) + warp * k;
  int* bk = reinterpret_cast<int*>(reinterpret_cast<float*>(smem) + kWarps * k) + warp * k;
  WarpBoard board;
  board.init(bs, bk, k);
  const long total = (long)n_chunks * k;
  fold_parts(board, part_s + q * total, part_key + q * total, total);
  board.write_sorted(out_s + (long)q * k, out_i + (long)q * k,
                     SlotId{ids, visit + (long)q * T, blk});
}

// The grouped grids' merge, first level: block (q, g) folds slice g of
// query q's boards into one raw board (merge_slice, topk_board.cuh).
template <int E>
__global__ void __launch_bounds__(kMergeThreads)
    ivf_adc_merge_slices(const float* __restrict__ part_s, const int* __restrict__ part_key,
                         int n_parts, int groups, int k, float* __restrict__ slice_s,
                         int* __restrict__ slice_key) {
  extern __shared__ __align__(16) unsigned char smem[];
  merge_slice<E>(part_s, part_key, n_parts, groups, k, smem, slice_s, slice_key);
}

// The last level: one block a query folds its boards and writes its top-k,
// best first, visit positions mapped to row ids.
template <int E>
__global__ void __launch_bounds__(kMergeThreads)
    ivf_adc_merge_sorted(const float* __restrict__ part_s, const int* __restrict__ part_key,
                         const int* __restrict__ ids, const int* __restrict__ visit, int T,
                         int blk, int n_parts, int k, float* __restrict__ out_s,
                         int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  merge_query<E>(part_s, part_key, n_parts, k, smem, out_s, out_i,
                 SlotId{ids, visit + (long)blockIdx.x * T, blk}, SameScore{});
}

template <int DT>
int launch_partial(const void* codes, const void* ids, const void* visit, const void* luts,
                   const void* scales, const void* coarse, int Q, int T, int blk, int m, int ksub,
                   int spp, int per_probe, int k, int n_chunks, int steps_per_chunk,
                   void* part_s, void* part_key, cudaStream_t st) {
  const size_t smem = partial_smem(DT, m, ksub, k);
  cudaError_t err = cudaFuncSetAttribute(ivf_adc_partial<DT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Q, n_chunks);
  ivf_adc_partial<DT><<<grid, kThreads, smem, st>>>(
      static_cast<const uint8_t*>(codes), static_cast<const int*>(ids),
      static_cast<const int*>(visit), luts, static_cast<const float*>(scales),
      static_cast<const float*>(coarse), T, blk, m, ksub, spp, per_probe, k, steps_per_chunk,
      static_cast<float*>(part_s), static_cast<int*>(part_key));
  return (int)cudaGetLastError();
}

int launch_merge(const void* part_s, const void* part_key, const void* ids, const void* visit,
                 int Q, int T, int blk, int n_chunks, int k, void* out_s, void* out_i,
                 cudaStream_t st) {
  const size_t smem = (sizeof(float) + sizeof(int)) * kWarps * (size_t)k;
  ivf_adc_merge<<<(Q + kWarps - 1) / kWarps, kThreads, smem, st>>>(
      static_cast<const float*>(part_s), static_cast<const int*>(part_key),
      static_cast<const int*>(ids), static_cast<const int*>(visit), Q, T, blk, n_chunks, k,
      static_cast<float*>(out_s), static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}

template <int DT, bool VEC>
int launch_tiles(const void* codes, const void* ids, const void* luts, const void* scales,
                 const void* coarse, const void* meta, const void* tile_pairs, int rows,
                 int nprobe, int per_probe, int blk, int m, int ksub, int qt, int k,
                 int chunk_pairs, int n_chunks, void* part_s, void* part_key,
                 cudaStream_t st) {
  using LT = typename LutT<DT>::T;
  const size_t smem =
      tile_layout(sizeof(LT), DT == kI8, qt, m, ksub, blk, k, per_probe ? 1 : nprobe).total;
  cudaError_t err = cudaFuncSetAttribute(ivf_adc_tiles<DT, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((rows + qt - 1) / qt, n_chunks);
  ivf_adc_tiles<DT, VEC><<<grid, kThreads, smem, st>>>(
      static_cast<const uint8_t*>(codes), static_cast<const int*>(ids), luts,
      static_cast<const float*>(scales), static_cast<const float*>(coarse),
      static_cast<const int4*>(meta), static_cast<const int*>(tile_pairs), rows, nprobe,
      per_probe, blk, m, ksub, qt, k, chunk_pairs, static_cast<float*>(part_s),
      static_cast<int*>(part_key));
  return (int)cudaGetLastError();
}

template <int DT>
int launch_tiles_dt(bool vec, const void* codes, const void* ids, const void* luts,
                    const void* scales, const void* coarse, const void* meta,
                    const void* tile_pairs, int rows, int nprobe, int per_probe, int blk,
                    int m, int ksub, int qt, int k, int chunk_pairs, int n_chunks,
                    void* part_s, void* part_key, cudaStream_t st) {
  if (vec)
    return launch_tiles<DT, true>(codes, ids, luts, scales, coarse, meta, tile_pairs, rows,
                                  nprobe, per_probe, blk, m, ksub, qt, k, chunk_pairs, n_chunks,
                                  part_s, part_key, st);
  return launch_tiles<DT, false>(codes, ids, luts, scales, coarse, meta, tile_pairs, rows,
                                 nprobe, per_probe, blk, m, ksub, qt, k, chunk_pairs, n_chunks,
                                 part_s, part_key, st);
}

// Both levels of the grouped grids' merge for boards held in E slots a lane.
template <int E>
int launch_sorted_merge(const float* part_s, const int* part_key, const int* ids,
                        const int* visit, int Q, int T, int blk, int n_parts, int k, int groups,
                        float* slice_s, int* slice_key, float* out_s, int* out_i,
                        cudaStream_t st) {
  const size_t smem = (sizeof(float) + sizeof(int)) * (kMergeThreads / 32) * (size_t)k;
  if (groups > 1) {
    ivf_adc_merge_slices<E><<<dim3(Q, groups), kMergeThreads, smem, st>>>(
        part_s, part_key, n_parts, groups, k, slice_s, slice_key);
    part_s = slice_s;
    part_key = slice_key;
    n_parts = groups;
  }
  ivf_adc_merge_sorted<E><<<Q, kMergeThreads, smem, st>>>(part_s, part_key, ids, visit, T, blk,
                                                          n_parts, k, out_s, out_i);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

size_t ivf_adc_smem_bytes(int lut_type, int m, int ksub, int k) {
  return partial_smem(lut_type, m, ksub, k);
}

// Shared memory bytes of one grouped-grid tile block (the plan's `smem`);
// cw = coarse terms a table row (nprobe, or 1 with per-probe tables).
size_t ivf_adc_grouped_smem(int lut_type, int qt, int m, int ksub, int blk, int k, int cw) {
  return tile_layout((int)lut_bytes(lut_type), lut_type == kI8, qt, m, ksub, blk, k, cw).total;
}

// codes (B, blk, m) uint8; ids (B, blk) int32 (-1 = pad); visit (Q, T)
// int32; luts (Q, [nprobe,] m, ksub) in float32, bfloat16 or int8
// (lut_type 0, 1, 2) with scales (Q, [nprobe,] m) float32 for int8;
// coarse (Q, nprobe) float32; part_* (Q, n_chunks, k) scratch; out_s
// (Q, k) float32, out_i (Q, k) int32. Returns the CUDA error code.
int ivf_adc_launch(const void* codes, const void* ids, const void* visit, const void* luts,
                   const void* scales, const void* coarse, int Q, int T, int blk, int m, int ksub,
                   int spp, int per_probe, int lut_type, int k, int n_chunks,
                   int steps_per_chunk, void* part_s, void* part_key, void* out_s, void* out_i,
                   void* stream) {
  if (k < 1 || k > kMaxK || spp < 1 || T % spp != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  int err;
  switch (lut_type) {
    case kF32:
      err = launch_partial<kF32>(codes, ids, visit, luts, scales, coarse, Q, T, blk, m, ksub, spp,
                                 per_probe, k, n_chunks, steps_per_chunk, part_s, part_key, st);
      break;
    case kBF16:
      err = launch_partial<kBF16>(codes, ids, visit, luts, scales, coarse, Q, T, blk, m, ksub,
                                  spp, per_probe, k, n_chunks, steps_per_chunk, part_s, part_key,
                                  st);
      break;
    case kI8:
      err = launch_partial<kI8>(codes, ids, visit, luts, scales, coarse, Q, T, blk, m, ksub, spp,
                                per_probe, k, n_chunks, steps_per_chunk, part_s, part_key, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return launch_merge(part_s, part_key, ids, visit, Q, T, blk, n_chunks, k, out_s, out_i, st);
}

// The grouped grids (blocked and run-resident differ only in `meta`).
// meta (n_pairs, 4) int32, tile_pairs (tiles + 1,) int32, chunk_pairs and
// n_chunks (chunks a tile) are the pair index of kernels/ivf_adc.py
// tile_index for tiles of qt rows (rows = Q, or Q * nprobe with per-probe
// tables); part_* (Q, rows / Q * n_chunks, k) scratch, slice_* (Q, groups,
// k) scratch when groups > 1; codes, ids and luts 16-byte aligned; the
// other arguments as ivf_adc_launch. Returns the CUDA error code.
int ivf_adc_grouped_launch(const void* codes, const void* ids, const void* visit,
                           const void* luts, const void* scales, const void* coarse,
                           const void* meta, const void* tile_pairs, int Q, int T, int blk,
                           int m, int ksub, int spp, int per_probe, int lut_type, int k, int qt,
                           int chunk_pairs, int n_chunks, int groups, void* part_s, void* part_key,
                           void* slice_s, void* slice_key, void* out_s, void* out_i,
                           void* stream) {
  if (k < 1 || k > kMaxK || spp < 1 || T % spp != 0 || Q < 1 || qt < 1 || chunk_pairs < 1 ||
      n_chunks < 1 || n_chunks > 65535 || groups < 1 || groups > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int nprobe = T / spp;
  const int rows = per_probe ? Q * nprobe : Q;
  const bool vec = (long)blk * m % 16 == 0 && blk % 4 == 0;
  int err;
#define THISTLE_IVF_TILES(DT)                                                                \
  launch_tiles_dt<DT>(vec, codes, ids, luts, scales, coarse, meta, tile_pairs, rows, nprobe,  \
                      per_probe, blk, m, ksub, qt, k, chunk_pairs, n_chunks, part_s, part_key, \
                      st)
  switch (lut_type) {
    case kF32: err = THISTLE_IVF_TILES(kF32); break;
    case kBF16: err = THISTLE_IVF_TILES(kBF16); break;
    case kI8: err = THISTLE_IVF_TILES(kI8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef THISTLE_IVF_TILES
  if (err != cudaSuccess) return err;
  const int n_parts = (per_probe ? nprobe : 1) * n_chunks;
  const auto* ps = static_cast<const float*>(part_s);
  const auto* pk = static_cast<const int*>(part_key);
  const auto* id = static_cast<const int*>(ids);
  const auto* vi = static_cast<const int*>(visit);
  auto* ss = static_cast<float*>(slice_s);
  auto* sk = static_cast<int*>(slice_key);
  auto* os = static_cast<float*>(out_s);
  auto* oi = static_cast<int*>(out_i);
#define THISTLE_IVF_MERGE(E) \
  launch_sorted_merge<E>(ps, pk, id, vi, Q, T, blk, n_parts, k, groups, ss, sk, os, oi, st)
  switch (sorted_slots(k)) {
    case 1: return THISTLE_IVF_MERGE(1);
    case 2: return THISTLE_IVF_MERGE(2);
    case 4: return THISTLE_IVF_MERGE(4);
    default: return THISTLE_IVF_MERGE(8);
  }
#undef THISTLE_IVF_MERGE
}

const char* thistle_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
