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
// Both grids keep their tables resident and stream the code blocks past
// them with the helpers below: a block stages its table rows once by
// cp.async; each warp streams code blocks and slot ids through a two-stage
// cp.async ring of its own, swizzled within a row where m is a multiple of
// 16 so that a quarter warp's 16-byte reads hit distinct banks, and a lane
// issues 16 lookups before their adds (otherwise it reads its row by words,
// m a multiple of 4, or bytes); scores go to sorted boards behind a
// threshold (below); a chunk's boards are written raw and folded by the
// two-level merge (ivf_adc_merge_slices / ivf_adc_merge_sorted).
//
// Per-query grid (ivf_adc_rows): no schedule, no sort, no host sync. A
// table row is a query (shared tables) or a (query, probe) row (per-probe
// tables); block (row, chunk) takes the row's steps dealt to its chunk of
// n (kernels/ivf_adc.py query_plan: about one block an SM at Q = 1, fewer
// chunks a row as Q grows, one at Q = 512). Step j of the row's probe p
// goes to warp u / n of chunk u % n, u = (j + p V / P) mod V, V = 8 n
// virtual chunks, P the row's probes (kernels/ivf_adc.py step_owners):
// round robin, so the real steps, which sit at the front of each probe's
// range (the rest visit the shared all-pad block), spread within one step
// of even over the chunks and warps, and the probes' offsets spread the
// remainders. A warp reads 32 of its steps at a time, one a lane (across
// probes where it has few a probe: at Q = 1 one), with each step's coarse
// term, and ballots those that are neither the pad block nor in a
// knocked-out probe (coarse at or below NEG_INF/2); only those are fetched
// and scored, one slot a lane. Where the code ring does not
// fit beside the table and the board (m = 210 float32 at k = 256), a
// variant of the kernel reads each lane's code row and the int8 scales
// straight from device memory.
//
// Grouped grids (ivf_adc_tiles): build_block_schedule (core/ivf.py) sorts
// the (query, step) pairs by block and cuts each block's run into groups of
// qblk pairs, dropping the pairs that visit the pad block. On the TPU a grid
// step gathers a (qblk, m * ksub) panel of tables for the group's block; on
// Hopper the unit that stays resident is the table, and the code blocks
// stream past it:
// * A block owns a tile of qt table rows (queries for shared tables,
//   (query, probe) rows for per-probe tables) and stages their tables and
//   coarse terms in shared memory once. qt comes from the launch plan
//   (kernels/ivf_adc.py grouped_plan, the byte count of tile_layout
//   below): as many tables as leave room for two blocks an SM beside the
//   code ring and the boards, at m = 64, ksub = 256: 1 float32, 2 bf16 or
//   4 int8 (more fit one block, but 8 warps an SM leave the code stream's
//   latency unhidden; PERF.md section 6 has the times by tile width).
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
//   warps; a segment belongs to the warp whose range holds its head. A warp
//   reads 32 records at a time (one coalesced load), walks its segments,
//   and streams each segment's code block through its ring: the next
//   segment's copy is in flight while the warp scores the current one, one
//   pair at a time, against the pair's table. No barrier in the loop.
// The two grids differ only in the fetch unit: the run-resident grid reads
// a block once per (tile, run), the blocked grid once per (tile, group).
// What bounds them on phase 4 of chip_smoke.py is the lookups: random codes
// meet about 3.5 lanes on one bank, so a warp's lookup takes about 3.5
// shared-memory cycles; the kernel runs at about 6 lookups a clock per SM.
//
// Boards: one sorted board a table row in shared memory (SortedBoard's
// layout, topk_board.cuh) behind a threshold, its k-th entry packed into
// one 64-bit word that a warp reads with one load. A warp keeps the
// candidates that beat the threshold in a list of 32 of its own in shared
// memory and, when the list is full (or the row changes, or at the end),
// takes the row's lock and folds them in as one bitonic batch: early on
// nearly every slot beats, and one fold a block of codes, serialized by
// the lock, cost more than the lookups. The per-query grid's direct-read
// variant has no room for the lists and folds each 32 slots' beaters as
// they come. Nothing is written per pair or step.
//
// Numbers: each slot sums its m terms in j order in float32 with
// __fadd_rn, and the int8 term is __fmul_rn(q8, scale), so no multiply-add
// is contracted (adc_lut.cuh); the coarse term is added last. Every grid
// and the plain versions in kernels/ivf_adc.py do the same operations in
// the same order.
//
// Skipped work: a slot with id -1 (pad or tombstone) and a probe whose
// coarse term is at or below NEG_INF/2 (a knocked-out probe) are not
// scored, nor (per-query grid, given its id) a step on the pad block, all
// of whose slots are -1. The reference scores them near NEG_INF and its
// wrapper turns any such score into (-inf, -1); an unfilled board entry
// ends as the same (-inf, -1), after every real candidate, so the result is
// the same.
//
// Top-k: boards are keyed by the visit position t * blk + slot, and the
// merges map positions back to row ids. Ties: the lower visit position
// first, as the reference's top-k over the visit order gives, whatever
// order the steps or pairs were scored in.
#include "adc_lut.cuh"
#include "topk_board.cuh"

using namespace thistle;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSegMax = 16;  // pairs of a segment at most (kernels/ivf_adc.py SEG_MAX)
constexpr int kMergeThreads = 256;

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) / 16 * 16; }

// Byte offsets of a block's shared memory: qt tables (each 16-byte
// aligned), the code ring (kWarps x `stages` stages of a block's codes and
// slot ids; none in the per-query grid's direct-read variant), then qt
// each of: packed thresholds (8 bytes), sorted boards of P = 32
// sorted_slots(k) entries (scores, then keys), locks, the row's cw coarse
// terms (nprobe for a shared table, 1 for a per-probe one, 0 in the
// per-query grid, which reads them from device memory); each warp's
// candidate list (32 scores and keys) beside a ring; the int8 scales (m
// floats a row) where `i8`. kernels/ivf_adc.py tile_smem_bytes and
// query_smem_bytes mirror `total`.
struct TileLayout {
  size_t tstride;  // bytes a table
  size_t codes;    // bytes of a stage's codes; its slot ids follow
  size_t stage;    // bytes a stage
  size_t ring, thr, board_s, board_key, lock, coarse, cand, scales, total;
};

__host__ __device__ inline TileLayout tile_layout(int esize, bool i8, int qt, int m, int ksub,
                                                  int blk, int k, int cw, int stages) {
  TileLayout L;
  const size_t P = 32 * (size_t)sorted_slots(k);
  L.tstride = align16((size_t)esize * m * ksub);
  L.codes = align16((size_t)blk * m);
  L.stage = L.codes + align16((size_t)4 * blk);
  L.ring = (size_t)qt * L.tstride;
  L.thr = L.ring + (size_t)kWarps * stages * L.stage;
  L.board_s = L.thr + 8 * (size_t)qt;
  L.board_key = L.board_s + 4 * (size_t)qt * P;
  L.lock = L.board_key + 4 * (size_t)qt * P;
  L.coarse = L.lock + 4 * (size_t)qt;
  L.cand = L.coarse + 4 * (size_t)qt * cw;
  L.scales = L.cand + (stages ? (size_t)kWarps * 32 * 8 : 0);
  L.total = L.scales + (i8 ? 4 * (size_t)qt * m : 0);
  return L;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
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

// Slot `slot`'s score from a block staged in a ring: staged_sum where the
// block is swizzled (swz: 16-byte copies and m % 16 == 0), else adc_sum's
// words (m % 4 == 0) or bytes.
template <int DT>
__device__ __forceinline__ float ring_sum(bool swz, const unsigned char* stage, int slot, int m,
                                          int ksub, const typename LutT<DT>::T* tab,
                                          const float* sc) {
  return swz ? staged_sum<DT>(stage, slot, m, ksub, tab, sc)
             : adc_sum<DT, false, false>(stage + (size_t)slot * m, m, ksub, tab, sc);
}

// One warp copies block b's codes (blk x m bytes) and slot ids into one
// stage of its ring (the ids `codes_bytes` in). VEC (blk * m % 16 == 0,
// blk % 4 == 0, codes and ids 16-byte aligned): by cp.async, the codes
// swizzled where m % 16 == 0; otherwise byte by byte.
template <bool VEC>
__device__ __forceinline__ void fetch_block(unsigned char* dst, size_t codes_bytes,
                                            const uint8_t* codes, const int* ids, size_t b,
                                            int blk, int m) {
  const int lane = threadIdx.x & 31;
  const uint8_t* src = codes + b * blk * m;
  int* dst_id = reinterpret_cast<int*>(dst + codes_bytes);
  if (VEC && m % 16 == 0) {
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
    for (int e = lane; e < blk / 4; e += 32) cp_async16(dst_id + 4 * e, ids + b * blk + 4 * e);
  } else {
    for (int e = lane; e < blk * m; e += 32) dst[e] = src[e];
    for (int e = lane; e < blk; e += 32) dst_id[e] = ids[b * blk + e];
  }
}

// The block stages table rows [r0, r0 + nr) (`table` entries each) into
// shared memory rows of `tstride` entries: by cp.async, 16 bytes a copy,
// where a table is a whole number of 16-byte words (the wrapper aligns the
// tables), else by plain copies; and, where sc is given, their scales (m
// floats a row) by cp.async, 4 bytes a copy. The caller commits the group.
template <class T>
__device__ void stage_tables(T* tab, size_t tstride, const T* luts, size_t r0, int nr, int table,
                             const float* scales, float* sc, int m) {
  const size_t tb = sizeof(T) * (size_t)table;
  if (tb % 16 == 0) {
    const int per = (int)(tb / 16);
    for (int e = threadIdx.x; e < nr * per; e += blockDim.x) {
      const int r = e / per;
      const int c = e - r * per;
      cp_async16(reinterpret_cast<unsigned char*>(tab + r * tstride) + 16 * c,
                 reinterpret_cast<const unsigned char*>(luts + (r0 + r) * table) + 16 * c);
    }
  } else {
    for (int e = threadIdx.x; e < nr * table; e += blockDim.x) {
      const int r = e / table;
      tab[r * tstride + (e - r * table)] = luts[r0 * table + e];
    }
  }
  if (sc != nullptr)
    for (int e = threadIdx.x; e < nr * m; e += blockDim.x) cp_async4(sc + e, scales + r0 * m + e);
}

// One warp folds its lanes' candidates ((-inf, kEmptyKey) = none) into a
// table row's board under the row's lock, and moves the row's threshold.
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

// The boards of a block's table rows in shared memory (tile_layout): a
// sorted board a row, its packed threshold and its lock.
struct RowBoards {
  float* s;  // [rows][P], entry p of a row best first
  int* key;
  unsigned long long* thr;
  int* lock;
  int k, E, P;

  __device__ RowBoards(unsigned char* smem, const TileLayout& L, int k_)
      : s(reinterpret_cast<float*>(smem + L.board_s)),
        key(reinterpret_cast<int*>(smem + L.board_key)),
        thr(reinterpret_cast<unsigned long long*>(smem + L.thr)),
        lock(reinterpret_cast<int*>(smem + L.lock)),
        k(k_),
        E(sorted_slots(k_)),
        P(32 * sorted_slots(k_)) {}

  __device__ unsigned long long threshold(int r) const {
    return *reinterpret_cast<volatile unsigned long long*>(thr + r);
  }

  // Empty boards of `rows` rows, by the whole block; a __syncthreads()
  // must follow before any warp offers.
  __device__ void init(int rows) const {
    for (int e = threadIdx.x; e < rows * P; e += blockDim.x) {
      s[e] = -INFINITY;
      key[e] = kEmptyKey;
    }
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      thr[r] = pack(-INFINITY, kEmptyKey);
      lock[r] = 0;
    }
  }

  // Row r's best k, best first, to out_* (by one warp).
  __device__ void write(int r, float* out_s, int* out_key) const {
    for (int e = threadIdx.x & 31; e < k; e += 32) {
      out_s[e] = s[(size_t)r * P + e];
      out_key[e] = key[(size_t)r * P + e];
    }
  }
};

// A warp's candidate list: up to 32 candidates of one table row that beat
// the row's threshold when they were scored, in 32 scores and keys of
// shared memory of the warp's own, folded into the row's board as one
// batch when the list is full, when a candidate of another row comes, and
// at the end. Without a list (s null) each offer's beaters fold at once.
struct CandList {
  float* s;
  int* key;
  int n = 0;  // warp-uniform
  int row = 0;

  __device__ CandList(float* s_, int* key_) : s(s_), key(key_) {}

  __device__ void flush(const RowBoards& b) {
    if (n == 0) return;  // warp-uniform
    __syncwarp();
    const int lane = threadIdx.x & 31;
    const bool in = lane < n;
    fold_call(b.E, b.s + (size_t)row * b.P, b.key + (size_t)row * b.P, b.thr + row,
              b.lock + row, in ? s[lane] : -INFINITY, in ? key[lane] : kEmptyKey, b.k);
    n = 0;
  }

  // One candidate a lane for row r; those that `beat` r's threshold join
  // the list in lane order.
  __device__ void offer(const RowBoards& b, int r, bool beat, float cs, int ck) {
    const unsigned bm = __ballot_sync(kFullMask, beat);
    if (bm == 0) return;  // warp-uniform
    if (s == nullptr) {   // no list: fold these (warp-uniform)
      fold_call(b.E, b.s + (size_t)r * b.P, b.key + (size_t)r * b.P, b.thr + r, b.lock + r,
                beat ? cs : -INFINITY, beat ? ck : kEmptyKey, b.k);
      return;
    }
    const int c = __popc(bm);
    if (r != row || n + c > 32) {
      flush(b);
      row = r;
    }
    if (beat) {
      const int pos = n + __popc(bm & ((1u << (threadIdx.x & 31)) - 1u));
      s[pos] = cs;
      key[pos] = ck;
    }
    n += c;
    if (n == 32) flush(b);
  }
};

// One warp scores the blk slots of one code block against table row r, one
// slot a lane: sum(slot) is the slot's m terms, sid the block's slot ids
// (-1 skipped); it adds the coarse term cp, keys each slot by its visit
// position key0 + slot and offers those that beat the row's threshold.
template <class Sum>
__device__ __forceinline__ void score_block(const int* sid, int blk, float cp, int key0, int r,
                                            const RowBoards& b, CandList& cl, Sum sum) {
  const int lane = threadIdx.x & 31;
  for (int s0 = 0; s0 < blk; s0 += 32) {
    const int slot = s0 + lane;
    const int id = slot < blk ? sid[slot] : -1;
    float score = -INFINITY;
    if (id >= 0) score = __fadd_rn(sum(slot), cp);
    const int key = key0 + slot;
    const unsigned long long th = b.threshold(r);  // every lane: no branch
    cl.offer(b, r, id >= 0 && pack(score, key) > th, score, key);
  }
}

// ------------------------------------------------------------ per-query grid

// Block (row, chunk) scores the real steps of table row `row` that are
// dealt to chunk `chunk` of n = gridDim.y (q = row, or row / nprobe with
// per-probe tables) and writes its best k to part_*[(row * n + chunk) * k].
// RING: each warp streams its steps' code blocks through its ring (VEC as
// fetch_block); otherwise a lane reads its code row, and the int8 scales
// come, from device memory. pad_block: the all-pad block's id, or -1 (every
// step walked). walked, where given: each warp adds the steps it scored to
// walked[q].
template <int DT, bool VEC, bool RING>
__global__ void __launch_bounds__(kThreads, 2)
    ivf_adc_rows(const uint8_t* __restrict__ codes, const int* __restrict__ ids,
                 const int* __restrict__ visit, const void* __restrict__ luts_v,
                 const float* __restrict__ scales, const float* __restrict__ coarse, int T,
                 int nprobe, int per_probe, int blk, int m, int ksub, int k, int pad_block,
                 float* __restrict__ part_s, int* __restrict__ part_key,
                 int* __restrict__ walked) {
  using LT = typename LutT<DT>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kStagedScales = RING && DT == kI8;
  const TileLayout L = tile_layout(sizeof(LT), kStagedScales, 1, m, ksub, blk, k, 0, RING ? 2 : 0);
  LT* tab = reinterpret_cast<LT*>(smem);
  float* sc = kStagedScales ? reinterpret_cast<float*>(smem + L.scales) : nullptr;
  const RowBoards bd(smem, L, k);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x;
  const int chunk = blockIdx.y;
  const int n = gridDim.y;
  const int spp = T / nprobe;
  const int q = per_probe ? row / nprobe : row;
  const int p0 = per_probe ? row - q * nprobe : 0;  // the row's first probe
  const int P = per_probe ? 1 : nprobe;             // and its probes
  const float* srow = DT == kI8 ? scales + (size_t)row * m : nullptr;

  // ---- the row's table (and, staged, its int8 scales), the empty board
  stage_tables(tab, L.tstride / sizeof(LT), static_cast<const LT*>(luts_v), (size_t)row, 1,
               m * ksub, scales, sc, m);
  cp_async_commit();
  bd.init(1);

  // ---- this warp's steps: step j of the row's probe pl is the warp's
  // when (j + pl V / P) mod V == u, so in probe pl they are jf(pl) + V i.
  // They form a P x w grid of cells, w = ceil(spp / V), cell (pl, i) the
  // step jf(pl) + V i where that is below spp; a window is 32 cells, one a
  // lane, each loading its step's block and its probe's coarse term.
  const int V = n * kWarps;
  const int u = warp * n + chunk;
  const int w = (spp + V - 1) / V;
  const long cells = (long)P * w;
  const int* vrow = visit + (size_t)q * T;
  long g0 = -32;      // the window's first cell
  int vb = 0, vt = 0;  // the lane's block and visit step
  float vc = 0.f;      // its probe's coarse term
  unsigned live = 0;   // the window's real steps not yet taken
  int count = 0;
  // The next real step's block b, visit step t and coarse term c; false
  // when the warp has none left. Warp-uniform.
  auto next = [&](int& b, int& t, float& c) -> bool {
    while (live == 0) {
      g0 += 32;
      if (g0 >= cells) return false;
      const long g = g0 + lane;
      bool real = false;
      if (g < cells) {
        const int pl = (int)(g / w);
        const int jf = ((u - (int)((long)pl * V / P)) % V + V) % V;
        const int j = jf + V * (int)(g - (long)pl * w);
        if (j < spp) {
          vt = (p0 + pl) * spp + j;
          vc = coarse[(size_t)q * nprobe + p0 + pl];
          vb = vrow[vt];
          real = vb != pad_block && vc > 0.5f * kNegInf;
        }
      }
      live = __ballot_sync(kFullMask, real);
    }
    const int src = __ffs(live) - 1;
    live &= live - 1;
    b = __shfl_sync(kFullMask, vb, src);
    t = __shfl_sync(kFullMask, vt, src);
    c = __shfl_sync(kFullMask, vc, src);
    ++count;
    return true;
  };

  float* cand = RING ? reinterpret_cast<float*>(smem + L.cand) + warp * 64 : nullptr;
  CandList cl(cand, RING ? reinterpret_cast<int*>(cand + 32) : nullptr);
  int b = 0, t = 0;
  float c = 0.f;
  bool have = next(b, t, c);
  if constexpr (RING) {
    unsigned char* ring = smem + L.ring + (size_t)warp * 2 * L.stage;
    const bool swz = VEC && m % 16 == 0;
    if (have) fetch_block<VEC>(ring, L.codes, codes, ids, (size_t)b, blk, m);
    cp_async_commit();
    cp_async_wait<1>();  // the thread's share of the table has landed
    __syncthreads();
    for (int s = 0; have; ++s) {  // warp-uniform
      int b2 = 0, t2 = 0;
      float c2 = 0.f;
      const bool more = next(b2, t2, c2);
      if (more)
        fetch_block<VEC>(ring + (size_t)((s + 1) & 1) * L.stage, L.codes, codes, ids, (size_t)b2,
                         blk, m);
      cp_async_commit();
      cp_async_wait<1>();  // step s's block has landed
      __syncwarp();
      const unsigned char* stage = ring + (size_t)(s & 1) * L.stage;
      score_block(reinterpret_cast<const int*>(stage + L.codes), blk, c, t * blk, 0, bd, cl,
                  [&](int slot) { return ring_sum<DT>(swz, stage, slot, m, ksub, tab, sc); });
      __syncwarp();  // the stage is read before the next fetch refills it
      b = b2;
      t = t2;
      c = c2;
      have = more;
    }
  } else {
    cp_async_wait<0>();
    __syncthreads();
    for (; have; have = next(b, t, c)) {  // warp-uniform
      const uint8_t* cb = codes + (size_t)b * blk * m;
      score_block(ids + (size_t)b * blk, blk, c, t * blk, 0, bd, cl, [&](int slot) {
        return adc_sum<DT, false, true, true>(cb + (size_t)slot * m, m, ksub, tab, srow);
      });
    }
  }
  cl.flush(bd);
  cp_async_wait<0>();
  __syncthreads();
  if (warp == 0) {
    const size_t off = ((size_t)row * n + chunk) * k;
    bd.write(0, part_s + off, part_key + off);
  }
  if (walked != nullptr && lane == 0) atomicAdd(walked + q, count);
}

// ------------------------------------------------------------ grouped grids

// The grouped grids' scoring pass: block (tile, chunk) scores the segments
// whose head lies in chunk `chunk` (chunk_pairs pairs) of tile `tile`'s
// pairs, [tile_pairs[tile], tile_pairs[tile + 1]) of `meta`, and writes
// each of its rows' best k to part_*[(row * n_chunks + chunk) * k],
// row = q or q * nprobe + p, n_chunks = gridDim.y. VEC as fetch_block.
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
  const TileLayout L = tile_layout(sizeof(LT), DT == kI8, qt, m, ksub, blk, k, cw, 2);
  LT* tab = reinterpret_cast<LT*>(smem);
  const RowBoards bd(smem, L, k);
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

  // ---- the tile's tables, int8 scales, coarse terms and empty boards
  stage_tables(tab, tstride, static_cast<const LT*>(luts_v), (size_t)r0, nr, m * ksub, scales,
               DT == kI8 ? sc : nullptr, m);
  cp_async_commit();
  for (int e = tid; e < nr * cw; e += kThreads) cs[e] = coarse[(size_t)r0 * cw + e];
  bd.init(qt);

  // ---- this warp's range of the chunk
  const int per_w = (cb - ca + kWarps - 1) / kWarps;
  const int wa = min(cb, ca + warp * per_w);
  const int wb = min(cb, wa + per_w);
  cp_async_wait<0>();
  __syncthreads();

  unsigned char* ring = smem + L.ring + (size_t)warp * 2 * L.stage;
  const bool swz = VEC && m % 16 == 0;  // staged swizzled, read 16 bytes at a time

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
  CandList cl(cand_s, cand_key);

  load_window(wa);
  // the first head at or after wa: a segment holds at most kSegMax pairs,
  // so there is one within the window
  int s = base + __ffs(heads) - 1;
  if (s < wb)
    fetch_block<VEC>(ring, L.codes, codes, ids, (size_t)__shfl_sync(kFullMask, rec.x, s - base),
                     blk, m);
  cp_async_commit();
  for (int n = 0; s < wb; ++n) {  // warp-uniform
    const int ls = s - base;  // <= 31 - kSegMax: the segment and its end are in the window
    const unsigned after = heads & ~((2u << ls) - 1u);
    const int e = after ? base + __ffs(after) - 1 : base + 32;
    if (e < wb)
      fetch_block<VEC>(ring + (size_t)((n + 1) & 1) * L.stage, L.codes, codes, ids,
                       (size_t)__shfl_sync(kFullMask, rec.x, e - base), blk, m);
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
      score_block(sid, blk, cp, t * blk, rl, bd, cl,
                  [&](int slot) { return ring_sum<DT>(swz, stage, slot, m, ksub, tabr, scr); });
    }
    __syncwarp();  // the stage is read before the next fetch refills it
    s = e;
    if (s < wb && s - base > 31 - kSegMax) load_window(s);
  }
  cl.flush(bd);
  cp_async_wait<0>();
  __syncthreads();

  for (int r = warp; r < nr; r += kWarps) {
    const size_t off = ((size_t)(r0 + r) * n_chunks + chunk) * k;
    bd.write(r, part_s + off, part_key + off);
  }
}

// ------------------------------------------------------------ merge

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

// First level: block (q, g) folds slice g of query q's boards into one raw
// board (merge_slice, topk_board.cuh).
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

// Both levels of the merge for boards held in E slots a lane.
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

// The merge of part_* (Q, n_parts, k) into out_* (Q, k).
int launch_merge(const void* part_s, const void* part_key, const void* ids, const void* visit,
                 int Q, int T, int blk, int n_parts, int k, int groups, void* slice_s,
                 void* slice_key, void* out_s, void* out_i, cudaStream_t st) {
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

// ------------------------------------------------------------ launches

template <int DT, bool VEC, bool RING>
int launch_rows(const void* codes, const void* ids, const void* visit, const void* luts,
                const void* scales, const void* coarse, int Q, int T, int nprobe, int per_probe,
                int blk, int m, int ksub, int k, int n_chunks, int pad_block, void* part_s,
                void* part_key, void* walked, cudaStream_t st) {
  using LT = typename LutT<DT>::T;
  const size_t smem =
      tile_layout(sizeof(LT), RING && DT == kI8, 1, m, ksub, blk, k, 0, RING ? 2 : 0).total;
  cudaError_t err = cudaFuncSetAttribute(ivf_adc_rows<DT, VEC, RING>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(per_probe ? Q * nprobe : Q, n_chunks);
  ivf_adc_rows<DT, VEC, RING><<<grid, kThreads, smem, st>>>(
      static_cast<const uint8_t*>(codes), static_cast<const int*>(ids),
      static_cast<const int*>(visit), luts, static_cast<const float*>(scales),
      static_cast<const float*>(coarse), T, nprobe, per_probe, blk, m, ksub, k, pad_block,
      static_cast<float*>(part_s), static_cast<int*>(part_key), static_cast<int*>(walked));
  return (int)cudaGetLastError();
}

template <int DT>
int launch_rows_dt(bool ring, bool vec, const void* codes, const void* ids, const void* visit,
                   const void* luts, const void* scales, const void* coarse, int Q, int T,
                   int nprobe, int per_probe, int blk, int m, int ksub, int k, int n_chunks,
                   int pad_block, void* part_s, void* part_key, void* walked, cudaStream_t st) {
  if (!ring)
    return launch_rows<DT, false, false>(codes, ids, visit, luts, scales, coarse, Q, T, nprobe,
                                         per_probe, blk, m, ksub, k, n_chunks, pad_block, part_s,
                                         part_key, walked, st);
  if (vec)
    return launch_rows<DT, true, true>(codes, ids, visit, luts, scales, coarse, Q, T, nprobe,
                                       per_probe, blk, m, ksub, k, n_chunks, pad_block, part_s,
                                       part_key, walked, st);
  return launch_rows<DT, false, true>(codes, ids, visit, luts, scales, coarse, Q, T, nprobe,
                                      per_probe, blk, m, ksub, k, n_chunks, pad_block, part_s,
                                      part_key, walked, st);
}

template <int DT, bool VEC>
int launch_tiles(const void* codes, const void* ids, const void* luts, const void* scales,
                 const void* coarse, const void* meta, const void* tile_pairs, int rows,
                 int nprobe, int per_probe, int blk, int m, int ksub, int qt, int k,
                 int chunk_pairs, int n_chunks, void* part_s, void* part_key,
                 cudaStream_t st) {
  using LT = typename LutT<DT>::T;
  const size_t smem =
      tile_layout(sizeof(LT), DT == kI8, qt, m, ksub, blk, k, per_probe ? 1 : nprobe, 2).total;
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

}  // namespace

extern "C" {

// Shared memory bytes of one per-query block (kernels/ivf_adc.py
// query_smem_bytes): one table row with its code ring and candidate lists
// (ring = 1), or the direct-read variant's (ring = 0: neither, and the int8
// scales unstaged).
size_t ivf_adc_query_smem(int lut_type, int m, int ksub, int blk, int k, int ring) {
  return tile_layout((int)lut_bytes(lut_type), ring && lut_type == kI8, 1, m, ksub, blk, k, 0,
                     ring ? 2 : 0)
      .total;
}

// Shared memory bytes of one grouped-grid tile block (the plan's `smem`);
// cw = coarse terms a table row (nprobe, or 1 with per-probe tables).
size_t ivf_adc_grouped_smem(int lut_type, int qt, int m, int ksub, int blk, int k, int cw) {
  return tile_layout((int)lut_bytes(lut_type), lut_type == kI8, qt, m, ksub, blk, k, cw, 2).total;
}

// The per-query grid. codes (B, blk, m) uint8; ids (B, blk) int32 (-1 =
// pad); visit (Q, T) int32; luts (Q, [nprobe,] m, ksub) in float32,
// bfloat16 or int8 (lut_type 0, 1, 2) with scales (Q, [nprobe,] m)
// float32 for int8; coarse (Q, nprobe) float32; codes, ids and luts
// 16-byte aligned. n_chunks, ring and groups from kernels/ivf_adc.py
// query_plan; pad_block the all-pad block or -1; part_* (Q, [nprobe *]
// n_chunks, k) scratch, slice_* (Q, groups, k) scratch when groups > 1;
// out_s (Q, k) float32, out_i (Q, k) int32; walked (Q,) int32 or null.
// Returns the CUDA error code.
int ivf_adc_launch(const void* codes, const void* ids, const void* visit, const void* luts,
                   const void* scales, const void* coarse, int Q, int T, int blk, int m, int ksub,
                   int spp, int per_probe, int lut_type, int k, int n_chunks, int ring,
                   int pad_block, int groups, void* part_s, void* part_key, void* slice_s,
                   void* slice_key, void* out_s, void* out_i, void* walked, void* stream) {
  if (k < 1 || k > kMaxK || spp < 1 || T % spp != 0 || Q < 1 || n_chunks < 1 ||
      n_chunks > 65535 || groups < 1 || groups > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int nprobe = T / spp;
  const bool vec = (long)blk * m % 16 == 0 && blk % 4 == 0;
  int err;
#define THISTLE_IVF_ROWS(DT)                                                                    \
  launch_rows_dt<DT>(ring != 0, vec, codes, ids, visit, luts, scales, coarse, Q, T, nprobe,      \
                     per_probe, blk, m, ksub, k, n_chunks, pad_block, part_s, part_key, walked, \
                     st)
  switch (lut_type) {
    case kF32: err = THISTLE_IVF_ROWS(kF32); break;
    case kBF16: err = THISTLE_IVF_ROWS(kBF16); break;
    case kI8: err = THISTLE_IVF_ROWS(kI8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef THISTLE_IVF_ROWS
  if (err != cudaSuccess) return err;
  return launch_merge(part_s, part_key, ids, visit, Q, T, blk, (per_probe ? nprobe : 1) * n_chunks,
                      k, groups, slice_s, slice_key, out_s, out_i, st);
}

// The grouped grids (blocked and run-resident differ only in `meta`).
// meta (n_pairs, 4) int32, tile_pairs (tiles + 1,) int32, chunk_pairs and
// n_chunks (chunks a tile) are the pair index of kernels/ivf_adc.py
// tile_index for tiles of qt rows (rows = Q, or Q * nprobe with per-probe
// tables); part_* (Q, rows / Q * n_chunks, k) scratch, slice_* (Q, groups,
// k) scratch when groups > 1; the other arguments as ivf_adc_launch.
// Returns the CUDA error code.
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
  return launch_merge(part_s, part_key, ids, visit, Q, T, blk, (per_probe ? nprobe : 1) * n_chunks,
                      k, groups, slice_s, slice_key, out_s, out_i, st);
}

const char* thistle_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
