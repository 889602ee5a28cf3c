// Top-k scoreboards shared by the port's CUDA kernels.
//
// Every board ranks (score, key) pairs by one total order: the higher score
// first and, between equal scores, the lower key first. The key is the
// candidate's row id (topk_distance) or its position in the visit table
// (ivf_adc). That is the order lax.top_k gives the reference, which keeps
// the lower position first among equal scores, so the set a board keeps
// does not depend on the order the blocks of the grid ran in.
//
// Two kinds of board, each one warp's:
//   * WarpBoard (topk_distance): k entries in shared memory,
//     unsorted, with the worst entry's (score, key, slot) held in registers,
//     the same in every lane. A candidate that beats the worst entry
//     overwrites its slot and the warp finds the new worst. Only the final
//     write sorts, by rank counting.
//   * SortedBoard (pq_adc, hamming, ivf_adc; their boards and merges): the best
//     32 E entries sorted in registers, candidates folded 32 at a time by
//     bitonic networks, cheaper where many candidates enter.
#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace thistle {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kEmptyKey = 0x7fffffff;  // key of a slot that holds nothing yet
constexpr int kMaxK = 256;             // largest k a board takes
constexpr float kNegInf = -1e30f;      // the reference's knockout score

__device__ __forceinline__ bool better(float s1, int k1, float s2, int k2) {
  return s1 > s2 || (s1 == s2 && k1 < k2);
}

struct SameScore {
  __device__ float operator()(float s) const { return s; }
};

struct WarpBoard {
  float* s;
  int* key;
  int k;
  float ws;  // worst entry: score, key and slot
  int wk;
  int wpos;

  __device__ void init(float* s_, int* key_, int k_) {
    s = s_;
    key = key_;
    k = k_;
    const int lane = threadIdx.x & 31;
    for (int e = lane; e < k; e += 32) {
      s[e] = -INFINITY;
      key[e] = kEmptyKey;
    }
    __syncwarp();
    ws = -INFINITY;
    wk = kEmptyKey;
    wpos = 0;
  }

  // Worst entry of the board. Ties of (score, key), which only empty slots
  // have, go to the lower slot so that every lane agrees. Each lane finds
  // the worst of its slots; three warp reductions (redux.sync) then pick
  // the lowest score (as an order-preserving int, -0.0 read as +0.0, which
  // equal compares as), the highest key among those, the lowest slot.
  __device__ void find_worst() {
    const int lane = threadIdx.x & 31;
    float cs = INFINITY;
    int ck = -1;
    int cp = 0x7fffffff;
    for (int e = lane; e < k; e += 32) {
      const float se = s[e];
      const int ke = key[e];
      if (better(cs, ck, se, ke) || (cs == se && ck == ke && e < cp)) {
        cs = se;
        ck = ke;
        cp = e;
      }
    }
    const int os = ordered(cs);
    const int m = __reduce_min_sync(kFullMask, os);
    const int mk = __reduce_max_sync(kFullMask, os == m ? ck : INT_MIN);
    const int mp = __reduce_min_sync(kFullMask, os == m && ck == mk ? cp : 0x7fffffff);
    ws = unordered(m);
    wk = mk;
    wpos = mp;
  }

  // A float as an int of the same order (no NaN); -0.0 maps as +0.0.
  __device__ static int ordered(float f) {
    const int i = __float_as_int(f + 0.0f);
    return i >= 0 ? i : i ^ 0x7fffffff;
  }
  __device__ static float unordered(int i) { return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff); }

  // Offer one candidate per lane; lanes with valid == false offer nothing.
  // Called by all 32 lanes of the warp.
  __device__ void fold_lanes(float cs, int ck, bool valid) {
    unsigned mask = __ballot_sync(kFullMask, valid && better(cs, ck, ws, wk));
    while (mask) {
      const int src = __ffs(mask) - 1;
      const float s_new = __shfl_sync(kFullMask, cs, src);
      const int k_new = __shfl_sync(kFullMask, ck, src);
      if ((threadIdx.x & 31) == 0) {
        s[wpos] = s_new;
        key[wpos] = k_new;
      }
      __syncwarp();
      find_worst();
      mask &= ~(1u << src);
      mask &= __ballot_sync(kFullMask, valid && better(cs, ck, ws, wk));
    }
  }

  // Raw board, unsorted, for a later merge.
  __device__ void write_raw(float* out_s, int* out_key) const {
    for (int e = threadIdx.x & 31; e < k; e += 32) {
      out_s[e] = s[e];
      out_key[e] = key[e];
    }
  }

  // Board sorted best first. Rank = entries ahead of this one in the order,
  // with identical entries ranked by slot so that ranks are a permutation.
  // map(key) turns a key into the id written out.
  template <class Map>
  __device__ void write_sorted(float* out_s, int* out_id, Map map) const {
    write_sorted(out_s, out_id, map, SameScore());
  }

  // The same, with score_map(score) written in place of the score.
  template <class OutS, class Map, class ScoreMap>
  __device__ void write_sorted(OutS* out_s, int* out_id, Map map, ScoreMap score_map) const {
    for (int e = threadIdx.x & 31; e < k; e += 32) {
      const float se = s[e];
      const int ke = key[e];
      int rank = 0;
      for (int f = 0; f < k; ++f) {
        const float sf = s[f];
        const int kf = key[f];
        rank += (better(sf, kf, se, ke) || (sf == se && kf == ke && f < e)) ? 1 : 0;
      }
      out_s[rank] = score_map(se);
      out_id[rank] = map(ke);
    }
  }
};

// One warp folds `total` raw board entries (from chunk boards in device
// memory, or other warps' boards in shared memory) into its board; empty
// slots are skipped. Four batches of 32 entries are loaded before any is
// folded, so their loads overlap; the entries are folded in order.
__device__ inline void fold_parts(WarpBoard& board, const float* part_s, const int* part_key,
                                  long total) {
  constexpr int kBatches = 4;
  const int lane = threadIdx.x & 31;
  for (long e0 = 0; e0 < total; e0 += 32 * kBatches) {
    float s[kBatches];
    int key[kBatches];
#pragma unroll
    for (int b = 0; b < kBatches; ++b) {
      const long e = e0 + 32 * b + lane;
      const bool in = e < total;
      s[b] = in ? part_s[e] : -INFINITY;
      key[b] = in ? part_key[e] : kEmptyKey;
    }
#pragma unroll
    for (int b = 0; b < kBatches; ++b) board.fold_lanes(s[b], key[b], key[b] != kEmptyKey);
  }
}

// A warp's board for merging many boards: the best P = 32 E entries seen
// (P >= k, E a power of two), sorted best first in registers, entry p in
// slot p / 32 of lane p % 32, padded with empty entries (-inf, kEmptyKey).
// Candidates come 32 at a time, one a lane: a batch none of which beats the
// k-th entry is dropped; otherwise the batch is sorted (bitonic, across the
// lanes), folded into the board's last 32 entries (the better of entry
// P - 32 + i and the batch's (31 - i)-th, which keeps the best 32 of the two
// sorted runs; no other entry can leave the best P), and the board is
// re-sorted by one bitonic merge. A batch costs about 5 + log2 P
// compare-exchange stages however many of it enter, where WarpBoard pays a
// search of the board for every candidate that enters.
template <int E>
struct SortedBoard {
  float s[E];
  int key[E];

  __device__ void init() {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      s[e] = -INFINITY;
      key[e] = kEmptyKey;
    }
  }

  // Exchange with the lane `stride` away: keep the better of the two where
  // keep_better, else the worse.
  __device__ static void cx_lanes(float& cs, int& ck, int stride, bool keep_better) {
    const float os = __shfl_xor_sync(kFullMask, cs, stride);
    const int ok = __shfl_xor_sync(kFullMask, ck, stride);
    if (better(os, ok, cs, ck) == keep_better) {
      cs = os;
      ck = ok;
    }
  }

  // Sort one entry a lane, best first (bitonic).
  __device__ static void sort_lanes(float& cs, int& ck) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
      for (int stride = size >> 1; stride > 0; stride >>= 1)
        cx_lanes(cs, ck, stride, ((lane & stride) == 0) == ((lane & size) == 0));
  }

  // Sort a bitonic board best first.
  __device__ void merge() {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int span = E >> 1; span > 0; span >>= 1)
#pragma unroll
      for (int e = 0; e < E; ++e)
        if ((e & span) == 0 && better(s[e | span], key[e | span], s[e], key[e])) {
          const float ts = s[e];
          const int tk = key[e];
          s[e] = s[e | span];
          key[e] = key[e | span];
          s[e | span] = ts;
          key[e | span] = tk;
        }
#pragma unroll
    for (int stride = 16; stride > 0; stride >>= 1)
#pragma unroll
      for (int e = 0; e < E; ++e) cx_lanes(s[e], key[e], stride, (lane & stride) == 0);
  }

  // Offer one candidate a lane (empty: (-inf, kEmptyKey)); k is the
  // board's meaningful length.
  __device__ void offer(float cs, int ck, int k) {
    const int lane = threadIdx.x & 31;
    float ts = s[0];
    int tk = key[0];
#pragma unroll
    for (int e = 1; e < E; ++e)
      if (e == (k - 1) >> 5) {
        ts = s[e];
        tk = key[e];
      }
    ts = __shfl_sync(kFullMask, ts, (k - 1) & 31);
    tk = __shfl_sync(kFullMask, tk, (k - 1) & 31);
    if (!__any_sync(kFullMask, better(cs, ck, ts, tk))) return;
    sort_lanes(cs, ck);
    const float rs = __shfl_sync(kFullMask, cs, 31 - lane);
    const int rk = __shfl_sync(kFullMask, ck, 31 - lane);
    if (better(rs, rk, s[E - 1], key[E - 1])) {
      s[E - 1] = rs;
      key[E - 1] = rk;
    }
    // the last 32 entries are bitonic: sort them, reversed when there is a
    // sorted run ahead of them, so that the whole board is bitonic
#pragma unroll
    for (int stride = 16; stride > 0; stride >>= 1)
      cx_lanes(s[E - 1], key[E - 1], stride, ((lane & stride) == 0) == (E == 1));
    if (E > 1) merge();
  }

  // Fold `total` raw entries, 32 at a time, four batches loaded ahead.
  __device__ void fold(const float* part_s, const int* part_key, long total, int k) {
    constexpr int kBatches = 4;
    const int lane = threadIdx.x & 31;
    for (long e0 = 0; e0 < total; e0 += 32 * kBatches) {
      float bs[kBatches];
      int bk[kBatches];
#pragma unroll
      for (int b = 0; b < kBatches; ++b) {
        const long e = e0 + 32 * b + lane;
        const bool in = e < total;
        bs[b] = in ? part_s[e] : -INFINITY;
        bk[b] = in ? part_key[e] : kEmptyKey;
      }
#pragma unroll
      for (int b = 0; b < kBatches; ++b) offer(bs[b], bk[b], k);
    }
  }
};

// The block's warps each fold a share of `total` raw board entries into a
// sorted board of their own, then warp 0 folds the other warps' best k
// (passed through smem, warps x k entries) into its own and returns it; the
// other warps return a board they must not use.
template <int E>
__device__ SortedBoard<E> fold_block(const float* part_s, const int* part_key, long total,
                                     int k, unsigned char* smem) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  float* bs = reinterpret_cast<float*>(smem);
  int* bk = reinterpret_cast<int*>(bs + (size_t)n_warps * k);
  SortedBoard<E> board;
  board.init();
  const long per = ((total + 32L * n_warps - 1) / (32L * n_warps)) * 32;
  const long begin = min(total, per * warp);
  const long end = min(total, begin + per);
  board.fold(part_s + begin, part_key + begin, end - begin, k);
#pragma unroll
  for (int e = 0; e < E; ++e)
    if (e * 32 + lane < k) {
      bs[(size_t)warp * k + e * 32 + lane] = board.s[e];
      bk[(size_t)warp * k + e * 32 + lane] = board.key[e];
    }
  __syncthreads();
  if (warp == 0) board.fold(bs + k, bk + k, (long)(n_warps - 1) * k, k);
  return board;
}

// The merge of the chunk boards of (Q, n_chunks, k) raw boards, in one or
// two levels. Level one (groups > 1, grid (Q, groups)): block (q, g) folds
// chunks [g c, (g + 1) c) of query q, c = ceil(n_chunks / groups), into
// one board of (Q, groups, k). The last level (grid Q) folds the boards of
// query q and writes its best k, best first: score_map(score), map(key).
// Two levels spread a small Q's merge over more SMs.
template <int E>
__device__ void merge_slice(const float* part_s, const int* part_key, int n_chunks, int groups,
                            int k, unsigned char* smem, float* out_s, int* out_key) {
  const long q = blockIdx.x, g = blockIdx.y;
  const long per = (n_chunks + groups - 1) / groups;
  const long c0 = min((long)n_chunks, g * per), c1 = min((long)n_chunks, c0 + per);
  const long base = (q * n_chunks + c0) * k;
  const SortedBoard<E> board =
      fold_block<E>(part_s + base, part_key + base, (c1 - c0) * k, k, smem);
  const long out = (q * groups + g) * k;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32)
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (e * 32 + lane < k) {
        out_s[out + e * 32 + lane] = board.s[e];
        out_key[out + e * 32 + lane] = board.key[e];
      }
}

template <int E, class OutS, class Map, class ScoreMap>
__device__ void merge_query(const float* part_s, const int* part_key, int n_chunks, int k,
                            unsigned char* smem, OutS* out_s, int* out_id, Map map,
                            ScoreMap score_map) {
  const long q = blockIdx.x;
  const long total = (long)n_chunks * k;
  const SortedBoard<E> board =
      fold_block<E>(part_s + q * total, part_key + q * total, total, k, smem);
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32)
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (e * 32 + lane < k) {
        out_s[q * k + e * 32 + lane] = score_map(board.s[e]);
        out_id[q * k + e * 32 + lane] = map(board.key[e]);
      }
}

// Registers a lane of a SortedBoard needs for k entries: the least power
// of two E with 32 E >= k.
__host__ __device__ constexpr int sorted_slots(int k) {
  return k <= 32 ? 1 : k <= 64 ? 2 : k <= 128 ? 4 : 8;
}

// Boards of a block's query rows behind a threshold (the pattern of
// topk_distance.cu, shared by pq_adc.cu and hamming.cu). Each row r holds a
// board sorted best first (SortedBoard's layout, P = 32 sorted_slots(k)
// entries), its k-th entry -- the threshold a candidate must beat -- and a
// candidate list of kGateCap slots. A thread offers a (score, key): one
// that does not beat the threshold is rejected, one that does is appended
// to the list; a full list leaves it to the thread for the next round.
// When a list is full, and at the end, the warp that owns a row folds its
// list into the board (one SortedBoard batch) and moves the threshold; a
// list may carry candidates over several tiles, so most tiles need no fold.
// The test is exact: the threshold only rises, so a rejected candidate
// could never enter.
constexpr int kGateCap = 32;  // candidate slots a row: one batch

struct GateBoards {
  float* board_s;  // [rows][P], entry p of a row best first
  int* board_key;
  float* cand_s;   // [rows][kGateCap]
  int* cand_key;
  float* thr_s;    // [rows] the board's k-th entry
  int* thr_key;
  int* cnt;        // [rows] candidates offered since the last fold
  int k;
  int P;

  __host__ __device__ static size_t bytes(int rows, int k) {
    return (size_t)rows * ((size_t)32 * sorted_slots(k) * 8 + kGateCap * 8 + 12);
  }

  // Carve the boards of `rows` rows out of p (4-byte aligned).
  __device__ void carve(unsigned char* p, int rows, int k_) {
    k = k_;
    P = 32 * sorted_slots(k);
    board_s = reinterpret_cast<float*>(p);
    board_key = reinterpret_cast<int*>(board_s + (size_t)rows * P);
    cand_s = reinterpret_cast<float*>(board_key + (size_t)rows * P);
    cand_key = reinterpret_cast<int*>(cand_s + rows * kGateCap);
    thr_s = reinterpret_cast<float*>(cand_key + rows * kGateCap);
    thr_key = reinterpret_cast<int*>(thr_s + rows);
    cnt = thr_key + rows;
  }

  // Empty boards; a __syncthreads() must follow.
  __device__ void init(int rows) {
    for (int e = threadIdx.x; e < rows * P; e += blockDim.x) {
      board_s[e] = -INFINITY;
      board_key[e] = kEmptyKey;
    }
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      thr_s[r] = -INFINITY;
      thr_key[r] = kEmptyKey;
      cnt[r] = 0;
    }
  }

  __device__ bool beats(int r, float s, int key) const {
    return better(s, key, thr_s[r], thr_key[r]);
  }

  // Rejects or appends the candidate; false when row r's list is full
  // (the caller offers it again after the next fold).
  __device__ bool offer(int r, float s, int key) {
    if (!beats(r, s, key)) return true;
    const int pos = atomicAdd(cnt + r, 1);
    if (pos >= kGateCap) return false;
    cand_s[r * kGateCap + pos] = s;
    cand_key[r * kGateCap + pos] = key;
    return true;
  }

  // Row r's list folded into its board by the calling warp.
  template <int E>
  __device__ __forceinline__ void fold_row(int r, int c) {
    const int lane = threadIdx.x & 31;
    float* bs = board_s + (size_t)r * P;
    int* bk = board_key + (size_t)r * P;
    SortedBoard<E> b;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      b.s[e] = bs[e * 32 + lane];
      b.key[e] = bk[e * 32 + lane];
    }
    const bool in = lane < c;
    b.offer(in ? cand_s[r * kGateCap + lane] : -INFINITY,
            in ? cand_key[r * kGateCap + lane] : kEmptyKey, k);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      bs[e * 32 + lane] = b.s[e];
      bk[e * 32 + lane] = b.key[e];
      if (e * 32 + lane == k - 1) {
        thr_s[r] = b.s[e];
        thr_key[r] = b.key[e];
      }
    }
    if (lane == 0) cnt[r] = 0;
  }

  // The same as a call: the board's registers stay out of the caller's
  // register allocation (folds are rare).
  template <int E>
  __device__ __noinline__ void fold_row_call(int r, int c) {
    fold_row<E>(r, c);
  }

  // Fold every row's list into its board, one warp a row, for boards of
  // E = sorted_slots(k) slots a lane known to the caller. Called by the
  // whole block between two __syncthreads().
  template <int E>
  __device__ void fold(int rows) {
    for (int r = threadIdx.x >> 5; r < rows; r += blockDim.x >> 5) {
      const int c = min(cnt[r], kGateCap);
      if (c > 0) fold_row<E>(r, c);  // warp-uniform
    }
  }

  // The same for any k, each row's fold a call.
  __device__ void fold(int rows) {
    for (int r = threadIdx.x >> 5; r < rows; r += blockDim.x >> 5) {
      const int c = min(cnt[r], kGateCap);
      if (c == 0) continue;  // warp-uniform
      switch (P >> 5) {
        case 1: fold_row_call<1>(r, c); break;
        case 2: fold_row_call<2>(r, c); break;
        case 4: fold_row_call<4>(r, c); break;
        default: fold_row_call<8>(r, c); break;
      }
    }
  }

  // Row r's best k, best first, for a later merge.
  __device__ void write_raw(int r, float* out_s, int* out_key) const {
    for (int e = threadIdx.x & 31; e < k; e += 32) {
      out_s[e] = board_s[(size_t)r * P + e];
      out_key[e] = board_key[(size_t)r * P + e];
    }
  }
};

}  // namespace thistle
