// Top-k scoreboards shared by the port's CUDA kernels.
//
// Every board ranks (score, key) pairs by one total order: the higher score
// first and, between equal scores, the lower key first. The key is the
// candidate's row id (topk_distance) or its position in the visit table
// (ivf_adc). That is the order lax.top_k gives the reference, which keeps
// the lower position first among equal scores, so the set a board keeps
// does not depend on the order the blocks of the grid ran in.
//
// A board is one warp's: k entries in shared memory, unsorted, with the
// worst entry's (score, key, slot) held in registers, the same in every
// lane. A candidate that beats the worst entry overwrites its slot and the
// warp finds the new worst. Only the final write sorts, by rank counting.
#pragma once

#include <cuda_runtime.h>
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
  // have, go to the lower slot so that every lane agrees.
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
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_xor_sync(kFullMask, cs, off);
      const int ok = __shfl_xor_sync(kFullMask, ck, off);
      const int op = __shfl_xor_sync(kFullMask, cp, off);
      if (better(cs, ck, os, ok) || (cs == os && ck == ok && op < cp)) {
        cs = os;
        ck = ok;
        cp = op;
      }
    }
    ws = cs;
    wk = ck;
    wpos = cp;
  }

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
    for (int e = threadIdx.x & 31; e < k; e += 32) {
      const float se = s[e];
      const int ke = key[e];
      int rank = 0;
      for (int f = 0; f < k; ++f) {
        const float sf = s[f];
        const int kf = key[f];
        rank += (better(sf, kf, se, ke) || (sf == se && kf == ke && f < e)) ? 1 : 0;
      }
      out_s[rank] = se;
      out_id[rank] = map(ke);
    }
  }
};

// One warp folds `total` raw board entries (from chunk boards in device
// memory) into its board; empty slots are skipped.
__device__ inline void fold_parts(WarpBoard& board, const float* part_s, const int* part_key,
                                  long total) {
  const int lane = threadIdx.x & 31;
  for (long e0 = 0; e0 < total; e0 += 32) {
    const long e = e0 + lane;
    const bool in = e < total;
    const float s = in ? part_s[e] : -INFINITY;
    const int key = in ? part_key[e] : kEmptyKey;
    board.fold_lanes(s, key, in && key != kEmptyKey);
  }
}

}  // namespace thistle
