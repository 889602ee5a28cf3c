// Hamming-distance ranking pass of the LSH engine for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/hamming.py (hamming, body
// _hamming_kernel). For query signatures q (T, Q, W) and corpus signatures
// c (T, N, W), 32 bits a word, carried as int32 bit patterns:
//     dist[q, n] = min over t of sum over w of popcount(q[t, q, w] ^ c[t, n, w])
// Two entry points share one device function for that distance:
//   * hamming_launch writes the (Q, N) int32 matrix, the TPU kernel's output;
//   * hamming_shortlist_launch keeps only the L nearest rows of each query as
//     it scores (the LSH engine's shortlist), so the (Q, N) matrix, 18 GB at
//     Q = 512 and N = 8.8M, never exists.
//
// What bounds it: at Q = 1 reading the codes once, T*N*W*4 bytes; from a few
// queries up the popcounts (__popc runs at 16 a clock per SM on compute
// capability 9.0, a quarter of the XOR and add rate): Q*N*T*W of them, or
// three quarters of that where a carry-save step counts three words of a
// four-word table with two popcounts (the shortlist's path for W = 4).
// Both entries take one corpus row a thread: the row's T*W words come in as
// 16-, 8- or 4-byte loads from the (T, N, W) layout (a warp reads 32
// consecutive rows of one table) and stay in registers; a tile of query
// codes sits in shared memory and is read by broadcast; a (query, row)
// pair costs T*W XORs, the popcounts and their adds, and T mins.
//
// Shortlist: selection must cost less than the popcounts. A block takes a
// tile of queries (16, or 32 from Q = 65 up; kernels/hamming.py
// shortlist_plan) and a chunk of rows, and keeps one sorted board of L
// entries a query (GateBoards, topk_board.cuh), score -(float)dist, exact
// since dist <= 32*T*W, key = row id, so equal distances go to the lower
// row id, as lax.top_k of the negated distances gives the reference. Ahead
// of the boards sits a threshold: each thread compares its row's distance
// to each query with that query's current L-th distance, read from shared
// memory by broadcast. Rows of a chunk reach a board in increasing id, so a
// row that ties the threshold cannot enter and the strict test is exact;
// only a row that passes goes to the query's candidate list, which the warp
// owning the query folds into its board (one bitonic batch) when the list
// fills and at the end. No distance is staged, and one barrier a 256-row
// tile is the steady state. The plan sizes the chunks to fill the card; a
// chunk writes its best L, and hamming_shortlist_merge folds the chunks of
// each query on a block of its own into the sorted (Q, L) result, after
// hamming_shortlist_merge_slices has folded slices of them on several
// blocks a query where Q is small.
#include <limits.h>

#include "topk_board.cuh"

using namespace thistle;

namespace {

constexpr int kThreads = 256;  // rows a tile, one a thread
constexpr int kMaxWords = 32;  // T*W words a row may hold
constexpr int kFullQT = 32;    // queries a block of the matrix kernel takes
constexpr int kMaxShortQT = 32;  // queries a shortlist block takes at most (a bit each)
constexpr int kMergeThreads = 256;

// A row's T*W code words, table-major, into registers. MAXW is a multiple
// of 4 and at least T*W; the unrolled index keeps r in registers.
template <int MAXW>
__device__ __forceinline__ void load_row(const uint32_t* __restrict__ c, long N, int W, int tw,
                                         long n, uint32_t (&r)[MAXW]) {
  if ((W & 3) == 0) {
#pragma unroll
    for (int i = 0; i < MAXW; i += 4) {
      if (i < tw) {
        const int t = i / W, w = i - t * W;
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(c + ((long)t * N + n) * W + w));
        r[i] = v.x;
        r[i + 1] = v.y;
        r[i + 2] = v.z;
        r[i + 3] = v.w;
      }
    }
  } else if ((W & 1) == 0) {
#pragma unroll
    for (int i = 0; i < MAXW; i += 2) {
      if (i < tw) {
        const int t = i / W, w = i - t * W;
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(c + ((long)t * N + n) * W + w));
        r[i] = v.x;
        r[i + 1] = v.y;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < MAXW; ++i) {
      if (i < tw) {
        const int t = i / W, w = i - t * W;
        r[i] = __ldg(c + ((long)t * N + n) * W + w);
      }
    }
  }
}

// The distance of one (query, row) pair: r holds the row's words, qs the
// query's, both table-major. The summed popcounts of each table's W words,
// then the min over tables.
template <int MAXW>
__device__ __forceinline__ int min_table_dist(const uint32_t (&r)[MAXW],
                                              const uint32_t* __restrict__ qs, int W, int tw) {
  int best = INT_MAX, acc = 0, w = 0;
#pragma unroll
  for (int i = 0; i < MAXW; ++i) {
    if (i < tw) {
      acc += __popc(r[i] ^ qs[i]);
      if (++w == W) {
        best = min(best, acc);
        acc = 0;
        w = 0;
      }
    }
  }
  return best;
}

// The same distance with the query's words in shared memory, read 16 bytes
// at a time when vec (T*W and the query's offset multiples of 4 words).
// Tables of four words (128 bits, the LSH engine's) run straight-line and
// count three of the words through one carry-save step: sum s = a^b^c and
// carry c' = maj(a, b, c) give popc(a) + popc(b) + popc(c) = popc(s) +
// 2 popc(c'), so a table takes three popcounts in place of four.
template <int MAXW>
__device__ __forceinline__ int min_table_dist_smem(const uint32_t (&r)[MAXW],
                                                   const uint32_t* qs, int W, int tw, bool vec) {
  if (!vec) return min_table_dist<MAXW>(r, qs, W, tw);
  uint32_t qv[MAXW];
#pragma unroll
  for (int i = 0; i < MAXW; i += 4) {
    if (i < tw) {
      const uint4 v = *reinterpret_cast<const uint4*>(qs + i);
      qv[i] = v.x;
      qv[i + 1] = v.y;
      qv[i + 2] = v.z;
      qv[i + 3] = v.w;
    }
  }
  if (W != 4) return min_table_dist<MAXW>(r, qv, W, tw);
  int best = INT_MAX;
#pragma unroll
  for (int i = 0; i < MAXW; i += 4) {
    if (i < tw) {
      const uint32_t a = r[i] ^ qv[i], b = r[i + 1] ^ qv[i + 1], c = r[i + 2] ^ qv[i + 2];
      const uint32_t d = r[i + 3] ^ qv[i + 3];
      const uint32_t carry = (a & b) | (c & (a ^ b));
      best = min(best, __popc(a ^ b ^ c) + __popc(d) + 2 * __popc(carry));
    }
  }
  return best;
}

// Query codes q0 .. q0+nq-1 of the (T, Q, W) layout into shared memory as
// [nq][T*W], table-major within a query.
__device__ __forceinline__ void stage_queries(const uint32_t* __restrict__ q, int Q, int W, int tw,
                                              int q0, int nq, uint32_t* qs) {
  for (int e = threadIdx.x; e < nq * tw; e += blockDim.x) {
    const int qi = e / tw, i = e - qi * tw, t = i / W, w = i - t * W;
    qs[e] = q[((long)t * Q + q0 + qi) * W + w];
  }
}

template <int MAXW>
__global__ void __launch_bounds__(kThreads)
    hamming_full(const uint32_t* __restrict__ c, const uint32_t* __restrict__ q, int N, int Q,
                 int T, int W, int* __restrict__ out) {
  __shared__ uint32_t qs[kFullQT * kMaxWords];
  const int tw = T * W;
  const int q0 = blockIdx.y * kFullQT;
  const int nq = min(kFullQT, Q - q0);
  stage_queries(q, Q, W, tw, q0, nq, qs);
  __syncthreads();
  const long n = (long)blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  uint32_t r[MAXW];
  load_row<MAXW>(c, N, W, tw, n, r);
  for (int qi = 0; qi < nq; ++qi)
    out[(long)(q0 + qi) * N + n] = min_table_dist<MAXW>(r, qs + qi * tw, W, tw);
}

// Blocks an SM the shortlist kernel's register bound allows: four (64
// registers a thread) when a row's words fit 16 registers, else two (128).
// kernels/hamming.py mirrors this.
__host__ __device__ constexpr int shortlist_min_blocks(int maxw) { return maxw <= 16 ? 4 : 2; }

// Dynamic shared memory of a shortlist block: the query tile's words and
// its boards (kernels/hamming.py shortlist_smem mirrors this).
size_t shortlist_smem(int qt, int L, int tw) {
  return sizeof(uint32_t) * (size_t)qt * tw + GateBoards::bytes(qt, L);
}

template <int MAXW, int E>
__global__ void __launch_bounds__(kThreads, shortlist_min_blocks(MAXW))
    hamming_shortlist_partial(const uint32_t* __restrict__ c, const uint32_t* __restrict__ q,
                              int N, int Q, int T, int W, int L, int qt, int rows_per_chunk,
                              float* __restrict__ part_s, int* __restrict__ part_key) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tw = T * W;
  uint32_t* qs = reinterpret_cast<uint32_t*>(smem);  // [qt][T*W]
  const int q0 = blockIdx.x * qt;
  GateBoards gate;
  gate.carve(smem + sizeof(uint32_t) * qt * tw, qt, L);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int nq = min(qt, Q - q0);
  const int chunk = blockIdx.y;
  const int n_chunks = gridDim.y;
  const long n_begin = (long)chunk * rows_per_chunk;
  const long n_end = min((long)N, n_begin + rows_per_chunk);

  const bool vec = (tw & 3) == 0;
  stage_queries(q, Q, W, tw, q0, nq, qs);
  gate.init(nq);
  __syncthreads();

  for (long n0 = n_begin; n0 < n_end; n0 += kThreads) {
    const long n = n0 + tid;
    const bool in = n < n_end;
    uint32_t r[MAXW];
    uint32_t pend = 0;
    if (in) {
      load_row<MAXW>(c, N, W, tw, n, r);
      // Before any fold of this tile every key on a board is a lower row
      // (or an empty slot's), so a row beats a board's worst entry exactly
      // when its distance is strictly below the worst distance.
      for (int qi = 0; qi < nq; ++qi) {
        const float s = -(float)min_table_dist_smem<MAXW>(r, qs + qi * tw, W, tw, vec);
        if (s > gate.thr_s[qi]) pend |= 1u << qi;
      }
    }
    while (true) {
      bool full = false;
      for (uint32_t left = pend; left; left &= left - 1) {
        const int qi = __ffs(left) - 1;
        const float s = -(float)min_table_dist_smem<MAXW>(r, qs + qi * tw, W, tw, vec);
        if (gate.offer(qi, s, (int)n))
          pend &= ~(1u << qi);
        else
          full = true;
      }
      if (!__syncthreads_or(full)) break;
      gate.fold<E>(nq);
      __syncthreads();
    }
  }
  gate.fold<E>(nq);  // what the lists still hold
  __syncthreads();

  for (int r = warp; r < nq; r += kThreads / 32) {
    const long off = ((long)(q0 + r) * n_chunks + chunk) * L;
    gate.write_raw(r, part_s + off, part_key + off);
  }
}

struct RowId {
  __device__ int operator()(int key) const { return key == kEmptyKey ? -1 : key; }
};

struct Dist {
  __device__ int operator()(float s) const { return s == -INFINITY ? INT_MAX : (int)(-s); }
};

// The merge's first level: block (q, g) folds slice g of query q's chunk
// boards into one raw board (merge_slice, topk_board.cuh).
template <int E>
__global__ void __launch_bounds__(kMergeThreads)
    hamming_shortlist_merge_slices(const float* __restrict__ part_s,
                                   const int* __restrict__ part_key, int n_chunks, int groups,
                                   int L, float* __restrict__ slice_s,
                                   int* __restrict__ slice_key) {
  extern __shared__ __align__(16) unsigned char smem[];
  merge_slice<E>(part_s, part_key, n_chunks, groups, L, smem, slice_s, slice_key);
}

// The last level: one block a query folds its boards, writes the sorted
// distances and ids.
template <int E>
__global__ void __launch_bounds__(kMergeThreads)
    hamming_shortlist_merge(const float* __restrict__ part_s, const int* __restrict__ part_key,
                            int n_chunks, int L, int* __restrict__ out_d,
                            int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  merge_query<E>(part_s, part_key, n_chunks, L, smem, out_d, out_i, RowId(), Dist());
}

// Both levels of the merge for boards of L entries held in E slots a lane.
template <int E>
void launch_merge(const float* part_s, const int* part_key, int Q, int n_chunks, int L,
                  int groups, float* slice_s, int* slice_key, int* out_d, int* out_i,
                  cudaStream_t st) {
  const size_t smem = (sizeof(float) + sizeof(int)) * (kMergeThreads / 32) * (size_t)L;
  if (groups > 1) {
    hamming_shortlist_merge_slices<E><<<dim3(Q, groups), kMergeThreads, smem, st>>>(
        part_s, part_key, n_chunks, groups, L, slice_s, slice_key);
    part_s = slice_s;
    part_key = slice_key;
    n_chunks = groups;
  }
  hamming_shortlist_merge<E><<<Q, kMergeThreads, smem, st>>>(part_s, part_key, n_chunks, L,
                                                             out_d, out_i);
}

template <int MAXW>
int launch_full(const uint32_t* c, const uint32_t* q, int N, int Q, int T, int W, int* out,
                cudaStream_t st) {
  dim3 grid((N + kThreads - 1) / kThreads, (Q + kFullQT - 1) / kFullQT);
  hamming_full<MAXW><<<grid, kThreads, 0, st>>>(c, q, N, Q, T, W, out);
  return (int)cudaGetLastError();
}

template <int MAXW, int E>
int launch_partial(const uint32_t* c, const uint32_t* q, int N, int Q, int T, int W, int L,
                   int qt, int n_chunks, int rows_per_chunk, float* part_s, int* part_key,
                   cudaStream_t st) {
  const size_t smem = shortlist_smem(qt, L, T * W);
  cudaError_t err = cudaFuncSetAttribute(hamming_shortlist_partial<MAXW, E>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Q + qt - 1) / qt, n_chunks);
  hamming_shortlist_partial<MAXW, E><<<grid, kThreads, smem, st>>>(
      c, q, N, Q, T, W, L, qt, rows_per_chunk, part_s, part_key);
  return (int)cudaGetLastError();
}

// The partial kernel for rows of T*W words and boards of L entries.
template <int MAXW>
int launch_partial_e(const uint32_t* c, const uint32_t* q, int N, int Q, int T, int W, int L,
                     int qt, int n_chunks, int rows_per_chunk, float* part_s, int* part_key,
                     cudaStream_t st) {
  switch (sorted_slots(L)) {
    case 1:
      return launch_partial<MAXW, 1>(c, q, N, Q, T, W, L, qt, n_chunks, rows_per_chunk, part_s,
                                     part_key, st);
    case 2:
      return launch_partial<MAXW, 2>(c, q, N, Q, T, W, L, qt, n_chunks, rows_per_chunk, part_s,
                                     part_key, st);
    case 4:
      return launch_partial<MAXW, 4>(c, q, N, Q, T, W, L, qt, n_chunks, rows_per_chunk, part_s,
                                     part_key, st);
    default:
      return launch_partial<MAXW, 8>(c, q, N, Q, T, W, L, qt, n_chunks, rows_per_chunk, part_s,
                                     part_key, st);
  }
}

bool bad_shape(int N, int Q, int T, int W) {
  return N < 1 || Q < 1 || T < 1 || W < 1 || T * W > kMaxWords;
}

}  // namespace

extern "C" {

// c (T, N, W) and q (T, Q, W) 32-bit code words; out (Q, N) int32. Returns
// the CUDA error code of the launch.
int hamming_launch(const void* c, const void* q, int N, int Q, int T, int W, void* out,
                   void* stream) {
  if (bad_shape(N, Q, T, W) || (Q + kFullQT - 1) / kFullQT > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const auto* cc = static_cast<const uint32_t*>(c);
  const auto* qq = static_cast<const uint32_t*>(q);
  auto* o = static_cast<int*>(out);
  const int tw = T * W;
  if (tw <= 8) return launch_full<8>(cc, qq, N, Q, T, W, o, st);
  if (tw <= 16) return launch_full<16>(cc, qq, N, Q, T, W, o, st);
  return launch_full<32>(cc, qq, N, Q, T, W, o, st);
}

// Shared memory bytes of one shortlist block (the plan's `smem`).
size_t hamming_shortlist_smem(int qt, int L, int tw) { return shortlist_smem(qt, L, tw); }

// c (T, N, W) and q (T, Q, W) code words; part_* (Q, n_chunks, L) scratch;
// slice_* (Q, groups, L) scratch when groups > 1 (the merge's first level);
// out_d and out_i (Q, L) int32, nearest first, equal distances by row id.
// qt (1..32 queries a block), n_chunks, rows_per_chunk and groups as the
// plan gives them. Returns the CUDA error code of the launches.
int hamming_shortlist_launch(const void* c, const void* q, int N, int Q, int T, int W, int L,
                             int qt, int n_chunks, int rows_per_chunk, void* part_s,
                             void* part_key, int groups, void* slice_s, void* slice_key,
                             void* out_d, void* out_i, void* stream) {
  if (bad_shape(N, Q, T, W) || L < 1 || L > kMaxK || L > N || qt < 1 || qt > kMaxShortQT ||
      n_chunks < 1 || n_chunks > 65535 || rows_per_chunk < 1 || groups < 1 || groups > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const auto* cc = static_cast<const uint32_t*>(c);
  const auto* qq = static_cast<const uint32_t*>(q);
  auto* ps = static_cast<float*>(part_s);
  auto* pk = static_cast<int*>(part_key);
  const int tw = T * W;
  int err;
  if (tw <= 8)
    err = launch_partial_e<8>(cc, qq, N, Q, T, W, L, qt, n_chunks, rows_per_chunk, ps, pk, st);
  else if (tw <= 16)
    err = launch_partial_e<16>(cc, qq, N, Q, T, W, L, qt, n_chunks, rows_per_chunk, ps, pk, st);
  else
    err = launch_partial_e<32>(cc, qq, N, Q, T, W, L, qt, n_chunks, rows_per_chunk, ps, pk, st);
  if (err != cudaSuccess) return err;
  auto* ss = static_cast<float*>(slice_s);
  auto* sk = static_cast<int*>(slice_key);
  auto* od = static_cast<int*>(out_d);
  auto* oi = static_cast<int*>(out_i);
  switch (sorted_slots(L)) {
    case 1: launch_merge<1>(ps, pk, Q, n_chunks, L, groups, ss, sk, od, oi, st); break;
    case 2: launch_merge<2>(ps, pk, Q, n_chunks, L, groups, ss, sk, od, oi, st); break;
    case 4: launch_merge<4>(ps, pk, Q, n_chunks, L, groups, ss, sk, od, oi, st); break;
    default: launch_merge<8>(ps, pk, Q, n_chunks, L, groups, ss, sk, od, oi, st); break;
  }
  return (int)cudaGetLastError();
}

const char* thistle_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
