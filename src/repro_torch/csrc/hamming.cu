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
// queries up the Q*N*T*W popcounts (__popc runs at 16 a clock per SM on
// compute capability 9.0, a quarter of the XOR and add rate). This first
// version takes one corpus row a thread: the row's T*W words come in as 16-,
// 8- or 4-byte loads from the (T, N, W) layout (a warp reads 32 consecutive
// rows of one table) and stay in registers; a tile of query codes sits in
// shared memory and is read by broadcast; a (query, row) pair costs T*W
// XORs, popcounts and adds and T mins.
//
// Shortlist: the structure of topk_distance.cu. A block takes QT queries and
// a chunk of rows; each warp owns QT/8 queries and keeps one board each
// (topk_board.cuh) with score -(float)dist, exact since dist <= 32*T*W, and
// key = row id, so equal distances go to the lower row id, as lax.top_k of
// the negated distances gives the reference. A chunk writes its raw boards,
// and hamming_shortlist_merge folds the chunks of each query into the
// sorted (Q, L) result.
#include <limits.h>

#include "topk_board.cuh"

using namespace thistle;

namespace {

constexpr int kThreads = 256;  // rows a tile, one a thread
constexpr int kMaxWords = 32;  // T*W words a row may hold
constexpr int kFullQT = 32;    // queries a block of the matrix kernel takes

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

template <int QT>
size_t partial_smem(int L, int tw) {
  return sizeof(float) * QT * kThreads + (sizeof(float) + sizeof(int)) * (size_t)QT * L +
         sizeof(uint32_t) * QT * tw;
}

template <int QT, int MAXW>
__global__ void __launch_bounds__(kThreads)
    hamming_shortlist_partial(const uint32_t* __restrict__ c, const uint32_t* __restrict__ q,
                              int N, int Q, int T, int W, int L, int rows_per_chunk,
                              float* __restrict__ part_s, int* __restrict__ part_key) {
  constexpr int R = QT / 8;  // queries a warp owns
  extern __shared__ __align__(16) unsigned char smem[];
  float* S = reinterpret_cast<float*>(smem);                       // [QT][kThreads]
  float* board_s = S + QT * kThreads;                               // [QT][L]
  int* board_key = reinterpret_cast<int*>(board_s + QT * L);        // [QT][L]
  uint32_t* qs = reinterpret_cast<uint32_t*>(board_key + QT * L);  // [QT][T*W]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tw = T * W;
  const int q0 = blockIdx.x * QT;
  const int nq = min(QT, Q - q0);
  const int chunk = blockIdx.y;
  const int n_chunks = gridDim.y;
  const long n_begin = (long)chunk * rows_per_chunk;
  const long n_end = min((long)N, n_begin + rows_per_chunk);

  stage_queries(q, Q, W, tw, q0, nq, qs);
  WarpBoard boards[R];
#pragma unroll
  for (int b = 0; b < R; ++b) {
    const int row = warp + 8 * b;
    boards[b].init(board_s + row * L, board_key + row * L, L);
  }
  __syncthreads();

  for (long n0 = n_begin; n0 < n_end; n0 += kThreads) {
    const long n = n0 + tid;
    if (n < n_end) {
      uint32_t r[MAXW];
      load_row<MAXW>(c, N, W, tw, n, r);
      for (int qi = 0; qi < nq; ++qi)
        S[qi * kThreads + tid] = -(float)min_table_dist<MAXW>(r, qs + qi * tw, W, tw);
    }
    __syncthreads();
#pragma unroll
    for (int b = 0; b < R; ++b) {
      const int row = warp + 8 * b;
      if (row >= nq) continue;  // warp-uniform
#pragma unroll
      for (int c0 = 0; c0 < kThreads; c0 += 32) {
        const int col = c0 + lane;
        const long ni = n0 + col;
        boards[b].fold_lanes(S[row * kThreads + col], (int)ni, ni < n_end);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int b = 0; b < R; ++b) {
    const int row = warp + 8 * b;
    if (row >= nq) continue;
    const long off = ((long)(q0 + row) * n_chunks + chunk) * L;
    boards[b].write_raw(part_s + off, part_key + off);
  }
}

struct RowId {
  __device__ int operator()(int key) const { return key == kEmptyKey ? -1 : key; }
};

struct Dist {
  __device__ int operator()(float s) const { return s == -INFINITY ? INT_MAX : (int)(-s); }
};

// One warp a query: fold the chunk boards, write the sorted distances and ids.
__global__ void __launch_bounds__(kThreads)
    hamming_shortlist_merge(const float* __restrict__ part_s, const int* __restrict__ part_key,
                            int Q, int n_chunks, int L, int* __restrict__ out_d,
                            int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int qi = blockIdx.x * (kThreads / 32) + warp;
  if (qi >= Q) return;  // warp-uniform
  float* bs = reinterpret_cast<float*>(smem) + warp * L;
  int* bk = reinterpret_cast<int*>(reinterpret_cast<float*>(smem) + (kThreads / 32) * L) + warp * L;
  WarpBoard board;
  board.init(bs, bk, L);
  const long total = (long)n_chunks * L;
  fold_parts(board, part_s + qi * total, part_key + qi * total, total);
  board.write_sorted(out_d + (long)qi * L, out_i + (long)qi * L, RowId(), Dist());
}

template <int MAXW>
int launch_full(const uint32_t* c, const uint32_t* q, int N, int Q, int T, int W, int* out,
                cudaStream_t st) {
  dim3 grid((N + kThreads - 1) / kThreads, (Q + kFullQT - 1) / kFullQT);
  hamming_full<MAXW><<<grid, kThreads, 0, st>>>(c, q, N, Q, T, W, out);
  return (int)cudaGetLastError();
}

template <int QT, int MAXW>
int launch_partial(const uint32_t* c, const uint32_t* q, int N, int Q, int T, int W, int L,
                   int n_chunks, int rows_per_chunk, float* part_s, int* part_key,
                   cudaStream_t st) {
  const size_t smem = partial_smem<QT>(L, T * W);
  cudaError_t err = cudaFuncSetAttribute(hamming_shortlist_partial<QT, MAXW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Q + QT - 1) / QT, n_chunks);
  hamming_shortlist_partial<QT, MAXW><<<grid, kThreads, smem, st>>>(c, q, N, Q, T, W, L,
                                                                    rows_per_chunk, part_s,
                                                                    part_key);
  return (int)cudaGetLastError();
}

template <int QT>
int launch_partial_w(const uint32_t* c, const uint32_t* q, int N, int Q, int T, int W, int L,
                     int n_chunks, int rows_per_chunk, float* part_s, int* part_key,
                     cudaStream_t st) {
  const int tw = T * W;
  if (tw <= 8)
    return launch_partial<QT, 8>(c, q, N, Q, T, W, L, n_chunks, rows_per_chunk, part_s,
                                 part_key, st);
  if (tw <= 16)
    return launch_partial<QT, 16>(c, q, N, Q, T, W, L, n_chunks, rows_per_chunk, part_s,
                                  part_key, st);
  return launch_partial<QT, 32>(c, q, N, Q, T, W, L, n_chunks, rows_per_chunk, part_s,
                                part_key, st);
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

// c (T, N, W) and q (T, Q, W) code words; part_* (Q, n_chunks, L) scratch;
// out_d and out_i (Q, L) int32, nearest first, equal distances by row id.
// qt is 8 or 32 (queries a block). Returns the CUDA error code of the
// launches.
int hamming_shortlist_launch(const void* c, const void* q, int N, int Q, int T, int W, int L,
                             int qt, int n_chunks, int rows_per_chunk, void* part_s,
                             void* part_key, void* out_d, void* out_i, void* stream) {
  if (bad_shape(N, Q, T, W) || L < 1 || L > kMaxK || L > N || (qt != 8 && qt != 32))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const auto* cc = static_cast<const uint32_t*>(c);
  const auto* qq = static_cast<const uint32_t*>(q);
  auto* ps = static_cast<float*>(part_s);
  auto* pk = static_cast<int*>(part_key);
  int err = qt == 8 ? launch_partial_w<8>(cc, qq, N, Q, T, W, L, n_chunks, rows_per_chunk, ps,
                                          pk, st)
                    : launch_partial_w<32>(cc, qq, N, Q, T, W, L, n_chunks, rows_per_chunk, ps,
                                           pk, st);
  if (err != cudaSuccess) return err;
  const size_t smem = (sizeof(float) + sizeof(int)) * (kThreads / 32) * (size_t)L;
  hamming_shortlist_merge<<<(Q + 7) / 8, kThreads, smem, st>>>(ps, pk, Q, n_chunks, L,
                                                               static_cast<int*>(out_d),
                                                               static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}

const char* thistle_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
