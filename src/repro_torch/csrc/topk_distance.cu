// Fused exact distance + top-k for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/topk_distance.py
// (topk_distance, body _topk_kernel, selection _select_topk): corpus tiles
// stream past the queries, each tile's scores q.c (times 2 for l2) plus the
// row bias (-|c|^2 for l2, -1e30 for a knocked-out row) are folded into a
// running top-k, and only the (Q, k) result leaves the chip. The wrapper
// subtracts |q|^2 for l2, as the reference's wrapper does.
//
// What bounds it: reading the corpus once, N*d*4 bytes, at small Q; the
// 2*Q*N*d float32 operations at large Q (about 64 queries and up at
// d = 768). This first version is a tiled SIMT product in shared memory:
// a block takes BQ = 16*TM queries and a chunk of corpus rows, walks the
// chunk in tiles of BN rows, and accumulates BQ x BN scores over d in
// steps of BK, 16 x 16 threads with TM x 4 scores each. The corpus is read
// once per query tile; query tiles of one chunk run side by side, so the
// rereads mostly hit L2. Tensor cores (wgmma) are work for a later change.
//
// Top-k: each warp owns BQ/8 query rows and keeps one board per row
// (topk_board.cuh). A chunk writes its raw boards out, and
// topk_distance_merge folds the chunks of each query into the sorted
// (Q, k) result. Ties: the lower row id first, as lax.top_k keeps the
// lower position first.
#include "topk_board.cuh"

using namespace thistle;

namespace {

constexpr int kThreads = 256;
constexpr int BN = 64;
constexpr int BK = 32;

template <int TM>
size_t partial_smem(int k) {
  constexpr int BQ = 16 * TM;
  return sizeof(float) * (BK * (BQ + 1) + BK * (BN + 1) + BQ * (BN + 1)) +
         (sizeof(float) + sizeof(int)) * (size_t)BQ * k;
}

template <int TM>
__global__ void __launch_bounds__(kThreads)
    topk_distance_partial(const float* __restrict__ corpus, const float* __restrict__ q,
                          const float* __restrict__ bias, int N, int Q, int d, int k, int l2,
                          int rows_per_chunk, float* __restrict__ part_s,
                          int* __restrict__ part_key) {
  constexpr int BQ = 16 * TM;
  constexpr int R = BQ / 8;  // query rows per warp
  extern __shared__ __align__(16) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);  // [BK][BQ + 1]
  float* Bs = As + BK * (BQ + 1);               // [BK][BN + 1]
  float* S = Bs + BK * (BN + 1);                // [BQ][BN + 1]
  float* board_s = S + BQ * (BN + 1);           // [BQ][k]
  int* board_key = reinterpret_cast<int*>(board_s + BQ * k);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int chunk = blockIdx.y;
  const int n_chunks = gridDim.y;
  const long n_begin = (long)chunk * rows_per_chunk;
  const long n_end = min((long)N, n_begin + rows_per_chunk);

  WarpBoard boards[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = warp + 8 * r;
    boards[r].init(board_s + row * k, board_key + row * k, k);
  }

  for (long n0 = n_begin; n0 < n_end; n0 += BN) {
    float acc[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < d; k0 += BK) {
      for (int e = tid; e < BQ * BK; e += kThreads) {
        const int r = e / BK, c = e % BK;
        const int qi = q0 + r, di = k0 + c;
        As[c * (BQ + 1) + r] = (qi < Q && di < d) ? q[(long)qi * d + di] : 0.f;
      }
      for (int e = tid; e < BN * BK; e += kThreads) {
        const int r = e / BK, c = e % BK;
        const long ni = n0 + r;
        const int di = k0 + c;
        Bs[c * (BN + 1) + r] = (ni < n_end && di < d) ? corpus[ni * d + di] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        float a[TM], b[4];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = As[kk * (BQ + 1) + ty * TM + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[kk * (BN + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

    // epilogue: the l2 factor of 2, then the bias (metric term and knockout)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const long ni = n0 + c;
        const float dot = l2 ? 2.f * acc[i][j] : acc[i][j];
        S[(ty * TM + i) * (BN + 1) + c] = ni < n_end ? __fadd_rn(dot, bias[ni]) : 0.f;
      }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = warp + 8 * r;
      if (q0 + row >= Q) continue;  // warp-uniform
#pragma unroll
      for (int c0 = 0; c0 < BN; c0 += 32) {
        const int c = c0 + lane;
        const long ni = n0 + c;
        boards[r].fold_lanes(S[row * (BN + 1) + c], (int)ni, ni < n_end);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = warp + 8 * r;
    if (q0 + row >= Q) continue;
    const long off = ((long)(q0 + row) * n_chunks + chunk) * k;
    boards[r].write_raw(part_s + off, part_key + off);
  }
}

struct RowId {
  __device__ int operator()(int key) const { return key == kEmptyKey ? -1 : key; }
};

// One warp a query: fold the chunk boards, write the sorted top-k.
__global__ void __launch_bounds__(kThreads)
    topk_distance_merge(const float* __restrict__ part_s, const int* __restrict__ part_key,
                        int Q, int n_chunks, int k, float* __restrict__ out_s,
                        int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int qi = blockIdx.x * (kThreads / 32) + warp;
  if (qi >= Q) return;  // warp-uniform
  float* bs = reinterpret_cast<float*>(smem) + warp * k;
  int* bk = reinterpret_cast<int*>(reinterpret_cast<float*>(smem) + (kThreads / 32) * k) + warp * k;
  WarpBoard board;
  board.init(bs, bk, k);
  const long total = (long)n_chunks * k;
  fold_parts(board, part_s + qi * total, part_key + qi * total, total);
  board.write_sorted(out_s + (long)qi * k, out_i + (long)qi * k, RowId());
}

template <int TM>
int launch_partial(const float* corpus, const float* q, const float* bias, int N, int Q, int d,
                   int k, int l2, int n_chunks, int rows_per_chunk, float* part_s, int* part_key,
                   cudaStream_t stream) {
  constexpr int BQ = 16 * TM;
  const size_t smem = partial_smem<TM>(k);
  cudaError_t err = cudaFuncSetAttribute(topk_distance_partial<TM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Q + BQ - 1) / BQ, n_chunks);
  topk_distance_partial<TM><<<grid, kThreads, smem, stream>>>(corpus, q, bias, N, Q, d, k, l2,
                                                              rows_per_chunk, part_s, part_key);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// corpus (N, d), q (Q, d), bias (N,) float32; part_* (Q, n_chunks, k)
// scratch; out_s (Q, k) float32 and out_i (Q, k) int32. tm is 1 (16
// queries a block) or 4 (64). Returns the CUDA error code of the launches.
int topk_distance_launch(const void* corpus, const void* q, const void* bias, int N, int Q,
                         int d, int k, int l2, int tm, int n_chunks, int rows_per_chunk,
                         void* part_s, void* part_key, void* out_s, void* out_i, void* stream) {
  if (k < 1 || k > kMaxK || (tm != 1 && tm != 4)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const float*>(corpus);
  const auto* qq = static_cast<const float*>(q);
  const auto* b = static_cast<const float*>(bias);
  auto* ps = static_cast<float*>(part_s);
  auto* pk = static_cast<int*>(part_key);
  int err = tm == 1 ? launch_partial<1>(c, qq, b, N, Q, d, k, l2, n_chunks, rows_per_chunk, ps,
                                        pk, st)
                    : launch_partial<4>(c, qq, b, N, Q, d, k, l2, n_chunks, rows_per_chunk, ps,
                                        pk, st);
  if (err != cudaSuccess) return err;
  const size_t smem = (sizeof(float) + sizeof(int)) * (kThreads / 32) * (size_t)k;
  topk_distance_merge<<<(Q + 7) / 8, kThreads, smem, st>>>(ps, pk, Q, n_chunks, k,
                                                           static_cast<float*>(out_s),
                                                           static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}

const char* thistle_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
