// Fused PQ asymmetric-distance + top-k for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/pq_adc.py (pq_adc, body
// _pq_adc_kernel). For query q and corpus row n it scores
//   score = sum_{j<m} lut[q, j, codes[n, j]] (+ lut[q, m, extra[n]]) + bias[n]
// and keeps the best k per query. `bias` carries the knockout of a dead or
// padded row (-1e30); `extra` is an optional int32 code column that indexes
// one more table row, which is how IVF-PQ's scan_all folds each row's
// coarse term into the scan (its table row is as wide as the cluster count,
// 2973 entries at 8.8M rows).
//
// The TPU kernel contracts a one-hot code expansion against all Q tables
// held in VMEM. A CUDA block has 227 KB of shared memory, and at m = 64 one
// float32 table is 64 KB, so a block takes a tile of at most 8 queries
// whose tables fit (2 or 3 in float32, up to 8 in int8) and a chunk of
// rows. Each thread scores one row against every query of the tile: it
// reads the row's uint8 codes once as 32-bit words and looks each code up
// in the staged tables. Only the first min(W, 256) entries of a uint8
// subspace's row can be indexed, so only those are staged; the `extra` row
// is read from device memory through the read-only cache.
//
// What bounds it: the m table additions of each (query, row) pair, 2QNm
// float32 operations, above the code bytes (Nm) from Q of a few up; here
// the shared-memory lookups (random banks) are the real limit. Query tiles
// of one chunk run side by side, so a code row read again by the next tile
// mostly hits L2.
//
// Numbers: terms are summed in j order with __fadd_rn (adc_lut.cuh), then
// the extra term, then the bias, as the plain version in kernels/pq_adc.py
// does; the two agree bit for bit. A row whose bias is at or below
// NEG_INF/2 is not scored: the reference scores it near NEG_INF and its
// wrapper turns it into (-inf, -1), which an unfilled board entry becomes
// too.
//
// Top-k: each warp keeps one board per query of the tile (topk_board.cuh),
// keyed by row id; at the end of the chunk the boards of a query are folded
// into one and written out raw, and pq_adc_merge folds the chunks of each
// query into the sorted (Q, k) result. Ties: the lower row id first, as
// lax.top_k keeps the lower position.
#include "adc_lut.cuh"
#include "topk_board.cuh"

using namespace thistle;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxQT = 8;  // queries a block takes at most

// Shared memory a block needs for each query of its tile: the warps'
// boards, the int8 scales of every table row, and the staged table.
size_t query_smem(int dt, int m, int M, int W, int k) {
  const int sw = W < 256 ? W : 256;
  return (sizeof(float) + sizeof(int)) * (size_t)kWarps * k + sizeof(float) * (size_t)M +
         lut_bytes(dt) * (size_t)m * sw;
}

template <int DT>
__global__ void __launch_bounds__(kThreads)
    pq_adc_partial(const uint8_t* __restrict__ codes, const int* __restrict__ extra,
                   const void* __restrict__ luts_v, const float* __restrict__ scales,
                   const float* __restrict__ bias, long long N, int Q, int m, int W,
                   int has_extra, int k, int qt, long long rows_per_chunk,
                   float* __restrict__ part_s, int* __restrict__ part_key) {
  using LT = typename LutT<DT>::T;
  const LT* luts = static_cast<const LT*>(luts_v);
  const int M = m + has_extra;
  const int sw = min(W, 256);
  const int table = m * sw;
  extern __shared__ __align__(16) unsigned char smem[];
  float* board_s = reinterpret_cast<float*>(smem);                     // [qt][kWarps][k]
  int* board_key = reinterpret_cast<int*>(board_s + qt * kWarps * k);  // [qt][kWarps][k]
  float* sc = reinterpret_cast<float*>(board_key + qt * kWarps * k);   // [qt][M]
  LT* tab = reinterpret_cast<LT*>(sc + qt * M);                        // [qt][m][sw]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * qt;
  const int nq = min(qt, Q - q0);
  const int chunk = blockIdx.y;

  for (int e = tid; e < nq * table; e += kThreads) {
    const int qi = e / table;
    const int r = e - qi * table;
    const int j = r / sw;
    tab[e] = luts[((long)(q0 + qi) * M + j) * W + (r - j * sw)];
  }
  if (DT == kI8)
    for (int e = tid; e < nq * M; e += kThreads) sc[e] = scales[(long)q0 * M + e];

  WarpBoard board[kMaxQT];
#pragma unroll
  for (int qi = 0; qi < kMaxQT; ++qi)
    if (qi < nq)
      board[qi].init(board_s + (qi * kWarps + warp) * k, board_key + (qi * kWarps + warp) * k, k);
  __syncthreads();

  const long long r_begin = (long long)chunk * rows_per_chunk;
  const long long r_end = min(N, r_begin + rows_per_chunk);
  for (long long base = r_begin; base < r_end; base += kThreads) {
    const long long n = base + tid;
    const float b = n < r_end ? bias[n] : kNegInf;
    const bool live = b > 0.5f * kNegInf;
    float acc[kMaxQT];
#pragma unroll
    for (int qi = 0; qi < kMaxQT; ++qi) acc[qi] = -0.0f;
    if (live) {
      const uint8_t* code = codes + n * m;
      const bool words = (m & 3) == 0;
      for (int j0 = 0; j0 < m; j0 += 4) {
        const uint32_t v = words ? __ldg(reinterpret_cast<const uint32_t*>(code + j0)) : 0u;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = j0 + u;
          if (j < m) {
            const int c = words ? (int)((v >> (8 * u)) & 0xff) : (int)__ldg(code + j);
#pragma unroll
            for (int qi = 0; qi < kMaxQT; ++qi)
              if (qi < nq)
                acc[qi] = __fadd_rn(acc[qi], lut_term<DT, false>(tab + qi * table, j * sw + c,
                                                                 scale_of<DT, false>(sc + qi * M, j)));
          }
        }
      }
      if (has_extra) {
        const int c = __ldg(extra + n);
#pragma unroll
        for (int qi = 0; qi < kMaxQT; ++qi)
          if (qi < nq)
            acc[qi] = __fadd_rn(acc[qi],
                                lut_term<DT, true>(luts + ((long)(q0 + qi) * M + m) * W, c,
                                                   scale_of<DT, false>(sc + qi * M, m)));
      }
#pragma unroll
      for (int qi = 0; qi < kMaxQT; ++qi) acc[qi] = __fadd_rn(acc[qi], b);
    }
#pragma unroll
    for (int qi = 0; qi < kMaxQT; ++qi)
      if (qi < nq) board[qi].fold_lanes(acc[qi], (int)n, live);
  }

  __syncthreads();
  for (int qi = warp; qi < nq; qi += kWarps) {
    float* s0 = board_s + qi * kWarps * k;
    int* k0 = board_key + qi * kWarps * k;
    WarpBoard merged;
    merged.attach(s0, k0, k);
    fold_parts(merged, s0 + k, k0 + k, (long)(kWarps - 1) * k);
    const long off = ((long)(q0 + qi) * gridDim.y + chunk) * k;
    merged.write_raw(part_s + off, part_key + off);
  }
}

struct RowId {
  __device__ int operator()(int key) const { return key == kEmptyKey ? -1 : key; }
};

__global__ void __launch_bounds__(kThreads)
    pq_adc_merge(const float* __restrict__ part_s, const int* __restrict__ part_key, int Q,
                 int n_chunks, int k, float* __restrict__ out_s, int* __restrict__ out_i) {
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
  board.write_sorted(out_s + (long)q * k, out_i + (long)q * k, RowId{});
}

template <int DT>
int launch_partial(const void* codes, const void* extra, const void* luts, const void* scales,
                   const void* bias, long long N, int Q, int m, int W, int has_extra, int k,
                   int qt, int n_chunks, long long rows_per_chunk, void* part_s, void* part_key,
                   cudaStream_t st) {
  const size_t smem = (size_t)qt * query_smem(DT, m, m + has_extra, W, k);
  cudaError_t err = cudaFuncSetAttribute(pq_adc_partial<DT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Q + qt - 1) / qt, n_chunks);
  pq_adc_partial<DT><<<grid, kThreads, smem, st>>>(
      static_cast<const uint8_t*>(codes), static_cast<const int*>(extra), luts,
      static_cast<const float*>(scales), static_cast<const float*>(bias), N, Q, m, W, has_extra,
      k, qt, rows_per_chunk, static_cast<float*>(part_s), static_cast<int*>(part_key));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

size_t pq_adc_query_smem(int lut_type, int m, int has_extra, int W, int k) {
  return query_smem(lut_type, m, m + has_extra, W, k);
}

// codes (N, m) uint8; extra (N,) int32 or null; luts (Q, m + has_extra, W)
// in float32, bfloat16 or int8 (lut_type 0, 1, 2) with scales
// (Q, m + has_extra) float32 for int8; bias (N,) float32; part_* (Q,
// n_chunks, k) scratch; out_s (Q, k) float32, out_i (Q, k) int32. A block
// takes qt queries and rows_per_chunk rows. Returns the CUDA error code.
int pq_adc_launch(const void* codes, const void* extra, const void* luts, const void* scales,
                  const void* bias, long long N, int Q, int m, int W, int has_extra,
                  int lut_type, int k, int qt, int n_chunks, long long rows_per_chunk,
                  void* part_s, void* part_key, void* out_s, void* out_i, void* stream) {
  if (k < 1 || k > kMaxK || qt < 1 || qt > kMaxQT || m < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  int err;
  switch (lut_type) {
    case kF32:
      err = launch_partial<kF32>(codes, extra, luts, scales, bias, N, Q, m, W, has_extra, k, qt,
                                 n_chunks, rows_per_chunk, part_s, part_key, st);
      break;
    case kBF16:
      err = launch_partial<kBF16>(codes, extra, luts, scales, bias, N, Q, m, W, has_extra, k,
                                  qt, n_chunks, rows_per_chunk, part_s, part_key, st);
      break;
    case kI8:
      err = launch_partial<kI8>(codes, extra, luts, scales, bias, N, Q, m, W, has_extra, k, qt,
                                n_chunks, rows_per_chunk, part_s, part_key, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  const size_t smem = (sizeof(float) + sizeof(int)) * kWarps * (size_t)k;
  pq_adc_merge<<<(Q + kWarps - 1) / kWarps, kThreads, smem, st>>>(
      static_cast<const float*>(part_s), static_cast<const int*>(part_key), Q, n_chunks, k,
      static_cast<float*>(out_s), static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}

const char* thistle_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
