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
// held in VMEM. Here the tables of a query tile sit in shared memory and
// every term is one shared-memory lookup: only the first min(W, 256)
// entries of a uint8 subspace's row can be indexed, so only those are
// staged (64 KB a float32 table at m = 64); the `extra` row is read from
// device memory through the read-only cache.
//
// What bounds it: one lookup and one float32 add a term, m of them for
// each (query, live row) pair, against the code bytes (N m) read once.
// Shared memory serves 32 lookups a clock per SM (132 x 1980 MHz x 32 =
// 8.4e12/s on an H100 SXM), the adds run at half the 67e12/s FMA rate, so
// from Q of a few up the lookups bind: 2.2 ms at Q = 32, m = 64, N = 8.8M.
// Lanes are rows and codes are random, so a warp's lookup meets about 3.5
// lanes on one bank; that conflict, not the bound, is the realistic floor
// (about 9 lookups a clock per SM).
//
// The design:
// * One block of 16 warps (two at a query tile of 1 or 2) shares the
//   staged tables of QT queries: QT is a template parameter (1, 2, 3, 4,
//   6, 8 or 12), at most as many tables as fit beside the ring and the
//   boards: at m = 64, 3 float32, 4 bf16 or 8 int8. Queries of a ragged last
//   tile repeat its last query and are never offered, so the inner loop
//   has no query predicate.
// * A block walks the row tiles (512 rows, one a thread) of its chunk; the
//   codes of a tile come in slabs of 32 subspaces (16 KB) through a
//   cp.async ring of 2 or 3 stages: two 16-byte copies a row, coalesced.
//   A slab row's two 16-byte chunks swap places in every other group of
//   four rows, so a thread's 16-byte reads of its row hit 8 distinct bank
//   groups a quarter warp. m not a multiple of 16 stages byte by byte.
// * Within a slab a thread issues the lookups of a group of subspaces for
//   every query of the tile before their adds, which stay in j order.
// * Top-k: a threshold ahead of sorted boards (GateBoards, topk_board.cuh).
//   After each tile every (row, query) score is compared with the query's
//   current k-th best; only a beater goes to the query's candidate list,
//   which the warp owning the query folds into its board (one bitonic
//   batch, in a call that keeps the board's registers out of the lookup
//   loop) when the list fills and at the end of the chunk. One barrier a
//   tile in steady state.
// * The launch plan (kernels/pq_adc.py `plan`) picks QT, the ring depth
//   and the chunks from the card's shared memory, SMs and this kernel's
//   register bound; pq_adc_merge then folds the chunk boards of each query
//   on a block of its own, after pq_adc_merge_slices has folded slices of
//   them on several blocks a query where Q is small.
//
// Numbers: terms are summed in j order with __fadd_rn (adc_lut.cuh), then
// the extra term, then the bias, as the plain version in kernels/pq_adc.py
// does; the two agree bit for bit. A row whose bias is at or below
// NEG_INF/2 is not offered: the reference scores it near NEG_INF and its
// wrapper turns it into (-inf, -1), which an unfilled board entry becomes
// too. Ties: the lower row id first, as lax.top_k keeps the lower position.
#include "adc_lut.cuh"
#include "topk_board.cuh"

using namespace thistle;

namespace {

constexpr int kThreads = 512;  // sixteen warps, a row each thread
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = kThreads;
constexpr int kSlab = 32;  // code bytes (subspaces) of a row in one ring stage
constexpr int kStageBytes = kTileRows * kSlab;
constexpr int kMergeThreads = 256;

// Blocks an SM the kernel's register bound allows: two at a query tile of
// 1 or 2 (64 registers a thread), else one (128). kernels/pq_adc.py
// mirrors this.
__host__ __device__ constexpr int min_blocks(int qt) { return qt <= 2 ? 2 : 1; }

// Subspaces whose lookups a thread issues before their adds.
__host__ __device__ constexpr int group_of(int qt) { return qt <= 3 ? 8 : 4; }

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) / 16 * 16; }

// Dynamic shared memory of a block: the ring, QT tables (16-byte aligned
// as a whole), QT rows of int8 scales, the boards. kernels/pq_adc.py
// `smem_bytes` mirrors this.
size_t partial_smem(int dt, int qt, int m, int M, int W, int k, int stages) {
  const size_t sw = W < 256 ? W : 256;
  return (size_t)stages * kStageBytes + align16(lut_bytes(dt) * qt * m * sw) +
         (dt == kI8 ? sizeof(float) * qt * M : 0) + GateBoards::bytes(qt, k);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Byte offset of 16-byte chunk h of slab row r: the chunks swap in rows
// 4..7 of every 8, so a quarter warp's reads of chunk h spread over 8 bank
// groups.
__device__ __forceinline__ int slab_off(int r, int h) {
  return r * kSlab + ((h ^ ((r >> 2) & 1)) << 4);
}

// The terms of one slab: subspaces j0 .. j0 + jn - 1 of this thread's row
// (codes in w), for every query of the tile, added to acc in j order. FULL:
// jn == kSlab, no bound checks.
template <int DT, int QT, bool FULL>
__device__ __forceinline__ void slab_terms(float (&acc)[QT], const uint32_t (&w)[8],
                                           const typename LutT<DT>::T* tab, const float* sc,
                                           int table, int sw, int M, int j0, int jn) {
  constexpr int G = group_of(QT);
#pragma unroll
  for (int g = 0; g < kSlab; g += G) {
    float t[G][QT];
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int jj = g + u;
      if (FULL || jj < jn) {
        const int c = (int)((w[jj >> 2] >> (8 * (jj & 3))) & 0xffu);
        const int idx = (j0 + jj) * sw + c;
#pragma unroll
        for (int qi = 0; qi < QT; ++qi)
          t[u][qi] = lut_term<DT, false>(tab + qi * table, idx,
                                         scale_of<DT, false>(sc + qi * M, j0 + jj));
      }
    }
#pragma unroll
    for (int u = 0; u < G; ++u)
      if (FULL || g + u < jn)
#pragma unroll
        for (int qi = 0; qi < QT; ++qi) acc[qi] = __fadd_rn(acc[qi], t[u][qi]);
  }
}

template <int DT, int QT>
__global__ void __launch_bounds__(kThreads, min_blocks(QT))
    pq_adc_partial(const uint8_t* __restrict__ codes, const int* __restrict__ extra,
                   const void* __restrict__ luts_v, const float* __restrict__ scales,
                   const float* __restrict__ bias, long long N, int Q, int m, int W,
                   int has_extra, int k, int stages, long long rows_per_chunk,
                   float* __restrict__ part_s, int* __restrict__ part_key) {
  using LT = typename LutT<DT>::T;
  const LT* luts = static_cast<const LT*>(luts_v);
  const int M = m + has_extra;
  const int sw = min(W, 256);
  const int table = m * sw;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;  // [stages][kTileRows][kSlab]
  LT* tab = reinterpret_cast<LT*>(ring + (size_t)stages * kStageBytes);  // [QT][m][sw]
  float* sc = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(tab) +
                                       align16(sizeof(LT) * (size_t)QT * table));  // [QT][M]
  const int q0 = blockIdx.x * QT;
  GateBoards gate;
  gate.carve(reinterpret_cast<unsigned char*>(sc + (DT == kI8 ? QT * M : 0)), QT, k);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int nq = min(QT, Q - q0);
  const int chunk = blockIdx.y;
  const int n_chunks = gridDim.y;
  // query of tile slot qi; a ragged tile repeats its last query
  auto qof = [&](int qi) { return q0 + min(qi, nq - 1); };

  for (int e = tid; e < QT * table; e += kThreads) {
    const int qi = e / table;
    const int r = e - qi * table;
    const int j = r / sw;
    tab[e] = luts[((long)qof(qi) * M + j) * W + (r - j * sw)];
  }
  if (DT == kI8)
    for (int e = tid; e < QT * M; e += kThreads) sc[e] = scales[(long)qof(e / M) * M + e % M];
  gate.init(QT);
  __syncthreads();

  const long long r_begin = (long long)chunk * rows_per_chunk;
  const long long r_end = min(N, r_begin + rows_per_chunk);
  const int n_tiles = r_end > r_begin ? (int)((r_end - r_begin + kTileRows - 1) / kTileRows) : 0;
  const int n_slabs = (m + kSlab - 1) / kSlab;
  const int total = n_tiles * n_slabs;
  const bool vec = (m & 15) == 0;

  // copy slab i (tile i / n_slabs, subspaces from 32 (i % n_slabs)) into its stage
  auto load = [&](int i) {
    const int tile = i / n_slabs, slab = i - tile * n_slabs;
    unsigned char* st = ring + (size_t)(i % stages) * kStageBytes;
    const long long n0 = r_begin + (long long)tile * kTileRows;
    if (vec) {
      for (int e = tid; e < kTileRows * 2; e += kThreads) {
        const int r = e >> 1, h = e & 1;
        const int off = slab * kSlab + h * 16;
        const bool ok = n0 + r < r_end && off < m;
        cp_async16(st + slab_off(r, h), ok ? codes + (n0 + r) * m + off : codes, ok);
      }
    } else {
      for (int e = tid; e < kTileRows * kSlab; e += kThreads) {
        const int r = e >> 5, b = e & 31;
        const int off = slab * kSlab + b;
        const bool ok = n0 + r < r_end && off < m;
        st[slab_off(r, b >> 4) + (b & 15)] = ok ? codes[(n0 + r) * m + off] : 0;
      }
    }
  };

  for (int i = 0; i < stages - 1; ++i) {
    if (i < total) load(i);
    cp_async_commit();
  }

  float acc[QT];
  long long n = 0;
  float b = 0.f;
  bool live = false;
  int xc = 0;
  for (int i = 0; i < total; ++i) {
    if (stages == 2)
      cp_async_wait<0>();
    else
      cp_async_wait<1>();
    __syncthreads();  // slab i landed for every thread; slab i - 1 is read
    if (i + stages - 1 < total) load(i + stages - 1);
    cp_async_commit();

    const int tile = i / n_slabs, slab = i - tile * n_slabs;
    if (slab == 0) {
      n = r_begin + (long long)tile * kTileRows + tid;
      b = n < r_end ? __ldg(bias + n) : kNegInf;
      live = b > 0.5f * kNegInf;
      xc = has_extra && live ? __ldg(extra + n) : 0;
#pragma unroll
      for (int qi = 0; qi < QT; ++qi) acc[qi] = -0.0f;
    }
    const unsigned char* st = ring + (size_t)(i % stages) * kStageBytes;
    const uint4 c0 = *reinterpret_cast<const uint4*>(st + slab_off(tid, 0));
    const uint4 c1 = *reinterpret_cast<const uint4*>(st + slab_off(tid, 1));
    const uint32_t w[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
    const int j0 = slab * kSlab;
    const int jn = min(kSlab, m - j0);
    if (jn == kSlab)
      slab_terms<DT, QT, true>(acc, w, tab, sc, table, sw, M, j0, jn);
    else
      slab_terms<DT, QT, false>(acc, w, tab, sc, table, sw, M, j0, jn);
    if (slab != n_slabs - 1) continue;

    // ---- end of a tile: the extra term, the bias, the threshold, the boards
    if (has_extra) {
#pragma unroll
      for (int qi = 0; qi < QT; ++qi)
        acc[qi] = __fadd_rn(acc[qi],
                            lut_term<DT, true>(luts + ((long)qof(qi) * M + m) * W, xc,
                                               scale_of<DT, false>(sc + qi * M, m)));
    }
    uint32_t pend = 0;
#pragma unroll
    for (int qi = 0; qi < QT; ++qi) {
      acc[qi] = __fadd_rn(acc[qi], b);
      if (live && qi < nq && gate.beats(qi, acc[qi], (int)n)) pend |= 1u << qi;
    }
    while (true) {
      bool full = false;
      if (pend) {
#pragma unroll
        for (int qi = 0; qi < QT; ++qi) {
          if (!(pend & (1u << qi))) continue;
          if (gate.offer(qi, acc[qi], (int)n))
            pend &= ~(1u << qi);
          else
            full = true;
        }
      }
      if (!__syncthreads_or(full)) break;
      gate.fold(QT);
      __syncthreads();
    }
  }
  cp_async_wait<0>();
  gate.fold(QT);  // what the lists still hold
  __syncthreads();

  for (int r = warp; r < nq; r += kWarps) {
    const long off = ((long)(q0 + r) * n_chunks + chunk) * k;
    gate.write_raw(r, part_s + off, part_key + off);
  }
}

struct RowId {
  __device__ int operator()(int key) const { return key == kEmptyKey ? -1 : key; }
};

// The merge's first level: block (q, g) folds slice g of query q's chunk
// boards into one raw board (merge_slice, topk_board.cuh).
template <int E>
__global__ void __launch_bounds__(kMergeThreads)
    pq_adc_merge_slices(const float* __restrict__ part_s, const int* __restrict__ part_key,
                        int n_chunks, int groups, int k, float* __restrict__ slice_s,
                        int* __restrict__ slice_key) {
  extern __shared__ __align__(16) unsigned char smem[];
  merge_slice<E>(part_s, part_key, n_chunks, groups, k, smem, slice_s, slice_key);
}

// The last level: one block a query folds its boards, writes the sorted top-k.
template <int E>
__global__ void __launch_bounds__(kMergeThreads)
    pq_adc_merge(const float* __restrict__ part_s, const int* __restrict__ part_key,
                 int n_chunks, int k, float* __restrict__ out_s, int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  merge_query<E>(part_s, part_key, n_chunks, k, smem, out_s, out_i, RowId{}, SameScore{});
}

// Both levels of the merge for boards of k entries held in E slots a lane.
template <int E>
void launch_merge(const float* part_s, const int* part_key, int Q, int n_chunks, int k,
                  int groups, float* slice_s, int* slice_key, float* out_s, int* out_i,
                  cudaStream_t st) {
  const size_t smem = (sizeof(float) + sizeof(int)) * (kMergeThreads / 32) * (size_t)k;
  if (groups > 1) {
    pq_adc_merge_slices<E><<<dim3(Q, groups), kMergeThreads, smem, st>>>(
        part_s, part_key, n_chunks, groups, k, slice_s, slice_key);
    part_s = slice_s;
    part_key = slice_key;
    n_chunks = groups;
  }
  pq_adc_merge<E><<<Q, kMergeThreads, smem, st>>>(part_s, part_key, n_chunks, k, out_s, out_i);
}

template <int DT, int QT>
int launch_partial(const void* codes, const void* extra, const void* luts, const void* scales,
                   const void* bias, long long N, int Q, int m, int W, int has_extra, int k,
                   int stages, int n_chunks, long long rows_per_chunk, void* part_s,
                   void* part_key, cudaStream_t st) {
  const size_t smem = partial_smem(DT, QT, m, m + has_extra, W, k, stages);
  cudaError_t err = cudaFuncSetAttribute(pq_adc_partial<DT, QT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Q + QT - 1) / QT, n_chunks);
  pq_adc_partial<DT, QT><<<grid, kThreads, smem, st>>>(
      static_cast<const uint8_t*>(codes), static_cast<const int*>(extra), luts,
      static_cast<const float*>(scales), static_cast<const float*>(bias), N, Q, m, W, has_extra,
      k, stages, rows_per_chunk, static_cast<float*>(part_s), static_cast<int*>(part_key));
  return (int)cudaGetLastError();
}

template <int DT>
int launch_dt(int qt, const void* codes, const void* extra, const void* luts,
              const void* scales, const void* bias, long long N, int Q, int m, int W,
              int has_extra, int k, int stages, int n_chunks, long long rows_per_chunk,
              void* part_s, void* part_key, cudaStream_t st) {
#define THISTLE_PQ_QT(QT)                                                                   \
  case QT:                                                                                  \
    return launch_partial<DT, QT>(codes, extra, luts, scales, bias, N, Q, m, W, has_extra, \
                                  k, stages, n_chunks, rows_per_chunk, part_s, part_key, st);
  switch (qt) {
    THISTLE_PQ_QT(1)
    THISTLE_PQ_QT(2)
    THISTLE_PQ_QT(3)
    THISTLE_PQ_QT(4)
    THISTLE_PQ_QT(6)
    THISTLE_PQ_QT(8)
    THISTLE_PQ_QT(12)
  }
#undef THISTLE_PQ_QT
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Shared memory bytes of one partial block (the plan's `smem`).
size_t pq_adc_smem(int lut_type, int qt, int m, int has_extra, int W, int k, int stages) {
  return partial_smem(lut_type, qt, m, m + has_extra, W, k, stages);
}

// codes (N, m) uint8, 16-byte aligned; extra (N,) int32 or null; luts (Q,
// m + has_extra, W) in float32, bfloat16 or int8 (lut_type 0, 1, 2) with
// scales (Q, m + has_extra) float32 for int8; bias (N,) float32; part_*
// (Q, n_chunks, k) scratch; slice_* (Q, groups, k) scratch when groups > 1
// (the merge's first level); out_s (Q, k) float32, out_i (Q, k) int32. qt
// (1, 2, 3, 4, 6, 8 or 12), stages (2 or 3), n_chunks, rows_per_chunk and
// groups as the plan gives them. Returns the CUDA error code.
int pq_adc_launch(const void* codes, const void* extra, const void* luts, const void* scales,
                  const void* bias, long long N, int Q, int m, int W, int has_extra,
                  int lut_type, int k, int qt, int stages, int n_chunks,
                  long long rows_per_chunk, void* part_s, void* part_key, int groups,
                  void* slice_s, void* slice_key, void* out_s, void* out_i, void* stream) {
  if (k < 1 || k > kMaxK || m < 1 || W < 1 || N < 1 || Q < 1 || stages < 2 || stages > 3 ||
      n_chunks < 1 || n_chunks > 65535 || rows_per_chunk < 1 || groups < 1 || groups > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  int err;
  switch (lut_type) {
    case kF32:
      err = launch_dt<kF32>(qt, codes, extra, luts, scales, bias, N, Q, m, W, has_extra, k,
                            stages, n_chunks, rows_per_chunk, part_s, part_key, st);
      break;
    case kBF16:
      err = launch_dt<kBF16>(qt, codes, extra, luts, scales, bias, N, Q, m, W, has_extra, k,
                             stages, n_chunks, rows_per_chunk, part_s, part_key, st);
      break;
    case kI8:
      err = launch_dt<kI8>(qt, codes, extra, luts, scales, bias, N, Q, m, W, has_extra, k,
                           stages, n_chunks, rows_per_chunk, part_s, part_key, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  const auto* ps = static_cast<const float*>(part_s);
  const auto* pk = static_cast<const int*>(part_key);
  auto* ss = static_cast<float*>(slice_s);
  auto* sk = static_cast<int*>(slice_key);
  auto* os = static_cast<float*>(out_s);
  auto* oi = static_cast<int*>(out_i);
  switch (sorted_slots(k)) {
    case 1: launch_merge<1>(ps, pk, Q, n_chunks, k, groups, ss, sk, os, oi, st); break;
    case 2: launch_merge<2>(ps, pk, Q, n_chunks, k, groups, ss, sk, os, oi, st); break;
    case 4: launch_merge<4>(ps, pk, Q, n_chunks, k, groups, ss, sk, os, oi, st); break;
    default: launch_merge<8>(ps, pk, Q, n_chunks, k, groups, ss, sk, os, oi, st); break;
  }
  return (int)cudaGetLastError();
}

const char* thistle_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
