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
// because Mosaic has no vector gather. Hopper gathers directly: the
// per-query grid stages the query's table in shared memory (m * ksub
// entries in float32, bfloat16, or int8 with m scales) and each lane looks
// its slot's codes up, reading the uint8 codes as they are stored.
//
// Per-query grid (ivf_adc_partial): one block per (query, chunk of visit
// steps), so a single query still fills the SMs; each of the 8 warps takes
// one visit step at a time, one slot a lane. What bounds it: the visited
// code blocks, blk * (m + 4) bytes a step, read once per visiting query.
//
// Grouped grids: build_block_schedule (core/ivf.py) sorts the (query,
// step) pairs by block and cuts each block's run into groups of qblk pairs,
// dropping the pairs that visit the pad block. The blocked grid runs one
// block per group, the run-resident grid one block per run (a distinct
// block with all its groups), so a code block is read once per group or
// once per batch. A block stages its code block and slot ids in shared
// memory; each warp scores one pair against it, reading the pair's table
// row from device memory through the read-only cache (a (qblk, m * ksub)
// float32 panel, 512 KB at m = 64, does not fit a block; the batch's
// tables, Q * 64 KB, stay in L2). On the TPU a grid step merges each pair
// into one scoreboard carried from step to step; Hopper's blocks run at
// once, so each pair writes its blk scores out (ivf_adc_pairs) and records
// where (pair_of[q, t]), and the per-query pass (ivf_adc_gather) folds a
// query's pairs in visit order into chunk boards, which ivf_adc_merge
// folds as for the per-query grid. No atomics.
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
// t * blk + slot, and ivf_adc_merge maps positions back to row ids. Ties:
// the lower visit position first, as the reference's top-k over the visit
// order gives, whatever order the pairs were scored in.
#include "adc_lut.cuh"
#include "topk_board.cuh"

using namespace thistle;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

// Grouped grids, pass 1: score the pairs of one schedule group (blocked,
// runs = 0) or of all the groups of one run (run-resident, runs = 1)
// against their shared code block. Pair g * qblk + i writes its blk scores
// to pair_s (-inf for a slot with id -1) and its index to pair_of[q, t];
// sentinel pairs (q = -1) and knocked-out probes write nothing, so their
// pair_of entry keeps the caller's -1.
template <int DT>
__global__ void __launch_bounds__(kThreads)
    ivf_adc_pairs(const uint8_t* __restrict__ codes, const int* __restrict__ ids,
                  const void* __restrict__ luts, const float* __restrict__ scales,
                  const float* __restrict__ coarse, const int* __restrict__ block_of,
                  const int* __restrict__ run_start, const int* __restrict__ run_len,
                  const int* __restrict__ sched_q, const int* __restrict__ sched_t, int T,
                  int blk, int m, int ksub, int spp, int per_probe, int qblk, int runs,
                  float* __restrict__ pair_s, int* __restrict__ pair_of) {
  using LT = typename LutT<DT>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  int* id_s = reinterpret_cast<int*>(smem);                      // [blk]
  uint8_t* code_s = reinterpret_cast<uint8_t*>(id_s + blk);      // [blk * m]

  const int g0 = runs ? run_start[blockIdx.x] : blockIdx.x;
  const int n_groups = runs ? run_len[blockIdx.x] : 1;
  if (n_groups == 0) return;  // a pad run (block-uniform)
  const long b = block_of[blockIdx.x];
  for (int e = threadIdx.x; e < blk; e += blockDim.x) id_s[e] = ids[b * blk + e];
  if ((m & 3) == 0) {
    const uint32_t* src = reinterpret_cast<const uint32_t*>(codes + b * blk * m);
    uint32_t* dst = reinterpret_cast<uint32_t*>(code_s);
    for (int e = threadIdx.x; e < blk * m / 4; e += blockDim.x) dst[e] = __ldg(src + e);
  } else {
    for (int e = threadIdx.x; e < blk * m; e += blockDim.x) code_s[e] = codes[b * blk * m + e];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int nprobe = T / spp;
  const int n_pairs = n_groups * qblk;
  for (int i = threadIdx.x >> 5; i < n_pairs; i += blockDim.x >> 5) {
    const long gp = (long)g0 * qblk + i;
    const int q = sched_q[gp];
    if (q < 0) continue;  // sentinel (warp-uniform, as is all below)
    const int t = sched_t[gp];
    const int p = t / spp;
    const float cp = coarse[(long)q * nprobe + p];
    if (cp <= 0.5f * kNegInf) continue;  // knocked-out probe
    const long row = per_probe ? (long)q * nprobe + p : (long)q;
    const LT* lut = static_cast<const LT*>(luts) + row * m * ksub;
    const float* sc = DT == kI8 ? scales + row * m : nullptr;
    for (int slot = lane; slot < blk; slot += 32) {
      float s = -INFINITY;
      if (id_s[slot] >= 0)
        s = __fadd_rn(adc_sum<DT, true, false>(code_s + slot * m, m, ksub, lut, sc), cp);
      pair_s[gp * blk + slot] = s;
    }
    if (lane == 0) pair_of[(long)q * T + t] = (int)gp;
  }
}

// Grouped grids, pass 2: per (query, chunk of visit steps), fold the
// query's scored pairs into a board keyed by visit position, as
// ivf_adc_partial does with the scores it computes.
__global__ void __launch_bounds__(kThreads)
    ivf_adc_gather(const float* __restrict__ pair_s, const int* __restrict__ pair_of, int T,
                   int blk, int k, int steps_per_chunk, float* __restrict__ part_s,
                   int* __restrict__ part_key) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* board_s = reinterpret_cast<float*>(smem);                // [kWarps][k]
  int* board_key = reinterpret_cast<int*>(board_s + kWarps * k);  // [kWarps][k]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q = blockIdx.x;
  const int chunk = blockIdx.y;
  const int t_end = min(T, (chunk + 1) * steps_per_chunk);

  WarpBoard board;
  board.init(board_s + warp * k, board_key + warp * k, k);
  for (int t = chunk * steps_per_chunk + warp; t < t_end; t += kWarps) {
    const long pr = pair_of[(long)q * T + t];
    if (pr < 0) continue;  // pad block, knocked-out probe (warp-uniform)
    for (int s0 = 0; s0 < blk; s0 += 32) {
      const int slot = s0 + lane;
      const float s = slot < blk ? pair_s[pr * blk + slot] : -INFINITY;
      board.fold_lanes(s, t * blk + slot, s != -INFINITY);
    }
  }
  fold_warps_and_write(board, board_s, board_key, k, part_s, part_key,
                       ((long)q * gridDim.y + chunk) * k);
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

template <int DT>
int launch_pairs(const void* codes, const void* ids, const void* luts, const void* scales,
                 const void* coarse, const void* block_of, const void* run_start,
                 const void* run_len, const void* sched_q, const void* sched_t, int T, int blk,
                 int m, int ksub, int spp, int per_probe, int qblk, int runs, int n_programs,
                 void* pair_s, void* pair_of, cudaStream_t st) {
  const size_t smem = sizeof(int) * (size_t)blk + (size_t)blk * m;
  cudaError_t err = cudaFuncSetAttribute(ivf_adc_pairs<DT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = runs ? kThreads : 32 * min(qblk, kWarps);
  ivf_adc_pairs<DT><<<n_programs, threads, smem, st>>>(
      static_cast<const uint8_t*>(codes), static_cast<const int*>(ids), luts,
      static_cast<const float*>(scales), static_cast<const float*>(coarse),
      static_cast<const int*>(block_of), static_cast<const int*>(run_start),
      static_cast<const int*>(run_len), static_cast<const int*>(sched_q),
      static_cast<const int*>(sched_t), T, blk, m, ksub, spp, per_probe, qblk, runs,
      static_cast<float*>(pair_s), static_cast<int*>(pair_of));
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

}  // namespace

extern "C" {

size_t ivf_adc_smem_bytes(int lut_type, int m, int ksub, int k) {
  return partial_smem(lut_type, m, ksub, k);
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

// The grouped grids. block_of is sched_block (G,) for the blocked grid
// (runs = 0, n_programs = G) or run_block (R,) for the run-resident grid
// (runs = 1, n_programs = R, with run_start / run_len (R,)); sched_q /
// sched_t (G, qblk) int32, -1 in sched_q = sentinel. pair_s (G * qblk *
// blk) float32 and pair_of (Q, T) int32, filled with -1 by the caller, are
// scratch; the other arguments as ivf_adc_launch.
int ivf_adc_grouped_launch(const void* codes, const void* ids, const void* visit,
                           const void* luts, const void* scales, const void* coarse,
                           const void* block_of, const void* run_start, const void* run_len,
                           const void* sched_q, const void* sched_t, int Q, int T, int blk, int m,
                           int ksub, int spp, int per_probe, int lut_type, int k, int qblk,
                           int runs, int n_programs, int n_chunks, int steps_per_chunk,
                           void* pair_s, void* pair_of, void* part_s, void* part_key,
                           void* out_s, void* out_i, void* stream) {
  if (k < 1 || k > kMaxK || spp < 1 || T % spp != 0 || qblk < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  int err;
  switch (lut_type) {
    case kF32:
      err = launch_pairs<kF32>(codes, ids, luts, scales, coarse, block_of, run_start, run_len,
                               sched_q, sched_t, T, blk, m, ksub, spp, per_probe, qblk, runs,
                               n_programs, pair_s, pair_of, st);
      break;
    case kBF16:
      err = launch_pairs<kBF16>(codes, ids, luts, scales, coarse, block_of, run_start, run_len,
                                sched_q, sched_t, T, blk, m, ksub, spp, per_probe, qblk, runs,
                                n_programs, pair_s, pair_of, st);
      break;
    case kI8:
      err = launch_pairs<kI8>(codes, ids, luts, scales, coarse, block_of, run_start, run_len,
                              sched_q, sched_t, T, blk, m, ksub, spp, per_probe, qblk, runs,
                              n_programs, pair_s, pair_of, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  const size_t smem = (sizeof(float) + sizeof(int)) * kWarps * (size_t)k;
  ivf_adc_gather<<<dim3(Q, n_chunks), kThreads, smem, st>>>(
      static_cast<const float*>(pair_s), static_cast<const int*>(pair_of), T, blk, k,
      steps_per_chunk, static_cast<float*>(part_s), static_cast<int*>(part_key));
  err = (int)cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_merge(part_s, part_key, ids, visit, Q, T, blk, n_chunks, k, out_s, out_i, st);
}

const char* thistle_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
