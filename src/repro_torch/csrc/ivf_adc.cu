// Bucket-resident IVF-ADC + top-k for Hopper (sm_90a), per-query grid.
//
// Replaces the Pallas kernel src/repro/kernels/ivf_adc.py (ivf_adc, body
// _ivf_adc_kernel). For query q and visit step t it scores every slot of
// block b = visit[q, t]:
//   score = sum_j lut[q(, p), j, codes[b, slot, j]] + coarse[q, p],
//   p = t / steps_per_probe,
// knocks out slots whose id is -1, and keeps the best k per query.
//
// The TPU kernel turns the table lookup into a one-hot matrix product
// because Mosaic has no vector gather. Hopper gathers from shared memory,
// so a block stages the query's table there (m * ksub entries in float32,
// bfloat16, or int8 with m scales) and each lane looks its codes up
// directly, reading the uint8 codes as they are stored.
//
// What bounds it: the visited code blocks, blk * (m + 4) bytes a visit
// step, read from device memory; the table is read once a block (once a
// probe for l2's per-probe tables). The grid is (query, chunk of visit
// steps) so that a single query still fills the SMs; each of a block's 8
// warps takes one visit step at a time, one slot a lane.
//
// Numbers: each slot sums its m terms in j order in float32 with
// __fadd_rn, and the int8 term is __fmul_rn(q8, scale), so no multiply-add
// is contracted; the plain version in kernels/ivf_adc.py does the same
// operations in the same order, and the two agree bit for bit.
//
// Skipped work: a slot with id -1 (pad or tombstone) and a probe whose
// coarse term is at or below NEG_INF/2 (a knocked-out probe) are not
// scored. The reference scores them near NEG_INF and its wrapper turns any
// such score into (-inf, -1); an unfilled board entry ends as the same
// (-inf, -1), after every real candidate, so the result is the same.
//
// Top-k: each warp keeps a board (topk_board.cuh) keyed by the visit
// position t * blk + slot; at the end of the chunk warp 0 folds the other
// seven into the block's board, and ivf_adc_merge folds the chunks of a
// query and maps positions back to row ids. Ties: the lower visit position
// first, as the reference's top-k over the visit order gives.
#include <cuda_bf16.h>

#include "topk_board.cuh"

using namespace thistle;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

enum LutType { kF32 = 0, kBF16 = 1, kI8 = 2 };

template <int DT>
struct Lut;
template <>
struct Lut<kF32> {
  using T = float;
  __device__ static float get(const T* lut, int i, const float*, int) { return lut[i]; }
};
template <>
struct Lut<kBF16> {
  using T = __nv_bfloat16;
  __device__ static float get(const T* lut, int i, const float*, int) {
    return __bfloat162float(lut[i]);
  }
};
template <>
struct Lut<kI8> {
  using T = int8_t;
  __device__ static float get(const T* lut, int i, const float* scales, int j) {
    return __fmul_rn((float)lut[i], scales[j]);
  }
};

template <int DT>
__device__ __forceinline__ float adc_sum(const uint8_t* __restrict__ code, int m, int ksub,
                                         const typename Lut<DT>::T* lut, const float* scales) {
  float acc = 0.f;
  if ((m & 3) == 0) {
    const uint32_t* words = reinterpret_cast<const uint32_t*>(code);
    for (int w = 0; w < m / 4; ++w) {
      const uint32_t v = __ldg(words + w);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = 4 * w + u;
        acc = __fadd_rn(acc, Lut<DT>::get(lut, j * ksub + ((v >> (8 * u)) & 0xff), scales, j));
      }
    }
  } else {
    for (int j = 0; j < m; ++j)
      acc = __fadd_rn(acc, Lut<DT>::get(lut, j * ksub + __ldg(code + j), scales, j));
  }
  return acc;
}

size_t lut_bytes(int dt) { return dt == kF32 ? 4 : dt == kBF16 ? 2 : 1; }

size_t partial_smem(int dt, int m, int ksub, int k) {
  return (sizeof(float) + sizeof(int)) * (size_t)kWarps * k + sizeof(float) * (size_t)m +
         lut_bytes(dt) * (size_t)m * ksub;
}

template <int DT>
__global__ void __launch_bounds__(kThreads)
    ivf_adc_partial(const uint8_t* __restrict__ codes, const int* __restrict__ ids,
                    const int* __restrict__ visit, const void* __restrict__ luts,
                    const float* __restrict__ scales, const float* __restrict__ coarse, int T,
                    int blk, int m, int ksub, int spp, int per_probe, int k, int steps_per_chunk,
                    float* __restrict__ part_s, int* __restrict__ part_key) {
  using LT = typename Lut<DT>::T;
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
  const int n_chunks = gridDim.y;
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
          s = __fadd_rn(adc_sum<DT>(codes + (b * blk + slot) * m, m, ksub, lut, sc), cp);
        board.fold_lanes(s, t * blk + slot, id >= 0);
      }
    }
  }

  __syncthreads();
  if (warp == 0) {
    for (int w = 1; w < kWarps; ++w)
      for (int e0 = 0; e0 < k; e0 += 32) {
        const int e = e0 + lane;
        const bool in = e < k;
        const float s = in ? board_s[w * k + e] : -INFINITY;
        const int key = in ? board_key[w * k + e] : kEmptyKey;
        board.fold_lanes(s, key, in && key != kEmptyKey);
      }
    const long off = ((long)q * n_chunks + chunk) * k;
    board.write_raw(part_s + off, part_key + off);
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
  const size_t smem = (sizeof(float) + sizeof(int)) * kWarps * (size_t)k;
  ivf_adc_merge<<<(Q + kWarps - 1) / kWarps, kThreads, smem, st>>>(
      static_cast<const float*>(part_s), static_cast<const int*>(part_key),
      static_cast<const int*>(ids), static_cast<const int*>(visit), Q, T, blk, n_chunks, k,
      static_cast<float*>(out_s), static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}

const char* thistle_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
