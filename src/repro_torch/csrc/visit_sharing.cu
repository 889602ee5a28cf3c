// The sharing count of an IVF-ADC visit table, in one launch (sm_90a).
//
// Replaces no TPU kernel. The reference counts a visit table's sharing on
// the host (repro/core/ivf.py visit_sharing: a mask and np.unique); the port
// counts it on the card where the count decides no grid
// (kernels/ops.py ivf_adc_topk, kernels/visit_sharing.py), so that
// VectorDB.query need not wait for the card. Done with PyTorch's own
// operations (the plain version) that count takes a dozen launches and
// about 200 us of host time a call at Q = 512 on an H100's host, which
// lengthened a whole query call on an idle card from 1.57 to 1.84 ms;
// this kernel takes one memset and one launch.
//
// For the (n,) int32 block ids of a visit table and a pad block id (-1 for
// none) it writes, into an int64 workspace zeroed by the launch:
//     ws[0] pairs  = entries that are not the pad block
//     ws[1] blocks = distinct block ids among them
//     ws[2] sharing = pairs / max(1, blocks), a double, the division Python
//           makes of the same two integers
//     ws[3] blocks of the grid done (the last one writes ws[2])
//     ws[4..] a bit a block id, n_blocks bits
// The first thread whose atomicOr sets a block's bit counts the block, so
// each distinct id counts once; a plain read first skips the atomic for an
// id already seen (a bit only goes from 0 to 1 within a launch).
//
// What bounds it: reading the table once, 4n bytes (8.4 MB at Q = 512,
// T = 4,096: about 2.5 us at 3.35 TB/s), and the atomics of first visits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;
constexpr int kHead = 4;  // int64 slots ahead of the bits

__global__ void __launch_bounds__(kThreads)
visit_sharing_count(const int* __restrict__ visit, long long n, int pad_block,
                    unsigned long long* __restrict__ ws) {
  unsigned int* bits = reinterpret_cast<unsigned int*>(ws + kHead);
  unsigned long long pairs = 0, blocks = 0;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    const int b = visit[i];
    if (b == pad_block) continue;
    ++pairs;
    unsigned int* word = bits + (b >> 5);
    const unsigned int bit = 1u << (b & 31);
    if (!(*reinterpret_cast<volatile unsigned int*>(word) & bit) &&
        !(atomicOr(word, bit) & bit))
      ++blocks;
  }
  for (int off = 16; off > 0; off >>= 1) {
    pairs += __shfl_down_sync(0xffffffffu, pairs, off);
    blocks += __shfl_down_sync(0xffffffffu, blocks, off);
  }
  __shared__ unsigned long long warp_pairs[kThreads / 32];
  __shared__ unsigned long long warp_blocks[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    warp_pairs[warp] = pairs;
    warp_blocks[warp] = blocks;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  pairs = blocks = 0;
  for (int w = 0; w < kThreads / 32; ++w) {
    pairs += warp_pairs[w];
    blocks += warp_blocks[w];
  }
  atomicAdd(&ws[0], pairs);
  atomicAdd(&ws[1], blocks);
  __threadfence();
  if (atomicAdd(&ws[3], 1ull) != gridDim.x - 1) return;
  // the last block: every other block's sums are in
  __threadfence();
  const unsigned long long p = atomicAdd(&ws[0], 0ull);
  const unsigned long long d = atomicAdd(&ws[1], 0ull);
  reinterpret_cast<double*>(ws)[2] = (double)p / (double)(d > 1 ? d : 1);
}

}  // namespace

extern "C" {

// visit: (n,) int32 block ids in 0..n_blocks-1; pad_block: the id not
// counted, or -1; ws: (4 + ceil(n_blocks / 64)) int64 slots, zeroed here.
// Returns the CUDA error code of the memset and the launch.
int visit_sharing_launch(const void* visit, long long n, int n_blocks,
                         int pad_block, void* ws, void* stream) {
  if (n < 0 || n_blocks < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const size_t words = ((size_t)n_blocks + 63) / 64;
  cudaError_t err =
      cudaMemsetAsync(ws, 0, (kHead + words) * sizeof(unsigned long long), st);
  if (err != cudaSuccess) return (int)err;
  long long grid = (n + kThreads - 1) / kThreads;
  if (grid > kMaxBlocks) grid = kMaxBlocks;
  if (grid < 1) grid = 1;
  visit_sharing_count<<<(int)grid, kThreads, 0, st>>>(
      static_cast<const int*>(visit), n, pad_block,
      static_cast<unsigned long long*>(ws));
  return (int)cudaGetLastError();
}

const char* thistle_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
