// Fused exact distance + top-k for Hopper (sm_90a), float32 and bf16 corpora.
//
// Replaces the Pallas kernel src/repro/kernels/topk_distance.py
// (topk_distance, body _topk_kernel, selection _select_topk): corpus tiles
// stream past the queries, each tile's scores q.c (times 2 for l2) plus the
// row bias (-|c|^2 for l2, -1e30 for a knocked-out row) are folded into a
// running top-k, and only the (Q, k) result leaves the chip. The wrapper
// subtracts |q|^2 for l2, as the reference's wrapper does. Like the TPU
// kernel, which upcasts a bf16 tile in the kernel, a bf16 corpus (with bf16
// queries) is scored as exact products of the bf16 values summed in float32.
//
// What bounds it: reading the corpus once (N*d*4 or N*d*2 bytes) at small Q;
// the 2*Q*N*d products at large Q (about 100 queries and up for float32 at
// d = 768). The design:
//
// * Products on the tensor cores with mma.sync. A float32 corpus takes
//   3xTF32: each operand x splits into big (x rounded to TF32) and small
//   (the rest, truncated to TF32), and small*big + big*small + big*big are
//   accumulated in float32 (m16n8k8 TF32), which keeps float32 accuracy
//   (the dropped small*small and the truncation of small are below
//   2^-20 |a||b| a product). A bf16 corpus takes m16n8k16 bf16 -> float32;
//   its products are exact.
// * A block owns BQ = 16, 32, 64 or 128 query rows (sized to Q, so Q = 32
//   scores no padded rows) and a chunk of corpus rows, walked in tiles of
//   BN = 128 rows. Eight warps split the BQ x BN tile; each accumulates
//   MT x NT fragments of 16 x 8 scores over d.
// * The corpus streams once per query tile through a cp.async ring of
//   k-slabs (256 bytes of each of the tile's rows for BQ <= 32, 128 above;
//   16-byte cp.async.cg, commit/wait groups), 3 to 8 stages deep, so the
//   next slabs' copies are in flight during a slab's products. Rows past
//   the chunk and bytes past d are zero-filled by the copy.
// * The query tile is staged once per block (RES) unless riding in the
//   ring keeps a third more corpus slabs in flight; then its k-slab rides
//   in the ring beside the corpus slab (re-read from L2 per corpus tile). The launch
//   plan (topk_distance_config) picks BQ, the placement and the ring depth
//   from the shared memory and registers a block needs.
// * Slab rows are stored with the 16-byte chunks of odd rows XOR-swizzled
//   by 4, so the fragment loads (one 16-byte load gives a thread its
//   operands for two k-steps) hit 8 distinct bank groups a quarter warp.
//   The k order inside a chunk is permuted the same way for both operands,
//   which changes only the order of the float32 sum.
// * Top-k: a register threshold ahead of the boards. After a tile, each
//   score is compared with its row's current k-th best (score, key), kept
//   in shared memory beside the board; only a score that beats it is
//   appended to the row's candidate list (kCap slots), and the warp that
//   owns the row folds the list into its WarpBoard (topk_board.cuh). A
//   score that finds the list full waits in a per-thread bit mask for the
//   next round of the same tile. Steady state costs one compare a score
//   and one block barrier a tile.
//
// A chunk writes its raw boards out, and topk_distance_merge folds the
// chunks of each query into the sorted (Q, k) result. Ties: the lower row
// id first, as lax.top_k keeps the lower position first.
#include <cuda_bf16.h>

#include "topk_board.cuh"

using namespace thistle;

namespace {

constexpr int kThreads = 256;  // eight warps
constexpr int kWarps = kThreads / 32;
constexpr int BN = 128;        // corpus rows a tile
// Bytes of a row in one k-slab: 256 for query tiles of up to 32 rows
// (bandwidth-bound; longer runs of each row per visit), 128 above (the
// larger query slab has to fit the ring beside the corpus slab).
__host__ __device__ constexpr int slab_bytes(int bq) { return bq <= 32 ? 256 : 128; }
constexpr int kMaxStages = 8;  // deepest cp.async ring the plan picks
constexpr int kCap = 32;       // candidate slots a query row, per fold round

// Warp layout of a BQ x BN tile: WM x WN warps, each MT m16 tiles x NT n8
// tiles.
template <int BQ>
struct Shape {
  static constexpr int WM = BQ == 16 ? 1 : 2;
  static constexpr int WN = kWarps / WM;
  static constexpr int MT = BQ / 16 / WM;
  static constexpr int NT = BN / 8 / WN;
  static_assert(MT * NT * 4 <= 64, "pending bits fit a 64-bit mask");
};

size_t partial_smem(int bq, int res, int k, int n_slabs, int stages) {
  const size_t slab = slab_bytes(bq);
  const size_t stage = (size_t)BN * slab + (res ? 0 : (size_t)bq * slab);
  size_t s = stages * stage + (res ? (size_t)bq * n_slabs * slab : 0);
  s += (size_t)bq * k * 8 + (size_t)bq * kCap * 8 + (size_t)bq * 16;
  return s;
}

// 16-byte chunk c of row r lives at chunk c ^ 4 in odd rows (rows start on
// 128-byte boundaries, so this spreads a quarter warp's rows 2j, 2j + 1 over
// the 8 bank groups).
__device__ __forceinline__ int swz(int r, int c) { return c ^ ((r & 1) << 2); }

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
// Wait until at most n groups are in flight (n is 1..kMaxStages - 2).
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    default: cp_async_wait<6>(); break;
  }
}

__device__ __forceinline__ uint4 lds128(const unsigned char* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// x = big + small + e: big is x rounded to TF32's 10 fraction bits (half
// up in magnitude), small the TF32 truncation of the exact rest, so |e| <
// 2^-21 |x|. Bit operations: no cvt on the path.
__device__ __forceinline__ void split(uint32_t x, uint32_t& big, uint32_t& small) {
  big = (x + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(__uint_as_float(x) - __uint_as_float(big)) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One k-step of a warp's fragment products. A thread's 16-byte chunk of a
// row holds its operands for two k-steps: words 2s and 2s + 1 of step s.
// TF32: word 2s is k = t, word 2s + 1 is k = t + 4 of the m16n8k8 step;
// bf16: word 2s holds k = 2t, 2t + 1 and word 2s + 1 k = 2t + 8, 2t + 9 of
// the m16n8k16 step. The same map for A and B, so the sum is unchanged.
template <typename T, int MT, int NT>
__device__ __forceinline__ void kstep(float (&acc)[MT][NT][4], const uint4 (&a)[MT][2],
                                      const uint4 (&b)[NT], int s) {
  auto w = [](const uint4& v, int i) {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
  };
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma_bf16(acc[mt][nt], w(a[mt][0], 2 * s), w(a[mt][1], 2 * s), w(a[mt][0], 2 * s + 1),
                 w(a[mt][1], 2 * s + 1), w(b[nt], 2 * s), w(b[nt], 2 * s + 1));
  } else {
    uint32_t ab[MT][4], as[MT][4], bb[NT][2], bs[NT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      split(w(a[mt][0], 2 * s), ab[mt][0], as[mt][0]);
      split(w(a[mt][1], 2 * s), ab[mt][1], as[mt][1]);
      split(w(a[mt][0], 2 * s + 1), ab[mt][2], as[mt][2]);
      split(w(a[mt][1], 2 * s + 1), ab[mt][3], as[mt][3]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      split(w(b[nt], 2 * s), bb[nt][0], bs[nt][0]);
      split(w(b[nt], 2 * s + 1), bb[nt][1], bs[nt][1]);
    }
    // the small terms first; each pass runs MT * NT independent products
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma_tf32(acc[mt][nt], as[mt][0], as[mt][1], as[mt][2], as[mt][3], bb[nt][0], bb[nt][1]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma_tf32(acc[mt][nt], ab[mt][0], ab[mt][1], ab[mt][2], ab[mt][3], bs[nt][0], bs[nt][1]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma_tf32(acc[mt][nt], ab[mt][0], ab[mt][1], ab[mt][2], ab[mt][3], bb[nt][0], bb[nt][1]);
  }
}

template <typename T, int BQ, bool RES>
__global__ void __launch_bounds__(kThreads)
    topk_distance_partial(const T* __restrict__ corpus, const T* __restrict__ q,
                          const float* __restrict__ bias, int N, int Q, int d, int k, int l2,
                          int rows_per_chunk, int stages, float* __restrict__ part_s,
                          int* __restrict__ part_key) {
  using S = Shape<BQ>;
  constexpr int MT = S::MT, NT = S::NT;
  constexpr int kSlab = slab_bytes(BQ);
  constexpr int kChunks = kSlab / 16;  // 16-byte chunks of a slab row
  extern __shared__ __align__(16) unsigned char smem[];
  const int row_bytes = d * (int)sizeof(T);
  const int n_slabs = (row_bytes + kSlab - 1) / kSlab;
  const size_t stage_bytes = (size_t)BN * kSlab + (RES ? 0 : (size_t)BQ * kSlab);
  unsigned char* ring = smem;
  unsigned char* q_res = ring + stages * stage_bytes;  // [BQ][n_slabs * kSlab] (RES)
  float* board_s = reinterpret_cast<float*>(q_res + (RES ? (size_t)BQ * n_slabs * kSlab : 0));
  int* board_key = reinterpret_cast<int*>(board_s + (size_t)BQ * k);
  float* cand_s = reinterpret_cast<float*>(board_key + (size_t)BQ * k);
  int* cand_key = reinterpret_cast<int*>(cand_s + BQ * kCap);
  float* thr_s = reinterpret_cast<float*>(cand_key + BQ * kCap);  // worst on the board
  int* thr_key = reinterpret_cast<int*>(thr_s + BQ);
  int* thr_pos = thr_key + BQ;
  int* cnt = thr_pos + BQ;  // candidates appended this round

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = warp / S::WN;
  const int wn = warp % S::WN;
  const int q0 = blockIdx.x * BQ;
  const int chunk = blockIdx.y;
  const int n_chunks = gridDim.y;
  const long n_begin = (long)chunk * rows_per_chunk;
  const long n_end = min((long)N, n_begin + rows_per_chunk);
  const int n_tiles = n_end > n_begin ? (int)((n_end - n_begin + BN - 1) / BN) : 0;
  const int total = n_tiles * n_slabs;
  const unsigned char* cbytes = reinterpret_cast<const unsigned char*>(corpus);
  const unsigned char* qbytes = reinterpret_cast<const unsigned char*>(q);

  for (int r = warp; r < BQ; r += kWarps) {
    WarpBoard b;
    b.init(board_s + (size_t)r * k, board_key + (size_t)r * k, k);
    if (lane == 0) {
      thr_s[r] = b.ws;
      thr_key[r] = b.wk;
      thr_pos[r] = b.wpos;
      cnt[r] = 0;
    }
  }

  if constexpr (RES) {  // the whole query tile, once; it lands with the first slab
    const int per_row = n_slabs * kChunks;
    for (int e = tid; e < BQ * per_row; e += kThreads) {
      const int r = e / per_row, c = e - r * per_row;
      const int off = c * 16;
      const bool ok = q0 + r < Q && off < row_bytes;
      cp_async16(q_res + (size_t)r * n_slabs * kSlab + swz(r, c) * 16,
                 ok ? qbytes + (size_t)(q0 + r) * row_bytes + off : qbytes, ok);
    }
  }

  // copy k-slab i (tile i / n_slabs, slab i % n_slabs) into its ring stage
  auto load = [&](int i) {
    const int tile = i / n_slabs, slab = i - tile * n_slabs;
    unsigned char* st = ring + (size_t)(i % stages) * stage_bytes;
    const long n0 = n_begin + (long)tile * BN;
    for (int e = tid; e < BN * kChunks; e += kThreads) {
      const int r = e / kChunks, c = e % kChunks;
      const int off = slab * kSlab + c * 16;
      const bool ok = n0 + r < n_end && off < row_bytes;
      cp_async16(st + r * kSlab + swz(r, c) * 16,
                 ok ? cbytes + (size_t)(n0 + r) * row_bytes + off : cbytes, ok);
    }
    if constexpr (!RES) {
      unsigned char* qs = st + BN * kSlab;
      for (int e = tid; e < BQ * kChunks; e += kThreads) {
        const int r = e / kChunks, c = e % kChunks;
        const int off = slab * kSlab + c * 16;
        const bool ok = q0 + r < Q && off < row_bytes;
        cp_async16(qs + r * kSlab + swz(r, c) * 16,
                   ok ? qbytes + (size_t)(q0 + r) * row_bytes + off : qbytes, ok);
      }
    }
  };

  for (int i = 0; i < stages - 1; ++i) {
    if (i < total) load(i);
    cp_async_commit();
  }

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
  float bv[NT][2];

  for (int i = 0; i < total; ++i) {
    cp_async_wait_n(stages - 2);
    __syncthreads();  // slab i landed for every thread; slab i - 1 is read
    if (i + stages - 1 < total) load(i + stages - 1);
    cp_async_commit();

    const int tile = i / n_slabs, slab = i - tile * n_slabs;
    const long n0 = n_begin + (long)tile * BN;
    if (slab == 0) {  // the tile's row bias, used at its end
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const long n = n0 + (wn * NT + nt) * 8 + 2 * t + e;
          bv[nt][e] = n < n_end ? __ldg(bias + n) : 0.f;
        }
    }

    const unsigned char* cs = ring + (size_t)(i % stages) * stage_bytes;
    const unsigned char* qs = RES ? q_res + (size_t)slab * kSlab : cs + BN * kSlab;
    const size_t q_pitch = RES ? (size_t)n_slabs * kSlab : kSlab;
#pragma unroll
    for (int kg = 0; kg < kChunks / 4; ++kg) {
      const int c = kg * 4 + t;
      uint4 a[MT][2], b[NT];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = (wm * MT + mt) * 16 + g + 8 * h;
          a[mt][h] = lds128(qs + r * q_pitch + swz(r, c) * 16);
        }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int r = (wn * NT + nt) * 8 + g;
        b[nt] = lds128(cs + r * kSlab + swz(r, c) * 16);
      }
      kstep<T, MT, NT>(acc, a, b, 0);
      kstep<T, MT, NT>(acc, a, b, 1);
    }

    if (slab != n_slabs - 1) continue;

    // ---- end of a tile: scores, the threshold test, the boards
    float ts[MT][2];
    int tk[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = (wm * MT + mt) * 16 + g + 8 * h;
        ts[mt][h] = thr_s[r];
        tk[mt][h] = thr_key[r];
      }
    uint64_t pend = 0;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int r = (wm * MT + mt) * 16 + g + 8 * h;
          const long n = n0 + (wn * NT + nt) * 8 + 2 * t + (e & 1);
          const float dot = l2 ? 2.f * acc[mt][nt][e] : acc[mt][nt][e];
          const float sc = __fadd_rn(dot, bv[nt][e & 1]);
          acc[mt][nt][e] = sc;
          if (n < n_end && q0 + r < Q && better(sc, (int)n, ts[mt][h], tk[mt][h]))
            pend |= 1ull << ((mt * NT + nt) * 4 + e);
        }
    while (true) {
      bool appended = false;
      if (pend) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const uint64_t bit = 1ull << ((mt * NT + nt) * 4 + e);
              if (!(pend & bit)) continue;
              const int r = (wm * MT + mt) * 16 + g + 8 * (e >> 1);
              const int n = (int)(n0 + (wn * NT + nt) * 8 + 2 * t + (e & 1));
              const float sc = acc[mt][nt][e];
              if (!better(sc, n, thr_s[r], thr_key[r])) {
                pend &= ~bit;  // the board moved past it
                continue;
              }
              const int pos = atomicAdd(cnt + r, 1);
              if (pos < kCap) {
                cand_s[r * kCap + pos] = sc;
                cand_key[r * kCap + pos] = n;
                pend &= ~bit;
                appended = true;
              }
            }
      }
      if (!__syncthreads_or(appended)) break;
      for (int r = warp; r < BQ; r += kWarps) {
        const int c = min(cnt[r], kCap);
        if (c == 0) continue;  // warp-uniform
        WarpBoard b;
        b.s = board_s + (size_t)r * k;
        b.key = board_key + (size_t)r * k;
        b.k = k;
        b.ws = thr_s[r];
        b.wk = thr_key[r];
        b.wpos = thr_pos[r];
        const bool in = lane < c;
        b.fold_lanes(in ? cand_s[r * kCap + lane] : -INFINITY,
                     in ? cand_key[r * kCap + lane] : kEmptyKey, in);
        __syncwarp();
        if (lane == 0) {
          thr_s[r] = b.ws;
          thr_key[r] = b.wk;
          thr_pos[r] = b.wpos;
          cnt[r] = 0;
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
  }
  cp_async_wait<0>();

  for (int r = warp; r < BQ; r += kWarps) {
    if (q0 + r >= Q) continue;  // warp-uniform
    WarpBoard b;
    b.s = board_s + (size_t)r * k;
    b.key = board_key + (size_t)r * k;
    b.k = k;
    const long off = ((long)(q0 + r) * n_chunks + chunk) * k;
    b.write_raw(part_s + off, part_key + off);
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
  const int qi = blockIdx.x * kWarps + warp;
  if (qi >= Q) return;  // warp-uniform
  float* bs = reinterpret_cast<float*>(smem) + warp * k;
  int* bk = reinterpret_cast<int*>(reinterpret_cast<float*>(smem) + kWarps * k) + warp * k;
  WarpBoard board;
  board.init(bs, bk, k);
  const long total = (long)n_chunks * k;
  fold_parts(board, part_s + qi * total, part_key + qi * total, total);
  board.write_sorted(out_s + (long)qi * k, out_i + (long)qi * k, RowId());
}

// The partial kernel for (corpus type, BQ, RES), its dynamic shared memory
// limit raised to smem bytes.
template <typename T, int BQ, bool RES>
const void* partial_fn(size_t smem, cudaError_t* err) {
  *err = cudaFuncSetAttribute(topk_distance_partial<T, BQ, RES>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return reinterpret_cast<const void*>(topk_distance_partial<T, BQ, RES>);
}

template <typename T>
const void* partial_fn(int bq, int res, size_t smem, cudaError_t* err) {
  switch (bq * 2 + (res ? 1 : 0)) {
    case 32: return partial_fn<T, 16, false>(smem, err);
    case 33: return partial_fn<T, 16, true>(smem, err);
    case 64: return partial_fn<T, 32, false>(smem, err);
    case 65: return partial_fn<T, 32, true>(smem, err);
    case 128: return partial_fn<T, 64, false>(smem, err);
    case 129: return partial_fn<T, 64, true>(smem, err);
    case 256: return partial_fn<T, 128, false>(smem, err);
    case 257: return partial_fn<T, 128, true>(smem, err);
  }
  *err = cudaErrorInvalidValue;
  return nullptr;
}

const void* partial_fn(int bf16, int bq, int res, size_t smem, cudaError_t* err) {
  return bf16 ? partial_fn<__nv_bfloat16>(bq, res, smem, err)
              : partial_fn<float>(bq, res, smem, err);
}

int n_slabs_of(int d, int bf16, int bq) {
  return (d * (bf16 ? 2 : 4) + slab_bytes(bq) - 1) / slab_bytes(bq);
}

}  // namespace

extern "C" {

// The launch plan for (N, Q, d, k) and the corpus type. cfg receives {BQ,
// resident (1: the query tile stays in shared memory), ring stages,
// n_chunks, rows_per_chunk, shared memory bytes of a block, blocks an SM}.
// BQ is the smallest of 16, 32, 64, 128 that holds Q (128 above), halved
// only when no block of it fits. For that BQ the plan takes the query
// placement and ring depth (3..8) that keep the most corpus slabs in flight
// on an SM (blocks an SM x (stages - 1), a resident query tile's counted
// 4/3); `resident` -1 lets it choose, 0 or 1 forces the placement. The
// chunks give every SM the blocks it holds for each query tile, so one wave
// covers the corpus. Returns a CUDA error code.
int topk_distance_config(int N, int Q, int d, int k, int bf16, int resident, int* cfg) {
  if (k < 1 || k > kMaxK || N < 1 || Q < 1 || d < 8 || d % 8 != 0 || resident < -1 ||
      resident > 1)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  int best[4] = {0, 0, 0, 0};  // bq, res, stages, blocks an SM
  size_t best_smem = 0;
  for (int bq = Q <= 16 ? 16 : Q <= 32 ? 32 : Q <= 64 ? 64 : 128; bq >= 16 && !best[0];
       bq /= 2) {
    int best_flight = 0;
    for (int res = 1; res >= 0; --res) {
      if (resident != -1 && res != resident) continue;
      for (int stages = kMaxStages; stages >= 3; --stages) {
        const size_t smem = partial_smem(bq, res, k, n_slabs_of(d, bf16, bq), stages);
        if (smem > (size_t)max_smem) continue;
        const void* fn = partial_fn(bf16, bq, res, smem, &err);
        if (err != cudaSuccess) return (int)err;
        int per_sm = 0;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, smem);
        if (err != cudaSuccess) return (int)err;
        // corpus slabs in flight on an SM; a resident query tile saves its
        // slab's copy and L2 read each step, and counts 4/3 for that
        const int flight = per_sm * (stages - 1) * (res ? 4 : 3);
        if (flight > best_flight) {
          best_flight = flight;
          best[0] = bq;
          best[1] = res;
          best[2] = stages;
          best[3] = per_sm;
          best_smem = smem;
        }
      }
    }
  }
  if (!best[0]) return (int)cudaErrorInvalidConfiguration;
  const int q_tiles = (Q + best[0] - 1) / best[0];
  const long n_tiles = ((long)N + BN - 1) / BN;
  long n_chunks = (long)sms * best[3] / q_tiles;
  if (n_chunks > n_tiles) n_chunks = n_tiles;
  if (n_chunks > 65535) n_chunks = 65535;
  if (n_chunks < 1) n_chunks = 1;
  const long rows_per_chunk = BN * ((n_tiles + n_chunks - 1) / n_chunks);
  n_chunks = ((long)N + rows_per_chunk - 1) / rows_per_chunk;
  cfg[0] = best[0];
  cfg[1] = best[1];
  cfg[2] = best[2];
  cfg[3] = (int)n_chunks;
  cfg[4] = (int)rows_per_chunk;
  cfg[5] = (int)best_smem;
  cfg[6] = best[3];
  return (int)cudaSuccess;
}

// corpus (N, d) and q (Q, d) both float32 (bf16 = 0) or both bf16, bias (N,)
// float32, 16-byte aligned; part_* (Q, n_chunks, k) scratch; out_s (Q, k)
// float32 and out_i (Q, k) int32. bq, res, stages, n_chunks and
// rows_per_chunk as topk_distance_config gave them. Returns the CUDA error
// code of the launches.
int topk_distance_launch(const void* corpus, const void* q, const void* bias, int N, int Q,
                         int d, int k, int l2, int bf16, int bq, int res, int stages,
                         int n_chunks, int rows_per_chunk, void* part_s, void* part_key,
                         void* out_s, void* out_i, void* stream) {
  if (k < 1 || k > kMaxK || d < 8 || d % 8 != 0 || n_chunks < 1 || n_chunks > 65535 ||
      stages < 3 || stages > kMaxStages)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const size_t smem = partial_smem(bq, res, k, n_slabs_of(d, bf16, bq), stages);
  cudaError_t err = cudaSuccess;
  const void* fn = partial_fn(bf16, bq, res, smem, &err);
  if (err != cudaSuccess) return (int)err;
  const auto* b = static_cast<const float*>(bias);
  auto* ps = static_cast<float*>(part_s);
  auto* pk = static_cast<int*>(part_key);
  void* args[] = {const_cast<void**>(&corpus), const_cast<void**>(&q), &b, &N, &Q, &d, &k,
                  &l2, &rows_per_chunk, &stages, &ps, &pk};
  const dim3 grid((Q + bq - 1) / bq, n_chunks);
  err = cudaLaunchKernel(fn, grid, dim3(kThreads), args, smem, st);
  if (err != cudaSuccess) return (int)err;
  const size_t msmem = (sizeof(float) + sizeof(int)) * kWarps * (size_t)k;
  topk_distance_merge<<<(Q + kWarps - 1) / kWarps, kThreads, msmem, st>>>(
      ps, pk, Q, n_chunks, k, static_cast<float*>(out_s), static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}

const char* thistle_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
