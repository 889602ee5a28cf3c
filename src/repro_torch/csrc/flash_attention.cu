// Flash attention with a key-padding mask for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py
// (flash_attention, body _flash_kernel) with its wrapper
// src/repro/kernels/ops.py flash_attention, and computes what the
// reference's attention core src/repro/models/attention.py
// (_dense_attention, _chunked_attention) computes for the encoder:
//
//   o[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, h / rep] * scale) v[b, j, h / rep]
//
// over q (B, Sq, H, dh) and k, v (B, Sk, KV, dh), rep = H / KV (GQA by
// indexing, no repeated copy), with a score set to -1e30 (the reference's
// NEG_INF, not -inf) where kv_mask[b, j] is false or, causal, where j > i.
// A fully masked row therefore averages v over all Sk keys, as the
// reference's softmax of equal scores does, and never gives NaN. Keys past
// Sk (the ragged last tile) take no part at all.
//
// The (Sq, Sk) scores never reach device memory: a block owns the query
// rows of one (b, h), walks the keys in tiles of 64 staged in shared memory,
// and keeps the online softmax's running max, denominator and output
// accumulator in float32 registers (the TPU kernel's VMEM scratch). Under
// causal the tiles strictly above the diagonal are skipped, as the TPU
// kernel skips them; only when a row of the block has seen no unmasked key
// by then (possible with kv_mask) does the block walk the rest, so that row
// still averages over all Sk keys.
//
// bf16: warps of 16 rows (4 a block below Sq = 128, 8 from there); q.k^T
// and p.v on mma.sync.m16n8k16 (bf16 in, float32 accumulate). The K/V
// tiles stream through a two-stage cp.async ring, tile j + 1's copy issued
// before tile j's products; Q and K fragments come from ldmatrix.x4, V's
// from ldmatrix.x4.trans, and the Q fragments sit in registers for the
// whole key loop (dh <= 128). Scores are scaled by scale * log2 e and
// exponentiated with ex2.approx. p is rounded to bf16 before p.v, as the
// reference rounds it (attention.py:88 and :138), and the denominator sums
// the unrounded p. float32: 256 threads, four a row, float32 FMA, one
// staged tile at a time.
//
// What bounds it: at the encoder's seq_len 64 reading q, k, v and writing o
// (2 bytes an element) against 4*B*H*S^2*dh bf16 operations: about 60 us of
// bytes against 3 us of tensor-core work for B = 512, H = 12, dh = 64, so
// bytes; near the ridge at S = 512, where the products and the K/V
// restaging from L2 (once per 128 query rows) are what the ring overlaps.
// No TMA, wgmma or warp specialisation yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
constexpr int kTile = 64;          // keys of a tile; query rows of a float32 block
constexpr int kThreadsF32 = 256;   // four threads a query row
constexpr float kLog2e = 1.4426950408889634f;

// Warps of a bf16 block, 16 query rows each: 8 from Sq = 128 on, so that a
// staged K/V tile serves 128 rows, else 4.
__host__ __device__ constexpr int bf16_warps(int Sq) { return Sq >= 128 ? 8 : 4; }

// key states staged beside each K/V tile
constexpr unsigned char kPast = 0;    // j >= Sk: no part in the softmax
constexpr unsigned char kMasked = 1;  // kv_mask false: score NEG_INF
constexpr unsigned char kLive = 2;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Copy rows [s0, s0 + 64) of head `head` of x (batch b; S rows of `heads`
// heads of dh elements, T a 2- or 4-byte type) into dst with a row stride
// of ld elements; rows past S are zero. 16-byte loads: dh * sizeof(T) is a
// multiple of 32 and the wrapper aligns the base to 16 bytes.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const T* __restrict__ x, int b, int s0,
                                           int S, int heads, int head, int dh, int tid,
                                           int n_threads) {
  constexpr int kPer = 16 / sizeof(T);
  const int chunks = dh / kPer;
  for (int c = tid; c < kTile * chunks; c += n_threads) {
    const int r = c / chunks;
    const int col = (c - r * chunks) * kPer;
    uint4 val = make_uint4(0, 0, 0, 0);
    const int s = s0 + r;
    if (s < S) {
      const size_t off = (((size_t)b * S + s) * heads + head) * dh + col;
      val = *reinterpret_cast<const uint4*>(x + off);
    }
    *reinterpret_cast<uint4*>(dst + (size_t)r * ld + col) = val;
  }
}

__device__ __forceinline__ void stage_key_states(unsigned char* state,
                                                 const unsigned char* __restrict__ kv_mask, int b,
                                                 int k0, int Sk, int tid) {
  if (tid < kTile) {
    const int j = k0 + tid;
    unsigned char st = kPast;
    if (j < Sk) st = (kv_mask == nullptr || kv_mask[(size_t)b * Sk + j]) ? kLive : kMasked;
    state[tid] = st;
  }
}

// The score of (row i, key j) after masking, from the raw dot.
__device__ __forceinline__ float masked_score(float dot, float scale, unsigned char st, int i,
                                              int j, int causal) {
  if (st == kPast) return -INFINITY;
  if (st == kMasked || (causal && j > i)) return kNegInf;
  return dot * scale;
}

// ----------------------------------------------------------------- bf16

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

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8. .trans hands each thread a column pair.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// Start the copy of `rows` rows from s0 of head `head` of x (batch b; S rows
// of `heads` heads of dh bf16) into dst (row stride ld); rows past S are
// zero-filled. 16-byte cp.async: dh is a multiple of 16 and the wrapper
// aligns the base to 16 bytes. inv_chunks = 1 / (dh / 8): the row of
// 16-byte chunk c is c * inv_chunks rounded down, exact for c < 2^12.
__device__ __forceinline__ void copy_rows_async(__nv_bfloat16* dst, int ld,
                                                const __nv_bfloat16* __restrict__ x, int b,
                                                int s0, int rows, int S, int heads, int head,
                                                int dh, float inv_chunks, int tid,
                                                int n_threads) {
  const int chunks = dh / 8;
  for (int c = tid; c < rows * chunks; c += n_threads) {
    const int r = (int)(((float)c + 0.5f) * inv_chunks);
    const int col = (c - r * chunks) * 8;
    const int s = s0 + r;
    const bool ok = s < S;
    cp_async16(dst + (size_t)r * ld + col,
               ok ? x + (((size_t)b * S + s) * heads + head) * dh + col : x, ok);
  }
}

// The additive bias of key j of batch b on a score in log2 units: 0 for a
// live key, NEG_INF (-1e30, which absorbs any finite score) for a padded
// one, -inf past Sk.
__device__ __forceinline__ float key_bias(const unsigned char* __restrict__ kv_mask, int b, int j,
                                          int Sk) {
  if (j >= Sk) return -INFINITY;
  return (kv_mask == nullptr || kv_mask[(size_t)b * Sk + j]) ? 0.f : kNegInf;
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// NW warps of 16 query rows (see bf16_warps). K/V tiles of 64 keys stream
// through a two-stage cp.async ring: after the barrier that shows tile j
// landed (and tile j - 1 read), tile j + 1's copy, and its key biases
// through registers, is issued before tile j's products; one barrier a
// tile. Each thread finds its share of a tile's 16-byte chunks once.
// Fragments come from ldmatrix (x4 for Q and K, x4.trans for V); the Q
// fragments are loaded into registers once, before the key loop, at
// dh <= 128. Every k-step over DHMAX runs (columns past dh are zeros), and
// the causal mask is compiled only into the CAUSAL kernels. A score is one
// FMA, dot * scale * log2 e plus its key's bias; exp2 of the shifted score
// is one ex2.approx; the accumulator is rescaled only when a row max
// moved.
template <int DHMAX, int NW, bool CAUSAL>
__global__ void __launch_bounds__(NW * 32)
    flash_attention_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const unsigned char* __restrict__ kv_mask, __nv_bfloat16* __restrict__ out,
                         int Sq, int Sk, int H, int KV, int dh, float scale_log2) {
  constexpr int NT = DHMAX / 8;  // 8-column tiles of the output
  constexpr int KC = DHMAX / 16;  // 16-wide k-steps over dh
  constexpr int BQ = 16 * NW;
  constexpr int kThreads = NW * 32;
  constexpr int STAGES = 2;  // tile j + 1 copies while tile j is scored
  constexpr bool kQInRegs = DHMAX <= 128;
  extern __shared__ __align__(16) unsigned char smem[];
  // Rows of DHMAX + 8 elements (16 bytes of pad); columns dh..DHMAX - 1
  // hold zeros, so every k-step over DHMAX runs unconditionally and the
  // zero columns add nothing.
  constexpr int ld = DHMAX + 8;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [BQ][ld]
  __nv_bfloat16* Ks = Qs + BQ * ld;                             // [STAGES][kTile][ld]
  __nv_bfloat16* Vs = Ks + STAGES * kTile * ld;                 // [STAGES][kTile][ld]
  float* kbias = reinterpret_cast<float*>(Vs + STAGES * kTile * ld);  // [STAGES][kTile]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // row within the fragment
  const int t = lane & 3;   // column pair within the fragment
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int row0 = q0 + warp * 16 + g;  // this thread's two rows
  const int row1 = row0 + 8;
  const int n_tiles = (Sk + kTile - 1) / kTile;
  const float inv_chunks = 8.f / dh;

  // This thread's 16-byte chunks of a K (and V) tile, found once: chunk i
  // is (row, column) = (cp[i] >> 16, cp[i] & 0xffff); rows >= kTile mark
  // none. Copying tile j into stage j % STAGES is then an add, a compare
  // and a cp.async a chunk; keys past Sk are zero-filled.
  constexpr int kCopies = (kTile * (DHMAX / 8) + kThreads - 1) / kThreads;
  int cp[kCopies];
#pragma unroll
  for (int i = 0; i < kCopies; ++i) {
    const int c = tid + i * kThreads;
    const int r = (int)(((float)c + 0.5f) * inv_chunks);
    cp[i] = r < kTile ? (r << 16) | ((c - r * (dh / 8)) * 8) : kTile << 16;
  }
  const size_t kv_base = (size_t)b * Sk * KV * dh + (size_t)kvh * dh;  // (b, 0, kvh, 0)
  const size_t kv_row = (size_t)KV * dh;
  auto copy_tile = [&](int j) {
    __nv_bfloat16* kd = Ks + (j % STAGES) * kTile * ld;
    __nv_bfloat16* vd = Vs + (j % STAGES) * kTile * ld;
#pragma unroll
    for (int i = 0; i < kCopies; ++i) {
      const int r = cp[i] >> 16, col = cp[i] & 0xffff;
      if (r < kTile) {
        const int s = j * kTile + r;
        const bool ok = s < Sk;
        const size_t off = ok ? kv_base + (size_t)s * kv_row + col : 0;
        cp_async16(kd + r * ld + col, k + off, ok);
        cp_async16(vd + r * ld + col, v + off, ok);
      }
    }
  };

  if (dh < DHMAX) {  // zero columns dh.. of every Q, K and V row
    const int tail = (DHMAX - dh) / 8;
    for (int c = tid; c < (BQ + 2 * STAGES * kTile) * tail; c += kThreads) {
      const int r = c / tail;
      *reinterpret_cast<uint4*>(Qs + (size_t)r * ld + dh + (c - r * tail) * 8) =
          make_uint4(0, 0, 0, 0);
    }
  }
  copy_rows_async(Qs, ld, q, b, q0, BQ, Sq, H, h, dh, inv_chunks, tid, kThreads);
  cp_async_commit();
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < n_tiles) {
      copy_tile(j);
      if (tid < kTile) kbias[j * kTile + tid] = key_bias(kv_mask, b, j * kTile + tid, Sk);
    }
    cp_async_commit();
  }

  // ldmatrix addresses: A (Q) rows lane % 16, k half lane / 16; B (K) key
  // rows lane % 8 + 8 (lane / 16), k half (lane / 8) % 2; B (V, trans) key
  // rows lane % 8 + 8 ((lane / 8) % 2), column half lane / 16
  const int a_off = (warp * 16 + (lane & 15)) * ld + (lane >> 4) * 8;
  const int k_off = ((lane & 7) + ((lane >> 4) << 3)) * ld + ((lane >> 3) & 1) * 8;
  const int v_off = ((lane & 7) + (((lane >> 3) & 1) << 3)) * ld + (lane >> 4) * 8;

  uint32_t qf[kQInRegs ? KC : 1][4];
  if constexpr (kQInRegs) {
    cp_async_wait<STAGES - 1>();  // the query rows
    __syncthreads();
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
      ldsm_x4(qf[kc], Qs + a_off + kc * 16);
  }

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // l: this thread's part

  const int q_last = min(q0 + BQ, Sq) - 1;
  const int skip_from = CAUSAL ? min(n_tiles, q_last / kTile + 1) : n_tiles;
  for (int jt = 0; jt < n_tiles; ++jt) {
    if (jt == skip_from) {
      // past the diagonal: go on only for a row that has seen no unmasked key
      const int empty = (row0 < Sq && m0 == kNegInf) || (row1 < Sq && m1 == kNegInf);
      if (!__syncthreads_or(empty)) break;
    }
    const int k0 = jt * kTile;
    cp_async_wait<STAGES - 2>();  // tile jt has landed
    __syncthreads();              // for every thread; tile jt - 1 is read
    const int nx = jt + STAGES - 1;
    float next_bias = -INFINITY;
    if (nx < n_tiles) {
      copy_tile(nx);
      if (tid < kTile) next_bias = key_bias(kv_mask, b, nx * kTile + tid, Sk);
    }
    cp_async_commit();
    const __nv_bfloat16* Kb = Ks + (jt % STAGES) * kTile * ld;
    const __nv_bfloat16* Vb = Vs + (jt % STAGES) * kTile * ld;
    const float* kb = kbias + (jt % STAGES) * kTile;

    // scores of the warp's 16 rows against the 64 keys: 8 tiles of 16 x 8
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      {
        uint32_t a[4];
        if constexpr (kQInRegs) {
          a[0] = qf[kc][0];
          a[1] = qf[kc][1];
          a[2] = qf[kc][2];
          a[3] = qf[kc][3];
        } else {
          ldsm_x4(a, Qs + a_off + kc * 16);
        }
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bk[4];
          ldsm_x4(bk, Kb + k_off + np * 16 * ld + kc * 16);
          mma_bf16(s[2 * np], a[0], a[1], a[2], a[3], bk[0], bk[1]);
          mma_bf16(s[2 * np + 1], a[0], a[1], a[2], a[3], bk[2], bk[3]);
        }
      }
    }

    // masked scores in log2 units; under causal, keys past a row (but
    // before Sk) take NEG_INF, in the tiles that reach past the warp's
    // first row
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 bias = *reinterpret_cast<const float2*>(kb + n * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float kbe = e ? bias.y : bias.x;
        s[n][e] = fmaf(s[n][e], scale_log2, kbe);
        s[n][2 + e] = fmaf(s[n][2 + e], scale_log2, kbe);
        if (CAUSAL && k0 + kTile - 1 > q0 + warp * 16 && kbe != -INFINITY) {
          const int j = k0 + n * 8 + 2 * t + e;
          if (j > row0) s[n][e] = kNegInf;
          if (j > row1) s[n][2 + e] = kNegInf;
        }
        mx0 = fmaxf(mx0, s[n][e]);
        mx1 = fmaxf(mx1, s[n][2 + e]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = exp2_approx(m0 - mn0), c1 = exp2_approx(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[n][e] = exp2_approx(s[n][e] - mn0);
        s[n][2 + e] = exp2_approx(s[n][2 + e] - mn1);
        ps0 += s[n][e];
        ps1 += s[n][2 + e];
      }
    }
    l0 = l0 * c0 + ps0;
    l1 = l1 * c1 + ps1;
    if (!__all_sync(0xffffffffu, c0 == 1.f && c1 == 1.f)) {  // a row max moved
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[n][0] *= c0;
        o[n][1] *= c0;
        o[n][2] *= c1;
        o[n][3] *= c1;
      }
    }

    // o += p v: p (bf16) is the A operand straight from the score tiles
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t a1 = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t a2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < KC; ++dp) {
        {
          uint32_t bv[4];
          ldsm_x4_trans(bv, Vb + v_off + kk * 16 * ld + dp * 16);
          mma_bf16(o[2 * dp], a0, a1, a2, a3, bv[0], bv[1]);
          mma_bf16(o[2 * dp + 1], a0, a1, a2, a3, bv[2], bv[3]);
        }
      }
    }
    if (nx < n_tiles && tid < kTile) kbias[(nx % STAGES) * kTile + tid] = next_bias;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  l0 = fmaxf(l0, 1e-30f);
  l1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (n * 8 < dh) {
      const int col = n * 8 + 2 * t;
      if (row0 < Sq)
        *reinterpret_cast<uint32_t*>(out + (((size_t)b * Sq + row0) * H + h) * dh + col) =
            pack_bf16(o[n][0] / l0, o[n][1] / l0);
      if (row1 < Sq)
        *reinterpret_cast<uint32_t*>(out + (((size_t)b * Sq + row1) * H + h) * dh + col) =
            pack_bf16(o[n][2] / l1, o[n][3] / l1);
    }
  }
}

// ---------------------------------------------------------------- float32

template <int DHMAX>
__global__ void __launch_bounds__(kThreadsF32)
    flash_attention_f32(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const unsigned char* __restrict__ kv_mask,
                        float* __restrict__ out, int Sq, int Sk, int H, int KV, int dh, int causal,
                        float scale) {
  constexpr int NC = DHMAX / 16;  // float4 chunks a thread holds
  constexpr int kSub = 16;        // keys scored between two rescales
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + kTile * dh;
  unsigned char* state = reinterpret_cast<unsigned char*>(Vs + kTile * dh);

  const int tid = threadIdx.x;
  const int r = tid >> 2;    // query row within the block
  const int part = tid & 3;  // this thread holds float4 chunks part, part + 4, ...
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int row = q0 + r;
  const int nc = dh / 16;

  float4 qv[NC], o[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    qv[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    o[c] = qv[c];
    if (c < nc && row < Sq)
      qv[c] = *reinterpret_cast<const float4*>(q + (((size_t)b * Sq + row) * H + h) * dh +
                                               4 * (part + 4 * c));
  }
  float m = kNegInf, l = 0.f;

  const int n_tiles = (Sk + kTile - 1) / kTile;
  const int q_last = min(q0 + kTile, Sq) - 1;
  const int skip_from = causal ? min(n_tiles, q_last / kTile + 1) : n_tiles;
  for (int jt = 0; jt < n_tiles; ++jt) {
    if (jt == skip_from) {
      if (!__syncthreads_or(row < Sq && m == kNegInf)) break;
    }
    const int k0 = jt * kTile;
    __syncthreads();
    stage_rows(Ks, dh, k, b, k0, Sk, KV, kvh, dh, tid, kThreadsF32);
    stage_rows(Vs, dh, v, b, k0, Sk, KV, kvh, dh, tid, kThreadsF32);
    stage_key_states(state, kv_mask, b, k0, Sk, tid);
    __syncthreads();

    for (int j0 = 0; j0 < kTile; j0 += kSub) {
      float s[kSub];
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < kSub; ++u) {
        const float* kr = Ks + (j0 + u) * dh;
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          if (c < nc) {
            const float4 kx = *reinterpret_cast<const float4*>(kr + 4 * (part + 4 * c));
            dot = fmaf(qv[c].x, kx.x, dot);
            dot = fmaf(qv[c].y, kx.y, dot);
            dot = fmaf(qv[c].z, kx.z, dot);
            dot = fmaf(qv[c].w, kx.w, dot);
          }
        }
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        s[u] = masked_score(dot, scale, state[j0 + u], row, k0 + j0 + u, causal);
        mx = fmaxf(mx, s[u]);
      }
      const float mn = fmaxf(m, mx);
      const float corr = expf(m - mn);
      m = mn;
      float ps = 0.f;
#pragma unroll
      for (int u = 0; u < kSub; ++u) {
        s[u] = expf(s[u] - mn);
        ps += s[u];
      }
      l = l * corr + ps;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (c < nc) {
          float4 acc = o[c];
          acc.x *= corr;
          acc.y *= corr;
          acc.z *= corr;
          acc.w *= corr;
#pragma unroll
          for (int u = 0; u < kSub; ++u) {
            const float4 vx =
                *reinterpret_cast<const float4*>(Vs + (j0 + u) * dh + 4 * (part + 4 * c));
            acc.x = fmaf(s[u], vx.x, acc.x);
            acc.y = fmaf(s[u], vx.y, acc.y);
            acc.z = fmaf(s[u], vx.z, acc.z);
            acc.w = fmaf(s[u], vx.w, acc.w);
          }
          o[c] = acc;
        }
      }
    }
  }

  if (row < Sq) {
    l = fmaxf(l, 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (c < nc)
        *reinterpret_cast<float4*>(out + (((size_t)b * Sq + row) * H + h) * dh +
                                   4 * (part + 4 * c)) =
            make_float4(o[c].x / l, o[c].y / l, o[c].z / l, o[c].w / l);
    }
  }
}

// Raise the kernel's dynamic shared memory limit to smem, then launch.
template <typename... P, typename... A>
int launch(void (*kernel)(P...), dim3 grid, int threads, size_t smem, cudaStream_t st,
           A... args) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory a launch takes, in bytes: bf16 stages the block's query
// rows and two K/V tiles; float32 one K/V tile.
size_t flash_attention_smem(int dh, int Sq, int bf16) {
  if (!bf16) return 2 * (size_t)kTile * dh * 4 + kTile;
  const int dh_max = dh <= 64 ? 64 : dh <= 128 ? 128 : 256;
  return ((size_t)16 * bf16_warps(Sq) + 4 * kTile) * (dh_max + 8) * 2 +
         2 * kTile * sizeof(float);
}

// q (B, Sq, H, dh), k and v (B, Sk, KV, dh), all bf16 (bf16 = 1) or all
// float32, contiguous and 16-byte aligned; kv_mask (B, Sk) bytes (0 =
// padding) or null; out (B, Sq, H, dh) in q's type. dh a multiple of 16 up
// to 256, H a multiple of KV, B and H at most 65535. Returns the CUDA error
// code of the launch.
int flash_attention_launch(const void* q, const void* k, const void* v, const void* kv_mask,
                           void* out, int B, int Sq, int Sk, int H, int KV, int dh, int causal,
                           float scale, int bf16, void* stream) {
  if (dh < 16 || dh > 256 || dh % 16 != 0 || KV < 1 || H % KV != 0 || B < 1 || B > 65535 ||
      H > 65535 || Sq < 1 || Sk < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const size_t smem = flash_attention_smem(dh, Sq, bf16);
  const auto* mask = static_cast<const unsigned char*>(kv_mask);
  if (bf16) {
    const int nw = bf16_warps(Sq);
    const dim3 grid((Sq + 16 * nw - 1) / (16 * nw), H, B);
    using Kernel = void (*)(const __nv_bfloat16*, const __nv_bfloat16*, const __nv_bfloat16*,
                            const unsigned char*, __nv_bfloat16*, int, int, int, int, int, float);
    // [causal][warps 8][dh 64 / 128 / 256]
    static const Kernel kernels[2][2][3] = {
        {{flash_attention_bf16<64, 4, false>, flash_attention_bf16<128, 4, false>,
          flash_attention_bf16<256, 4, false>},
         {flash_attention_bf16<64, 8, false>, flash_attention_bf16<128, 8, false>,
          flash_attention_bf16<256, 8, false>}},
        {{flash_attention_bf16<64, 4, true>, flash_attention_bf16<128, 4, true>,
          flash_attention_bf16<256, 4, true>},
         {flash_attention_bf16<64, 8, true>, flash_attention_bf16<128, 8, true>,
          flash_attention_bf16<256, 8, true>}}};
    const Kernel kernel = kernels[causal ? 1 : 0][nw == 8][dh <= 64 ? 0 : dh <= 128 ? 1 : 2];
    return launch(kernel, grid, nw * 32, smem, st, static_cast<const __nv_bfloat16*>(q),
                  static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v),
                  mask, static_cast<__nv_bfloat16*>(out), Sq, Sk, H, KV, dh, scale * kLog2e);
  }
  const dim3 grid((Sq + kTile - 1) / kTile, H, B);
  auto* kernel = dh <= 64    ? flash_attention_f32<64>
                 : dh <= 128 ? flash_attention_f32<128>
                             : flash_attention_f32<256>;
  return launch(kernel, grid, kThreadsF32, smem, st, static_cast<const float*>(q),
                static_cast<const float*>(k), static_cast<const float*>(v), mask,
                static_cast<float*>(out), Sq, Sk, H, KV, dh, causal, scale);
}

const char* thistle_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
