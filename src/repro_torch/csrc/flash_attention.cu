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
// The (Sq, Sk) scores never reach device memory: a block owns 64 query rows
// of one (b, h), walks the keys in tiles of 64 staged in shared memory, and
// keeps the online softmax's running max, denominator and output
// accumulator in float32 registers (the TPU kernel's VMEM scratch). Under
// causal the tiles strictly above the diagonal are skipped, as the TPU
// kernel skips them; only when a row of the block has seen no unmasked key
// by then (possible with kv_mask) does the block walk the rest, so that row
// still averages over all Sk keys.
//
// bf16: four warps of 16 rows; q.k^T and p.v on mma.sync.m16n8k16 (bf16 in,
// float32 accumulate). p is rounded to bf16 before p.v, as the reference
// rounds it (attention.py:88 and :138), and the denominator sums the
// unrounded p. float32: 256 threads, four a row, float32 FMA.
//
// What bounds it: at the encoder's seq_len 64 reading q, k, v and writing o
// (2 bytes an element) against 4*B*H*S^2*dh bf16 operations: about 60 us of
// bytes against 3 us of tensor-core work for B = 512, H = 12, dh = 64, so
// bytes; near the ridge at S = 512. This first version stages each tile with
// plain 16-byte loads and no overlap of the next tile's load with the
// current tile's products (no TMA, wgmma or warp specialisation yet).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
constexpr int kTile = 64;          // query rows of a block; keys of a tile
constexpr int kThreadsBf16 = 128;  // four warps, 16 query rows each
constexpr int kThreadsF32 = 256;   // four threads a query row

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

template <int DHMAX>
__global__ void __launch_bounds__(kThreadsBf16)
    flash_attention_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const unsigned char* __restrict__ kv_mask, __nv_bfloat16* __restrict__ out,
                         int Sq, int Sk, int H, int KV, int dh, int causal, float scale) {
  constexpr int NT = DHMAX / 8;  // 8-column tiles of the output
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = dh + 8;  // row stride in elements: 16 bytes of pad
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + kTile * ld;
  __nv_bfloat16* Vs = Ks + kTile * ld;
  unsigned char* state = reinterpret_cast<unsigned char*>(Vs + kTile * ld);
  const uint16_t* Qh = reinterpret_cast<const uint16_t*>(Qs);
  const uint16_t* Kh = reinterpret_cast<const uint16_t*>(Ks);
  const uint16_t* Vh = reinterpret_cast<const uint16_t*>(Vs);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // row within the fragment
  const int t = lane & 3;   // column pair within the fragment
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int row0 = q0 + warp * 16 + g;  // this thread's two rows
  const int row1 = row0 + 8;

  stage_rows(Qs, ld, q, b, q0, Sq, H, h, dh, tid, kThreadsBf16);

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // l: this thread's part

  const int n_tiles = (Sk + kTile - 1) / kTile;
  const int q_last = min(q0 + kTile, Sq) - 1;
  const int skip_from = causal ? min(n_tiles, q_last / kTile + 1) : n_tiles;
  for (int jt = 0; jt < n_tiles; ++jt) {
    if (jt == skip_from) {
      // past the diagonal: go on only for a row that has seen no unmasked key
      const int empty = (row0 < Sq && m0 == kNegInf) || (row1 < Sq && m1 == kNegInf);
      if (!__syncthreads_or(empty)) break;
    }
    const int k0 = jt * kTile;
    __syncthreads();  // the last tile's reads are done
    stage_rows(Ks, ld, k, b, k0, Sk, KV, kvh, dh, tid, kThreadsBf16);
    stage_rows(Vs, ld, v, b, k0, Sk, KV, kvh, dh, tid, kThreadsBf16);
    stage_key_states(state, kv_mask, b, k0, Sk, tid);
    __syncthreads();

    // scores of the warp's 16 rows against the 64 keys: 8 tiles of 16 x 8
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    for (int kd = 0; kd < dh; kd += 16) {
      const uint16_t* qa = Qh + (warp * 16 + g) * ld + kd + 2 * t;
      const uint32_t a0 = *reinterpret_cast<const uint32_t*>(qa);
      const uint32_t a1 = *reinterpret_cast<const uint32_t*>(qa + 8 * ld);
      const uint32_t a2 = *reinterpret_cast<const uint32_t*>(qa + 8);
      const uint32_t a3 = *reinterpret_cast<const uint32_t*>(qa + 8 * ld + 8);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const uint16_t* kb = Kh + (n * 8 + g) * ld + kd + 2 * t;
        mma_bf16(s[n], a0, a1, a2, a3, *reinterpret_cast<const uint32_t*>(kb),
                 *reinterpret_cast<const uint32_t*>(kb + 8));
      }
    }

    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n * 8 + 2 * t + e;
        const unsigned char st = state[col];
        s[n][e] = masked_score(s[n][e], scale, st, row0, k0 + col, causal);
        s[n][2 + e] = masked_score(s[n][2 + e], scale, st, row1, k0 + col, causal);
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
    const float c0 = expf(m0 - mn0), c1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[n][e] = expf(s[n][e] - mn0);
        s[n][2 + e] = expf(s[n][2 + e] - mn1);
        ps0 += s[n][e];
        ps1 += s[n][2 + e];
      }
    }
    l0 = l0 * c0 + ps0;
    l1 = l1 * c1 + ps1;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= c0;
      o[n][1] *= c0;
      o[n][2] *= c1;
      o[n][3] *= c1;
    }

    // o += p v: p (bf16) is the A operand straight from the score tiles
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t a1 = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t a2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const uint16_t* vb = Vh + (kk * 16 + 2 * t) * ld + g;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (n * 8 < dh) {
          const uint16_t* vn = vb + n * 8;
          const uint32_t b0 = (uint32_t)vn[0] | ((uint32_t)vn[ld] << 16);
          const uint32_t b1 = (uint32_t)vn[8 * ld] | ((uint32_t)vn[9 * ld] << 16);
          mma_bf16(o[n], a0, a1, a2, a3, b0, b1);
        }
      }
    }
  }

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

// Shared memory a launch takes, in bytes.
size_t flash_attention_smem(int dh, int bf16) {
  return bf16 ? 3 * (size_t)kTile * (dh + 8) * 2 + kTile : 2 * (size_t)kTile * dh * 4 + kTile;
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
  const dim3 grid((Sq + kTile - 1) / kTile, H, B);
  const size_t smem = flash_attention_smem(dh, bf16);
  const auto* mask = static_cast<const unsigned char*>(kv_mask);
  if (bf16) {
    auto* kernel = dh <= 64    ? flash_attention_bf16<64>
                   : dh <= 128 ? flash_attention_bf16<128>
                               : flash_attention_bf16<256>;
    return launch(kernel, grid, kThreadsBf16, smem, st, static_cast<const __nv_bfloat16*>(q),
                  static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v),
                  mask, static_cast<__nv_bfloat16*>(out), Sq, Sk, H, KV, dh, causal, scale);
  }
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
