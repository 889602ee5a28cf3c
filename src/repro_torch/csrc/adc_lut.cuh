// ADC table lookups shared by the port's PQ kernels (pq_adc.cu, ivf_adc.cu).
//
// A table holds one row of `stride` entries per subspace j, in float32,
// bfloat16, or int8 with one float32 scale per row. A code row's score is
//   sum_j term(j, code_j),  term = lut[j * stride + code_j]
// (int8: __fmul_rn(q8, scale_j)), summed in j order with __fadd_rn from
// -0.0f, which adds nothing to the first term: the plain versions in
// kernels/*.py start from the first term and do the same operations in the
// same order, so kernel and plain version agree bit for bit.
//
// G picks where the table (and the int8 scales) live: false for shared
// memory (plain loads), true for device memory read through the read-only
// cache (__ldg); adc_sum's GS, where it differs, for the scales alone.
// Codes are uint8, read four at a time as 32-bit words when m is a
// multiple of 4; kCodesG says whether they live in device memory.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace thistle {

enum LutType { kF32 = 0, kBF16 = 1, kI8 = 2 };

template <int DT>
struct LutT;
template <>
struct LutT<kF32> {
  using T = float;
};
template <>
struct LutT<kBF16> {
  using T = __nv_bfloat16;
};
template <>
struct LutT<kI8> {
  using T = int8_t;
};

inline size_t lut_bytes(int dt) { return dt == kF32 ? 4 : dt == kBF16 ? 2 : 1; }

template <bool G, class T>
__device__ __forceinline__ T load(const T* p) {
  if constexpr (G)
    return __ldg(p);
  else
    return *p;
}

// One table term as float32; `scale` is read only for int8.
template <int DT, bool G>
__device__ __forceinline__ float lut_term(const typename LutT<DT>::T* lut, long i, float scale) {
  if constexpr (DT == kF32)
    return load<G>(lut + i);
  else if constexpr (DT == kBF16)
    return __bfloat162float(load<G>(lut + i));
  else
    return __fmul_rn((float)load<G>(lut + i), scale);
}

template <int DT, bool G>
__device__ __forceinline__ float scale_of(const float* scales, int j) {
  if constexpr (DT == kI8)
    return load<G>(scales + j);
  else
    return 0.f;
}

template <int DT, bool G, bool kCodesG, bool GS = G>
__device__ __forceinline__ float adc_sum(const uint8_t* code, int m, long stride,
                                         const typename LutT<DT>::T* lut, const float* scales) {
  float acc = -0.0f;
  if ((m & 3) == 0) {
    const uint32_t* words = reinterpret_cast<const uint32_t*>(code);
    for (int w = 0; w < m / 4; ++w) {
      const uint32_t v = load<kCodesG>(words + w);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = 4 * w + u;
        acc = __fadd_rn(acc, lut_term<DT, G>(lut, j * stride + ((v >> (8 * u)) & 0xff),
                                             scale_of<DT, GS>(scales, j)));
      }
    }
  } else {
    for (int j = 0; j < m; ++j)
      acc = __fadd_rn(acc, lut_term<DT, G>(lut, j * stride + load<kCodesG>(code + j),
                                           scale_of<DT, GS>(scales, j)));
  }
  return acc;
}

}  // namespace thistle
