// A lane's slice of a table row as the kernels of csrc/sddmm.cu (K5) and
// csrc/probes.cu (P1) load it: kVec consecutive values of an f32 or bf16
// row, read by 16-byte (or narrower) vector loads and held as the raw
// 32-bit words that were loaded (one f32, or two bf16, each), so that a
// bf16 row in flight holds half the registers of an f32 one. The values
// are widened to f32 (exactly) only as they are used. The loads cache in
// L2 only (__ldcg): a gathered row is used once, so L1 would hold it for
// nothing.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

template <typename T, int kVec>
struct Row {
  static constexpr int kWords = kVec * (int)sizeof(T) / 4;
  static_assert(kWords == 1 || kWords == 2 || kWords == 4 || kWords == 8,
                "a lane loads 4, 8, 16 or 2 x 16 bytes");
  unsigned w[kWords];

  // p: the lane's first value, aligned to min(16, kWords * 4) bytes
  __device__ __forceinline__ void load(const T* __restrict__ p) {
    if constexpr (kWords >= 4) {
#pragma unroll
      for (int k = 0; k < kWords / 4; ++k) {
        const uint4 q = __ldcg(reinterpret_cast<const uint4*>(p) + k);
        w[4 * k] = q.x;
        w[4 * k + 1] = q.y;
        w[4 * k + 2] = q.z;
        w[4 * k + 3] = q.w;
      }
    } else if constexpr (kWords == 2) {
      const uint2 q = __ldcg(reinterpret_cast<const uint2*>(p));
      w[0] = q.x;
      w[1] = q.y;
    } else {
      w[0] = __ldcg(reinterpret_cast<const unsigned*>(p));
    }
  }

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int k = 0; k < kWords; ++k) w[k] = 0u;
  }

  // value i in f32 (a bf16 is widened exactly)
  __device__ __forceinline__ float at(int i) const {
    if constexpr (sizeof(T) == 4) {
      return __uint_as_float(w[i]);
    } else {
      const unsigned word = w[i >> 1];
      return __uint_as_float((i & 1) ? word & 0xffff0000u : word << 16);
    }
  }

  // the kVec values in f32; kRound rounds f32 values to bf16 first, two
  // at a time (__floats2bfloat162_rn: round to nearest even, the rounding
  // of torch's .to(torch.bfloat16)); bf16 values are already rounded
  template <bool kRound>
  __device__ __forceinline__ void values(float* v) const {
    if constexpr (kRound && sizeof(T) == 4) {
      static_assert(kVec % 2 == 0, "values are rounded in pairs");
#pragma unroll
      for (int i = 0; i < kVec; i += 2) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(
            __uint_as_float(w[i]), __uint_as_float(w[i + 1]));
        v[i] = __low2float(h);
        v[i + 1] = __high2float(h);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) v[i] = at(i);
    }
  }
};
