// SDDMM (sampled dense-dense product) over a plan's edges, for Hopper
// (sm_90a): K5.
//
// Replaces sagnn_tpu/ops/spmm_pallas.py::_sddmm_kernel (launched by
// sddmm_apply, spmm_pallas.py:705-784), exact (f32 tables) and bf16 (both
// tables bf16, f32 products and sums):
//
//     s[e] = sum_d x[src[e], d] * y[tgt[e], d]     for e < ptr[num_tgt]
//     s[e] = 0                                     for the pad slots after
//
// in the plan's edge order. It scores the edges of edge attention and is
// the dw of the weighted segment-sum (K2, csrc/segsum.cu): for
// out = sum_e w[e] x[src[e]], dL/dw[e] = x[src[e]] . g[tgt[e]].
//
// The TPU kernel gathers y with a one-hot matmul against the target block
// resident in VMEM, only to keep the TPU off a second random gather. Here
// both rows are gathered directly: an SDDMM has no reduction across edges,
// so it is edge-parallel. Each warp takes a contiguous span of
// kEdgesPerWarp slots, loads 32 source and 32 target ids at once (the
// target from the COO `tgt` ids, which the plan keeps beside `src`), and
// scores kUnroll edges at a time: lane `lane` multiplies column pairs
// lane, lane+32, ... of both rows, and a warp shuffle tree sums over D.
// The 32 scores of a group are written by one coalesced store. No edge
// waits on another, so a long target row (10,823 edges on the gowalla
// item plan, walked serially by one warp in K1/K2) costs nothing extra.
// The number of real edges is read from ptr[num_tgt] on the device, so
// the launch needs no copy to the host; pad slots and ids past it are
// never read. Sums run in a fixed order: the result is deterministic.
//
// What bounds it: memory. Per launch it reads E rows of x and E rows of y
// (random gathers, E*D*4 bytes each in f32, half in bf16, served partly
// from the 50 MB L2 at gowalla scale), E source and E target ids, and
// writes E f32 scores; the unique bytes (both tables once, the ids, the
// scores) are the floor. It does 2*D operations per edge, far below the
// card's arithmetic rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kGroupsPerWarp = 4;               // groups of 32 edges
constexpr int kEdgesPerWarp = 32 * kGroupsPerWarp;
constexpr int kUnroll = 4;                      // edges scored at a time
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float2 load_pair(const float* __restrict__ row,
                                            int c) {
  return reinterpret_cast<const float2*>(row)[c];
}

__device__ __forceinline__ float2 load_pair(
    const __nv_bfloat16* __restrict__ row, int c) {
  const __nv_bfloat162 v = reinterpret_cast<const __nv_bfloat162*>(row)[c];
  return make_float2(__bfloat162float(v.x), __bfloat162float(v.y));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(kFullMask, v, off);
  }
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sddmm_kernel(const T* __restrict__ x, const T* __restrict__ y,
             const int* __restrict__ src, const int* __restrict__ tgt,
             const int* __restrict__ ptr, float* __restrict__ out,
             int num_tgt, int num_slots, int d) {
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int64_t span_beg = warp * kEdgesPerWarp;
  if (span_beg >= num_slots) return;  // whole warp leaves together
  const int span_end =
      (int)min((int64_t)num_slots, span_beg + kEdgesPerWarp);
  const int n_edges = ptr[num_tgt];
  const int pairs = d >> 1;

  for (int base = (int)span_beg; base < span_end; base += 32) {
    // real edges of this group (warp-uniform); slots past them score 0
    const int cnt = max(0, min(32, min(span_end, n_edges) - base));
    const int my_src = lane < cnt ? src[base + lane] : 0;
    const int my_tgt = lane < cnt ? tgt[base + lane] : 0;
    float score = 0.f;
    for (int j = 0; j < cnt; j += kUnroll) {
      float part[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) part[u] = 0.f;
      for (int c0 = 0; c0 < pairs; c0 += 32) {
        const int c = c0 + lane;
        const bool active = c < pairs;
        float2 xv[kUnroll], yv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int s = __shfl_sync(kFullMask, my_src, j + u);
          const int t = __shfl_sync(kFullMask, my_tgt, j + u);
          const bool live = active && j + u < cnt;
          xv[u] = live ? load_pair(x + (int64_t)s * d, c)
                       : make_float2(0.f, 0.f);
          yv[u] = live ? load_pair(y + (int64_t)t * d, c)
                       : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          part[u] = fmaf(xv[u].x, yv[u].x, part[u]);
          part[u] = fmaf(xv[u].y, yv[u].y, part[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float total = warp_sum(part[u]);
        if (lane == j + u) score = total;
      }
    }
    if (base + lane < span_end) out[base + lane] = score;
  }
}

template <typename T>
int launch(const void* x, const void* y, const void* src, const void* tgt,
           const void* ptr, void* out, int num_tgt, int num_slots, int d,
           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (num_slots <= 0) return (int)cudaSuccess;
  const int64_t warps = ((int64_t)num_slots + kEdgesPerWarp - 1) /
                        kEdgesPerWarp;
  const dim3 grid((unsigned)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock));
  sddmm_kernel<T><<<grid, kWarpsPerBlock * 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const int*>(src), static_cast<const int*>(tgt),
      static_cast<const int*>(ptr), static_cast<float*>(out), num_tgt,
      num_slots, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: [N_src, d] f32; y: [num_tgt, d] f32; src, tgt: [num_slots] int32 (the
// plan's COO, target-sorted); ptr: [num_tgt + 1] int32; out: [num_slots]
// f32. d even. Launches on `stream`, does not sync. Returns the
// cudaError_t of the launch (0 = success).
int sagnn_sddmm_f32(const void* x, const void* y, const void* src,
                    const void* tgt, const void* ptr, void* out, int num_tgt,
                    int num_slots, int d, int device, void* stream) {
  return launch<float>(x, y, src, tgt, ptr, out, num_tgt, num_slots, d,
                       device, stream);
}

// The same with x and y bf16, products and sums in f32.
int sagnn_sddmm_bf16(const void* x, const void* y, const void* src,
                     const void* tgt, const void* ptr, void* out,
                     int num_tgt, int num_slots, int d, int device,
                     void* stream) {
  return launch<__nv_bfloat16>(x, y, src, tgt, ptr, out, num_tgt, num_slots,
                               d, device, stream);
}

}  // extern "C"
