// Row-gather probe (P1) for Hopper (sm_90a): the sum of gathered table rows.
//
// Replaces scripts/probe_dma_gather.py::make_dma_gather (its kernel
// `dma_kernel`): per grid step the TPU kernel fetches C = 1,024 rows, or
// `run`-row tiles of the folded [N/2, 128] view, by async DMAs indexed by
// scalar-prefetched, plan-sorted source ids, NBUF of them in flight, and
// sums everything into an [8, D] output. What it measures is the rate at
// which a kernel can fetch rows of a large table by id, the question every
// segment-sum kernel (csrc/segsum.cu) depends on.
//
// Here the function is
//
//     out[:] = sum_{i < n_ids} sum_{r < run} x[src[i] + r, :]        (f32)
//
// over an [N, D] table in f32 or bf16 (D even, at most 64), with the sums in
// f32. `run` = 1 gathers single rows; `run` = 4, 8, 16 gathers `run`
// consecutive rows per id, the tile gather of the folded view
// (probe_dma_gather.py:172-186).
//
// What bounds it: memory, and the latency of dependent-free row loads. The
// unique bytes are the distinct rows touched once, the ids and the [D]
// output; the probe's own shape (1,048,576 rows of 64 f32, 256 MB) is five
// times the 50 MB L2, so there it measures gathers from HBM, where a
// 12.6 MB gowalla-size table is served from L2.
//
// What the design does about it (written for this card's memory system, not
// the TPU's DMA and semaphores):
//   * one warp reads one row in one coalesced load: each lane owns a column
//     pair (float2, 8 bytes in f32; bf16x2, 4 bytes in bf16);
//   * each warp loads 32 ids at once and broadcasts them with __shfl_sync,
//     as K1 does; the row loop is unrolled by kInFlight (1, 2, 4, 8) so that
//     that many independent row loads are in flight before the adds consume
//     them, into kInFlight independent sums;
//   * kRun consecutive rows per id are walked in order, so a run is one
//     contiguous stretch of run * D values;
//   * the reduction is deterministic: each warp sums a fixed contiguous
//     range of ids, the block adds its warps in order into one partial row
//     per block, and a second one-block pass adds the partials in block
//     order. No atomics.
// A cp.async-into-shared-memory variant is not written: a register load
// already keeps kInFlight rows in flight per warp without a shared-memory
// round trip.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
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

// Each warp sums ids [warp * ids_per_warp, ...) into `partial` row
// blockIdx.x (a [gridDim.x, d] f32 array) together with its block's other
// warps, in warp order.
template <typename T, int kInFlight, int kRun>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_sum_kernel(const T* __restrict__ x, const int* __restrict__ src,
                  int n_ids, int ids_per_warp, int d,
                  float* __restrict__ partial) {
  __shared__ float2 warp_sums[kWarpsPerBlock][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t first =
      (int64_t)(blockIdx.x * kWarpsPerBlock + warp) * ids_per_warp;
  const int beg = (int)(first < n_ids ? first : n_ids);
  const int end = (int)(first + ids_per_warp < n_ids ? first + ids_per_warp
                                                      : n_ids);
  const bool active = lane < (d >> 1);

  float2 acc[kInFlight];
#pragma unroll
  for (int u = 0; u < kInFlight; ++u) acc[u] = make_float2(0.f, 0.f);
  for (int base = beg; base < end; base += 32) {
    const int n = min(32, end - base);  // warp-uniform
    const int my_src = lane < n ? src[base + lane] : 0;
    const int rows = n * kRun;
    int j = 0;
    for (; j + kInFlight <= rows; j += kInFlight) {
      float2 v[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int s =
            __shfl_sync(kFullMask, my_src, (j + u) / kRun) + (j + u) % kRun;
        v[u] = active ? load_pair(x + (int64_t)s * d, lane)
                      : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        acc[u].x += v[u].x;
        acc[u].y += v[u].y;
      }
    }
    // the tail (< kInFlight rows): row j + u goes to sum u
#pragma unroll
    for (int u = 0; u < kInFlight - 1; ++u) {
      if (j + u < rows) {  // warp-uniform
        const int s =
            __shfl_sync(kFullMask, my_src, (j + u) / kRun) + (j + u) % kRun;
        if (active) {
          const float2 v = load_pair(x + (int64_t)s * d, lane);
          acc[u].x += v.x;
          acc[u].y += v.y;
        }
      }
    }
  }
#pragma unroll
  for (int half = kInFlight / 2; half > 0; half /= 2) {
#pragma unroll
    for (int u = 0; u < half; ++u) {
      acc[u].x += acc[u + half].x;
      acc[u].y += acc[u + half].y;
    }
  }
  warp_sums[warp][lane] = acc[0];
  __syncthreads();
  if (warp == 0 && active) {
    float2 s = warp_sums[0][lane];
#pragma unroll
    for (int w = 1; w < kWarpsPerBlock; ++w) {
      s.x += warp_sums[w][lane].x;
      s.y += warp_sums[w][lane].y;
    }
    reinterpret_cast<float2*>(partial + (int64_t)blockIdx.x * d)[lane] = s;
  }
}

// out[c] = sum over the `blocks` partial rows, in block order.
__global__ void gather_sum_finalize(const float* __restrict__ partial,
                                    int blocks, int d,
                                    float* __restrict__ out) {
  const int c = threadIdx.x;
  if (c >= d) return;
  float s = 0.f;
#pragma unroll 8
  for (int b = 0; b < blocks; ++b) s += partial[(int64_t)b * d + c];
  out[c] = s;
}

template <typename T, int kInFlight, int kRun>
cudaError_t launch_gather(const void* x, const void* src, int n_ids, int d,
                          void* scratch, int max_blocks, void* out,
                          cudaStream_t stream) {
  // the fewest blocks that give each warp at most ids_per_warp ids, with
  // ids_per_warp a multiple of 32 (one id load per lane per group)
  const int64_t warps_wanted = ((int64_t)n_ids + 31) / 32;
  const int blocks_wanted =
      (int)((warps_wanted + kWarpsPerBlock - 1) / kWarpsPerBlock);
  int blocks = max(1, min(max_blocks, blocks_wanted));
  const int64_t per_warp =
      ((int64_t)n_ids + (int64_t)blocks * kWarpsPerBlock - 1) /
      ((int64_t)blocks * kWarpsPerBlock);
  const int64_t rounded = (per_warp + 31) / 32 * 32;
  const int ids_per_warp = (int)(rounded > 32 ? rounded : 32);
  blocks = (int)(((int64_t)n_ids + (int64_t)ids_per_warp * kWarpsPerBlock -
                  1) / ((int64_t)ids_per_warp * kWarpsPerBlock));
  blocks = max(1, blocks);
  float* partial = static_cast<float*>(scratch);
  gather_sum_kernel<T, kInFlight, kRun>
      <<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
          static_cast<const T*>(x), static_cast<const int*>(src), n_ids,
          ids_per_warp, d, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gather_sum_finalize<<<1, 64, 0, stream>>>(partial, blocks, d,
                                            static_cast<float*>(out));
  return cudaGetLastError();
}

template <typename T, int kRun>
cudaError_t dispatch_in_flight(int in_flight, const void* x, const void* src,
                               int n_ids, int d, void* scratch,
                               int max_blocks, void* out,
                               cudaStream_t stream) {
  switch (in_flight) {
    case 1:
      return launch_gather<T, 1, kRun>(x, src, n_ids, d, scratch, max_blocks,
                                       out, stream);
    case 2:
      return launch_gather<T, 2, kRun>(x, src, n_ids, d, scratch, max_blocks,
                                       out, stream);
    case 4:
      return launch_gather<T, 4, kRun>(x, src, n_ids, d, scratch, max_blocks,
                                       out, stream);
    case 8:
      return launch_gather<T, 8, kRun>(x, src, n_ids, d, scratch, max_blocks,
                                       out, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
int gather_sum(const void* x, const void* src, int n_ids, int run,
               int in_flight, void* scratch, int max_blocks, void* out, int d,
               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (d <= 0 || d > 64 || (d & 1) || max_blocks <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (run) {
    case 1:
      return (int)dispatch_in_flight<T, 1>(in_flight, x, src, n_ids, d,
                                           scratch, max_blocks, out, s);
    case 4:
      return (int)dispatch_in_flight<T, 4>(in_flight, x, src, n_ids, d,
                                           scratch, max_blocks, out, s);
    case 8:
      return (int)dispatch_in_flight<T, 8>(in_flight, x, src, n_ids, d,
                                           scratch, max_blocks, out, s);
    case 16:
      return (int)dispatch_in_flight<T, 16>(in_flight, x, src, n_ids, d,
                                            scratch, max_blocks, out, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x: [N, d] f32 (d even, <= 64); src: [n_ids] int32, every id + run - 1 a
// row of x; run in {1, 4, 8, 16}; in_flight in {1, 2, 4, 8}; scratch:
// [max_blocks, d] f32; out: [d] f32. Two launches on `stream` (the gather
// and the fixed-order pass over the block partials), no sync. Returns the
// cudaError_t (0 = success; cudaErrorInvalidValue for an unsupported run,
// in_flight or d).
int sagnn_gather_sum_f32(const void* x, const void* src, int n_ids, int run,
                         int in_flight, void* scratch, int max_blocks,
                         void* out, int d, int device, void* stream) {
  return gather_sum<float>(x, src, n_ids, run, in_flight, scratch,
                           max_blocks, out, d, device, stream);
}

// The same with x: [N, d] bf16, summed in f32.
int sagnn_gather_sum_bf16(const void* x, const void* src, int n_ids, int run,
                          int in_flight, void* scratch, int max_blocks,
                          void* out, int d, int device, void* stream) {
  return gather_sum<__nv_bfloat16>(x, src, n_ids, run, in_flight, scratch,
                                   max_blocks, out, d, device, stream);
}

}  // extern "C"
