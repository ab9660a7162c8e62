// Row-gather probe (P1) for Hopper (sm_90a): the sum of gathered table rows.
//
// Replaces scripts/probe_dma_gather.py::make_dma_gather (its kernel
// `dma_kernel`): per grid step the TPU kernel fetches C = 1,024 rows, or
// `run`-row tiles of the folded [N/2, 128] view, by async DMAs indexed by
// scalar-prefetched, plan-sorted source ids, NBUF of them in flight, and
// sums everything into an [8, D] output. What it measures is the rate at
// which a kernel can fetch rows of a large table by id, the question every
// segment-sum kernel (csrc/segsum.cu) and the SDDMM's x gather
// (csrc/sddmm.cu) depend on.
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
//   * 16-byte lanes, several rows per warp instruction, as K5 reads x: a
//     lane group of `lanes` lanes (a power of two) covers a row, kVec
//     values per lane (float4 in f32, eight bf16 in bf16 when D allows),
//     so at D = 64 one instruction fetches 2 f32 or 4 bf16 rows. The rows
//     r of id i are numbered i * run + r; one instruction reads the next
//     32 / lanes of them, so at run > 1 the whole warp's lanes read one
//     contiguous stretch of a run's values;
//   * each warp stages the ids of its share of a chunk in shared memory
//     by coalesced loads first, so that no row load waits on its id's;
//   * the row loop is unrolled by kInFlight (1, 2, 4, 8): that many
//     independent load instructions per lane are in flight before the adds
//     consume them, in order, into one sum; a row in flight is held as the
//     words it was loaded as (a bf16 row in half the registers);
//   * one launch per call, deterministic, no float atomics: the rows are
//     cut into chunks of kChunkRows (fixed by n_ids and run alone), each
//     summed by one block (its warps' fixed shares, combined in warp order)
//     into one partial row; the blocks walk the chunks with a stride, and
//     the last block to arrive (an arrival counter, reset by that block)
//     sums the partials in chunk order, with every thread of the block
//     loading a fixed stripe of them and the stripes added in order. The
//     grid's size changes no bit of the result.
// A cp.async-into-shared-memory variant is not written: a register load
// already keeps kInFlight rows in flight per lane without a shared-memory
// round trip.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rows.cuh"

// The schedule is defined once, in sagnn_tpu_torch/ops/probes.py
// (P1_CHUNK_ROWS, P1_WARPS_PER_BLOCK), which sizes the grid and the scratch
// from it; ops/_build.py passes it as -D defines.
#if !defined(SAGNN_P1_CHUNK_ROWS) || !defined(SAGNN_P1_WARPS_PER_BLOCK)
#error "build through sagnn_tpu_torch/ops/_build.py, which defines the schedule"
#endif

namespace {

constexpr int kChunkRows = SAGNN_P1_CHUNK_ROWS;
constexpr int kWarpsPerBlock = SAGNN_P1_WARPS_PER_BLOCK;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kWarpRows = kChunkRows / kWarpsPerBlock;
constexpr int kMaxD = 64;
constexpr int kFinalInFlight = 8;
static_assert(kChunkRows % kWarpsPerBlock == 0, "a warp's share is whole");
static_assert(kWarpRows % 16 == 0 && kWarpRows % 32 == 0,
              "a warp's share holds whole runs and whole id loads");

// The last block's pass: out[c] = the sum of the `chunks` partial rows in
// chunk order. Thread t owns column group t % groups (kCols values) and
// sums rows stripe, stripe + stripes, ... (kFinalInFlight loads in flight);
// the stripes' sums are then added in stripe order.
template <int kCols>
__device__ void sum_partials(const float* __restrict__ partial,
                             int64_t chunks, int d, float* __restrict__ out,
                             float* s_stripes) {
  const int groups = d / kCols;
  const int stripes = kThreads / groups;
  const int t = threadIdx.x;
  const int g = t % groups;
  const int stripe = t / groups;
  if (stripe < stripes) {
    float acc[kFinalInFlight][kCols];
#pragma unroll
    for (int u = 0; u < kFinalInFlight; ++u) {
#pragma unroll
      for (int i = 0; i < kCols; ++i) acc[u][i] = 0.f;
    }
    for (int64_t r0 = stripe; r0 < chunks;
         r0 += (int64_t)stripes * kFinalInFlight) {
#pragma unroll
      for (int u = 0; u < kFinalInFlight; ++u) {
        const int64_t r = r0 + (int64_t)u * stripes;
        if (r < chunks) {
          const float* p = partial + r * d + g * kCols;
          if constexpr (kCols == 4) {
            const float4 v = __ldcg(reinterpret_cast<const float4*>(p));
            acc[u][0] += v.x;
            acc[u][1] += v.y;
            acc[u][2] += v.z;
            acc[u][3] += v.w;
          } else {
            const float2 v = __ldcg(reinterpret_cast<const float2*>(p));
            acc[u][0] += v.x;
            acc[u][1] += v.y;
          }
        }
      }
    }
#pragma unroll
    for (int half = kFinalInFlight / 2; half > 0; half /= 2) {
#pragma unroll
      for (int u = 0; u < half; ++u) {
#pragma unroll
        for (int i = 0; i < kCols; ++i) acc[u][i] += acc[u + half][i];
      }
    }
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      s_stripes[stripe * d + g * kCols + i] = acc[0][i];
    }
  }
  __syncthreads();
  if (t < d) {
    float s = 0.f;
    for (int k = 0; k < stripes; ++k) s += s_stripes[k * d + t];
    out[t] = s;
  }
}

// partial: [chunks, d] f32 scratch; counter: one unsigned, 0 on entry and
// left at 0; lanes = 1 << lanes_log2 lanes per row, lanes * kVec >= d.
template <typename T, int kVec, int kInFlight, int kRun>
__global__ void __launch_bounds__(kThreads, 1)
gather_sum_kernel(const T* __restrict__ x, const int* __restrict__ src,
                  int n_ids, int d, int lanes_log2,
                  float* __restrict__ partial,
                  unsigned* __restrict__ counter, float* __restrict__ out) {
  __shared__ float s_sums[kThreads * 4];  // warps' rows, then stripes' sums
  __shared__ int s_ids[kWarpsPerBlock][kWarpRows];  // each warp's ids
  __shared__ bool s_last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int lanes = 1 << lanes_log2;
  const int lig = lane & (lanes - 1);
  const int group = lane >> lanes_log2;
  const int groups = 32 >> lanes_log2;   // rows per instruction
  const int col = lig * kVec;
  const bool active = col < d;
  const int64_t rows = (int64_t)n_ids * kRun;
  const int64_t chunks = (rows + kChunkRows - 1) / kChunkRows;

  for (int64_t c = blockIdx.x; c < chunks; c += gridDim.x) {
    const int64_t r0 = c * kChunkRows + (int64_t)warp * kWarpRows;
    const int64_t r1 = min(rows, r0 + kWarpRows);
    // the warp's ids, staged at once by coalesced loads (r0 is a multiple
    // of kRun), so that no row load waits on its id's load
    const int64_t id0 = r0 / kRun;
    const int n_stage = r1 > r0 ? (int)((r1 - r0 + kRun - 1) / kRun) : 0;
#pragma unroll
    for (int k = 0; k < kWarpRows / 32; ++k) {
      const int j = k * 32 + lane;
      if (j < n_stage) s_ids[warp][j] = src[id0 + j];
    }
    __syncwarp();
    float acc[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[i] = 0.f;
    // instruction u of a batch reads rows base + u * groups + group
    for (int64_t base = r0; base < r1; base += (int64_t)kInFlight * groups) {
      Row<T, kVec> v[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int64_t row = base + (int64_t)u * groups + group;
        if (active && row < r1) {
          const int j = (int)(row - r0);
          const int64_t id = (int64_t)s_ids[warp][j / kRun] + j % kRun;
          v[u].load(x + id * d + col);
        } else {
          v[u].zero();
        }
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
#pragma unroll
        for (int i = 0; i < kVec; ++i) acc[i] += v[u].at(i);
      }
    }
    // the warp's groups, by a butterfly (every lane ends with the same sum)
    for (int off = lanes; off < 32; off <<= 1) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
      }
    }
    if (group == 0 && active) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) s_sums[warp * kMaxD + col + i] = acc[i];
    }
    __syncthreads();
    if (threadIdx.x < d) {  // the block's warps in order
      float s = s_sums[threadIdx.x];
#pragma unroll
      for (int w = 1; w < kWarpsPerBlock; ++w) {
        s += s_sums[w * kMaxD + threadIdx.x];
      }
      partial[c * d + threadIdx.x] = s;
    }
    __syncthreads();  // s_sums and s_ids are reused by the next chunk
  }

  // the last block to arrive sums the partials
  __threadfence();  // this block's partials are visible to every SM
  __syncthreads();
  if (threadIdx.x == 0) {
    s_last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (threadIdx.x == 0) *counter = 0u;  // clean for the next launch
  if (d % 4 == 0) {
    sum_partials<4>(partial, chunks, d, out, s_sums);
  } else {
    sum_partials<2>(partial, chunks, d, out, s_sums);
  }
}

template <typename T, int kVec, int kInFlight, int kRun>
cudaError_t launch(const void* x, const void* src, int n_ids, int d,
                   int lanes_log2, void* scratch, void* counter, int blocks,
                   void* out, cudaStream_t stream) {
  gather_sum_kernel<T, kVec, kInFlight, kRun><<<blocks, kThreads, 0,
                                                stream>>>(
      static_cast<const T*>(x), static_cast<const int*>(src), n_ids, d,
      lanes_log2, static_cast<float*>(scratch),
      static_cast<unsigned*>(counter), static_cast<float*>(out));
  return cudaGetLastError();
}

template <typename T, int kVec, int kRun>
cudaError_t dispatch_in_flight(int in_flight, const void* x, const void* src,
                               int n_ids, int d, int lanes_log2,
                               void* scratch, void* counter, int blocks,
                               void* out, cudaStream_t stream) {
  switch (in_flight) {
    case 1:
      return launch<T, kVec, 1, kRun>(x, src, n_ids, d, lanes_log2, scratch,
                                      counter, blocks, out, stream);
    case 2:
      return launch<T, kVec, 2, kRun>(x, src, n_ids, d, lanes_log2, scratch,
                                      counter, blocks, out, stream);
    case 4:
      return launch<T, kVec, 4, kRun>(x, src, n_ids, d, lanes_log2, scratch,
                                      counter, blocks, out, stream);
    case 8:
      return launch<T, kVec, 8, kRun>(x, src, n_ids, d, lanes_log2, scratch,
                                      counter, blocks, out, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T, int kVec>
cudaError_t dispatch_run(int run, int in_flight, const void* x,
                         const void* src, int n_ids, int d, int lanes_log2,
                         void* scratch, void* counter, int blocks, void* out,
                         cudaStream_t stream) {
  switch (run) {
    case 1:
      return dispatch_in_flight<T, kVec, 1>(in_flight, x, src, n_ids, d,
                                            lanes_log2, scratch, counter,
                                            blocks, out, stream);
    case 4:
      return dispatch_in_flight<T, kVec, 4>(in_flight, x, src, n_ids, d,
                                            lanes_log2, scratch, counter,
                                            blocks, out, stream);
    case 8:
      return dispatch_in_flight<T, kVec, 8>(in_flight, x, src, n_ids, d,
                                            lanes_log2, scratch, counter,
                                            blocks, out, stream);
    case 16:
      return dispatch_in_flight<T, kVec, 16>(in_flight, x, src, n_ids, d,
                                             lanes_log2, scratch, counter,
                                             blocks, out, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
int gather_sum(const void* x, const void* src, int n_ids, int run,
               int in_flight, int vec, int lanes, void* scratch,
               void* counter, int blocks, void* out, int d, int device,
               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (d <= 0 || d > kMaxD || (d & 1) || n_ids < 0 || blocks <= 0 ||
      vec <= 0 || d % vec || lanes <= 0 || lanes > 32 ||
      (lanes & (lanes - 1)) || lanes * vec < d) {
    return (int)cudaErrorInvalidValue;
  }
  const int lanes_log2 = __builtin_ctz((unsigned)lanes);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 2:
      return (int)dispatch_run<T, 2>(run, in_flight, x, src, n_ids, d,
                                     lanes_log2, scratch, counter, blocks,
                                     out, s);
    case 4:
      return (int)dispatch_run<T, 4>(run, in_flight, x, src, n_ids, d,
                                     lanes_log2, scratch, counter, blocks,
                                     out, s);
    case 8:
      if constexpr (sizeof(T) == 2) {
        return (int)dispatch_run<T, 8>(run, in_flight, x, src, n_ids, d,
                                       lanes_log2, scratch, counter, blocks,
                                       out, s);
      }
      return (int)cudaErrorInvalidValue;
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x: [N, d] f32, 16-byte aligned (d even, <= 64); src: [n_ids] int32, every
// id + run - 1 a row of x; run in {1, 4, 8, 16}; in_flight in {1, 2, 4, 8};
// vec (values per lane: 2 or 4, dividing d), lanes (per row, a power of
// two, lanes * vec >= d) and blocks from probes.gather_schedule; scratch:
// [ceil(n_ids * run / P1_CHUNK_ROWS), d] f32; counter: one unsigned, 0 (and
// left at 0); out: [d] f32. One launch on `stream`, no sync. Returns the
// cudaError_t (0 = success; cudaErrorInvalidValue for an unsupported run,
// in_flight, d or schedule).
int sagnn_gather_sum_f32(const void* x, const void* src, int n_ids, int run,
                         int in_flight, int vec, int lanes, void* scratch,
                         void* counter, int blocks, void* out, int d,
                         int device, void* stream) {
  return gather_sum<float>(x, src, n_ids, run, in_flight, vec, lanes,
                           scratch, counter, blocks, out, d, device, stream);
}

// The same with x: [N, d] bf16 (vec 2, 4 or 8), summed in f32.
int sagnn_gather_sum_bf16(const void* x, const void* src, int n_ids, int run,
                          int in_flight, int vec, int lanes, void* scratch,
                          void* counter, int blocks, void* out, int d,
                          int device, void* stream) {
  return gather_sum<__nv_bfloat16>(x, src, n_ids, run, in_flight, vec, lanes,
                                   scratch, counter, blocks, out, d, device,
                                   stream);
}

}  // extern "C"
