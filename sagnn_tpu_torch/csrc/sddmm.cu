// SDDMM (sampled dense-dense product) over a plan's edges, for Hopper
// (sm_90a): K5.
//
// Replaces sagnn_tpu/ops/spmm_pallas.py::_sddmm_kernel (launched by
// sddmm_apply, spmm_pallas.py:705-784), exact (f32 tables) and bf16
// (bf16-rounded tables, f32 products and sums):
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
// so it is edge-parallel.
//
// What bounds it: memory. Per launch it must read both tables once, E
// source and E target ids, and write one f32 score per slot; it does 2*D
// operations per edge, far below the card's arithmetic rate. What it moves
// beyond that is the gather: one row of x per edge (a random 256-byte f32
// row, 128 in bf16, served from the 50 MB L2 at gowalla scale) and one
// row of y per run of edges with the same target.
//
// What the design does about it:
//   * Each target row is read once per run. The COO is target-sorted, so
//     the edges onto one target are consecutive slots (runs of ~10-12 at
//     gowalla). Work is cut edge-balanced into spans of kSpan consecutive
//     slots, one span per lane group; a group walks its span kBatch edges
//     at a time and loads y[tgt] only for an edge whose target differs from
//     the edge before it in the span; the other edges of the run reuse the
//     row held in registers. A run crossing a span boundary costs one more
//     load of its row per span, and nothing waits across spans.
//   * 16-byte lanes, several rows per warp instruction. A lane group of
//     `lanes` lanes (a power of two) covers a row, kVec values per lane:
//     at D = 64 a group is 16 lanes of float4, so one warp instruction
//     fetches 2 rows. A
//     group keeps kBatch row loads of x (and the batch's new y rows) in
//     flight, held as loaded (rows.cuh), so that the registers stay few and
//     many warps fit on an SM; the batch's scores are summed inside the
//     group by one reduce-scatter (kBatch - 1 + log2(lanes / kBatch)
//     shuffles for kBatch scores, each lane left with one score to
//     write), whose steps the rows of one instruction share.
//     kVec is chosen per launch from D and the mode (the host gives
//     16-byte aligned tables), down to 2 values per lane for any even D; a
//     D wider than one group's pass takes `chunks` passes over the columns,
//     each adding its part to the score in order.
//   * bf16 without extra kernels: the kernel takes f32 tables in both
//     modes and, in bf16 mode, rounds them to bf16 in registers
//     (__floats2bfloat162_rn, the round-to-nearest-even of torch's
//     .to(torch.bfloat16), bit for bit), x two values per conversion and
//     y once per run, so the call casts nothing first: 16-byte lanes in
//     both modes. (The host widens a bf16 table to f32, exactly; rounding
//     a bf16 value again changes nothing.)
//   * The number of real edges is read from ptr[num_tgt] on the device, so
//     the launch needs no copy to the host; pad slots and ids past it are
//     never read (their targets, num_tgt, lie outside y).
//   * Deterministic: each score is summed in a fixed order (per lane, then
//     the group's shuffle tree, then the passes in order), no atomics; the
//     grid walks the spans with a stride and changes no score.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rows.cuh"

// The schedule is defined once, in sagnn_tpu_torch/ops/spmm_cuda.py
// (SDDMM_SPAN, SDDMM_BATCH, SDDMM_WARPS_PER_BLOCK, SDDMM_BLOCKS_PER_SM),
// which sizes the grid from it; ops/_build.py passes it as -D defines.
#if !defined(SAGNN_SDDMM_SPAN) || !defined(SAGNN_SDDMM_BATCH) || \
    !defined(SAGNN_SDDMM_WARPS_PER_BLOCK) || \
    !defined(SAGNN_SDDMM_BLOCKS_PER_SM)
#error "build through sagnn_tpu_torch/ops/_build.py, which defines the schedule"
#endif

namespace {

constexpr int kSpan = SAGNN_SDDMM_SPAN;          // slots per lane group
constexpr int kBatch = SAGNN_SDDMM_BATCH;        // edges scored at a time
constexpr int kWarpsPerBlock = SAGNN_SDDMM_WARPS_PER_BLOCK;
// blocks resident per SM: the grid's cap per SM, and the launch bound
// that holds each thread to 64 registers so that they fit
constexpr int kBlocksPerSm = SAGNN_SDDMM_BLOCKS_PER_SM;
static_assert(kSpan % kBatch == 0, "a span is whole batches");
static_assert((kBatch & (kBatch - 1)) == 0, "kBatch is a power of two");

// The sums of part[0..kBatch) over a group's `lanes` lanes (lanes >=
// kBatch), scattered: each of the first log2(kBatch) shuffle steps halves
// the values a lane carries (a lane keeps one half and adds its partner's
// share of it), the later steps add over the lanes that share an edge.
// Returns the score of edge `u` (the lane's bits from lanes / kBatch up):
// kBatch - 1 + log2(lanes / kBatch) shuffles for kBatch scores, in a fixed
// order.
__device__ __forceinline__ float reduce_scatter(float (&part)[kBatch],
                                                int lig, int lanes,
                                                unsigned mask, int& u) {
  int off = lanes >> 1;
  u = 0;
#pragma unroll
  for (int h = kBatch / 2; h >= 1; h >>= 1) {
    const bool hi = (lig & off) != 0;
#pragma unroll
    for (int k = 0; k < h; ++k) {
      const float send = hi ? part[k] : part[k + h];
      const float keep = hi ? part[k + h] : part[k];
      part[k] = keep + __shfl_xor_sync(mask, send, off);
    }
    if (hi) u += h;
    off >>= 1;
  }
  float v = part[0];
  for (; off > 0; off >>= 1) v += __shfl_xor_sync(mask, v, off);
  return v;
}

// x: [N_src, d], y: [num_tgt, d], f32, 16-byte aligned, d % kVec == 0.
// Lane group `group` of warp w takes span w * groups + group, then every
// stride-th span after it; lanes = 1 << lanes_log2 lanes per row.
template <bool kRound, int kVec>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, kBlocksPerSm)
sddmm_kernel(const float* __restrict__ x, const float* __restrict__ y,
             const int* __restrict__ src, const int* __restrict__ tgt,
             const int* __restrict__ ptr, float* __restrict__ out,
             int num_tgt, int num_slots, int d, int lanes_log2, int chunks) {
  const int lane = threadIdx.x & 31;
  const int lanes = 1 << lanes_log2;
  const int lig = lane & (lanes - 1);              // lane in its group
  const int group = lane >> lanes_log2;
  const int groups = 32 >> lanes_log2;             // rows per instruction
  const unsigned mask = (lanes == 32 ? 0xffffffffu : (1u << lanes) - 1u)
                        << (group * lanes);
  const int n_edges = ptr[num_tgt];
  const int64_t spans = ((int64_t)num_slots + kSpan - 1) / kSpan;
  const int64_t warp =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int64_t stride = (int64_t)gridDim.x * kWarpsPerBlock * groups;

  for (int64_t span = warp * groups + group; span < spans; span += stride) {
    const int beg = (int)(span * kSpan);
    const int end = min(num_slots, beg + kSpan);
    const int live_end = max(beg, min(end, n_edges));  // real edges: < it
    for (int c = 0; c < chunks; ++c) {
      const int col = (c * lanes + lig) * kVec;
      const bool active = col < d;
      int cur_t = -1;                 // the target of the run held in ycur
      float ycur[kVec];               // its values, rounded in bf16 mode
#pragma unroll
      for (int i = 0; i < kVec; ++i) ycur[i] = 0.f;
      for (int b = beg; b < end; b += kBatch) {
        int s[kBatch], t[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const bool live = b + u < live_end;
          s[u] = live ? src[b + u] : 0;
          t[u] = live ? tgt[b + u] : -1;
        }
        Row<float, kVec> xr[kBatch];
        Row<float, kVec> yr[kBatch];
        bool fresh[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (active && t[u] >= 0) {
            xr[u].load(x + (int64_t)s[u] * d + col);
          } else {
            xr[u].zero();
          }
          // a new run: the first real edge onto its target in the span
          fresh[u] = active && t[u] >= 0 &&
                     t[u] != (u == 0 ? cur_t : t[u - 1]);
          if (fresh[u]) yr[u].load(y + (int64_t)t[u] * d + col);
        }
        if (t[kBatch - 1] >= 0) cur_t = t[kBatch - 1];
        float part[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          // a new run's row, rounded once; else the run's, loaded before
          if (fresh[u]) yr[u].template values<kRound>(ycur);
          float xv[kVec];
          xr[u].template values<kRound>(xv);
          float acc = 0.f;
#pragma unroll
          for (int i = 0; i < kVec; ++i) acc = fmaf(xv[i], ycur[i], acc);
          part[u] = acc;
        }
        if (lanes >= kBatch) {
          // each lane ends with one edge's score: lanes whose bits below
          // lanes / kBatch are 0 write it
          int u;
          float score = reduce_scatter(part, lig, lanes, mask, u);
          const int e = b + u;
          if ((lig & (lanes / kBatch - 1)) == 0 && e < end) {
            if (e >= live_end) score = 0.f;   // a pad slot
            out[e] = c == 0 ? score : out[e] + score;
          }
        } else {
          // narrow rows (lanes < kBatch): each score over the group's
          // lanes, then lane u0 + lig writes edge b + u0 + lig
          for (int off = lanes >> 1; off > 0; off >>= 1) {
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
              part[u] += __shfl_xor_sync(mask, part[u], off);
            }
          }
          for (int u0 = 0; u0 < kBatch; u0 += lanes) {
            const int u = u0 + lig;
            float score = 0.f;
#pragma unroll
            for (int k = 0; k < kBatch; ++k) {
              if (k == u) score = part[k];
            }
            const int e = b + u;
            if (e < end) {
              if (e >= live_end) score = 0.f;   // a pad slot
              out[e] = c == 0 ? score : out[e] + score;
            }
          }
        }
      }
    }
  }
}

template <bool kRound, int kVec>
cudaError_t launch(const void* x, const void* y, const void* src,
                   const void* tgt, const void* ptr, void* out, int num_tgt,
                   int num_slots, int d, int lanes_log2, int chunks,
                   int blocks, cudaStream_t stream) {
  sddmm_kernel<kRound, kVec><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const int*>(src), static_cast<const int*>(tgt),
      static_cast<const int*>(ptr), static_cast<float*>(out), num_tgt,
      num_slots, d, lanes_log2, chunks);
  return cudaGetLastError();
}

template <bool kRound>
cudaError_t dispatch_vec(int vec, const void* x, const void* y,
                         const void* src, const void* tgt, const void* ptr,
                         void* out, int num_tgt, int num_slots, int d,
                         int lanes_log2, int chunks, int blocks,
                         cudaStream_t stream) {
  switch (vec) {
    case 2:
      return launch<kRound, 2>(x, y, src, tgt, ptr, out, num_tgt, num_slots,
                               d, lanes_log2, chunks, blocks, stream);
    case 4:
      return launch<kRound, 4>(x, y, src, tgt, ptr, out, num_tgt, num_slots,
                               d, lanes_log2, chunks, blocks, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

int sddmm(bool exact, const void* x, const void* y, const void* src,
          const void* tgt, const void* ptr, void* out, int num_tgt,
          int num_slots, int d, int vec, int lanes, int chunks, int blocks,
          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // lanes a power of two up to 32; the passes cover every column
  if (d <= 0 || vec <= 0 || d % vec || lanes <= 0 || lanes > 32 ||
      (lanes & (lanes - 1)) || chunks <= 0 ||
      (int64_t)chunks * lanes * vec < d || blocks <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (num_slots <= 0) return (int)cudaSuccess;
  const int lanes_log2 = __builtin_ctz((unsigned)lanes);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(exact ? dispatch_vec<false>(vec, x, y, src, tgt, ptr, out,
                                           num_tgt, num_slots, d, lanes_log2,
                                           chunks, blocks, s)
                     : dispatch_vec<true>(vec, x, y, src, tgt, ptr, out,
                                          num_tgt, num_slots, d, lanes_log2,
                                          chunks, blocks, s));
}

}  // namespace

extern "C" {

// x: [N_src, d] f32; y: [num_tgt, d] f32; both 16-byte aligned. src, tgt:
// [num_slots] int32 (the plan's COO, target-sorted); ptr: [num_tgt + 1]
// int32; out: [num_slots] f32. vec (values per lane: 2 or 4, dividing d),
// lanes (per row, a power of two <= 32), chunks (passes, chunks * lanes *
// vec >= d) and blocks come from spmm_cuda.sddmm_schedule. One launch on
// `stream`, no sync. Returns the cudaError_t of the launch (0 = success;
// cudaErrorInvalidValue for a schedule the kernel does not take).
int sagnn_sddmm_f32(const void* x, const void* y, const void* src,
                    const void* tgt, const void* ptr, void* out, int num_tgt,
                    int num_slots, int d, int vec, int lanes, int chunks,
                    int blocks, int device, void* stream) {
  return sddmm(true, x, y, src, tgt, ptr, out, num_tgt, num_slots, d, vec,
               lanes, chunks, blocks, device, stream);
}

// The same in bf16 mode: the f32 tables are rounded to bf16 as they are
// read; products and sums in f32.
int sagnn_sddmm_bf16(const void* x, const void* y, const void* src,
                     const void* tgt, const void* ptr, void* out,
                     int num_tgt, int num_slots, int d, int vec, int lanes,
                     int chunks, int blocks, int device, void* stream) {
  return sddmm(false, x, y, src, tgt, ptr, out, num_tgt, num_slots, d, vec,
               lanes, chunks, blocks, device, stream);
}

}  // extern "C"
