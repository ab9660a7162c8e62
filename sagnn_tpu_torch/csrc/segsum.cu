// Segment-sum SpMM over target-sorted CSR rows, for Hopper (sm_90a):
// unweighted (K1), weighted (K2), accumulating (K3) and row-folded (K4).
//
// Replaces sagnn_tpu/ops/spmm_pallas.py::_segsum_kernel (launched by
// _segsum_pallas) in each of its modes, with an exact f32 table or a bf16
// table with f32 accumulation:
//
//     out[t, :] (+)= sum_{e in [ptr[t], ptr[t+1])} w[e] * x[src[e], :]  (f32)
//
//   * K1: w = 1, out written (`=`).
//   * K2 (`weighted=True`, spmm_pallas.py:241-242, 258-259: the weights
//     ride the transposed one-hot): f32 weights in the plan's edge order
//     (w[e] belongs to the edge whose source id is src[e]). The forward of
//     the weighted propagation (edge_norm, edge_dropout_keep, edge
//     attention) and the backward of both it and the SDDMM
//     (csrc/sddmm.cu).
//   * K3 (`zero_init=True`, spmm_pallas.py:285-287, 327-334): one launch
//     per source shard or edge slice adds that part's partial sum into the
//     output, `out[t] = out[t] + partial`. The partial is summed from zero
//     in registers exactly as K1 sums, then added once: the rounding order
//     of JAX's `acc + partial` (spmm_pallas.py:433, 635). No atomics. A row
//     with no edges in the part is left untouched (zero_init: blocks a
//     slice never visits stay as they were). The caller offsets x to the
//     shard's window, so the kernel sees shard-local ids only.
//   * K4 (`folded=True`, spmm_pallas.py:233-239, 263-266): x is the
//     [N/2, 2D] row-folded view of the table; edge e reads row
//     src[e] >> 1 and its half src[e] & 1. On the TPU the fold removed the
//     lane padding of the [N, 64] relayout copy. Here each lane loads only
//     the D-wide half it needs, which is the same address as row src[e] of
//     the [N, D] table: K4 reads the same bytes as K1 and exists so that
//     the flag runs the mode it names, counted under its own name.
//   * K3 with K4 (folded + accumulate) is the 1M-user flagship's mode, the
//     fold inside each shard's window, as JAX does at spmm_pallas.py:612-634.
//   * K6, the ring SpMM's bucket aggregation (replaces
//     sagnn_tpu/parallel/edge_partition.py::ring_spmm_pallas_arrays, whose
//     every bucket calls _segsum_pallas(zero_init=True, weights=..., exact
//     =True), edge_partition.py:408-471): the accumulating mode on an f32
//     table, unweighted (K3's `sagnn_segsum_acc_f32`) or weighted
//     (`sagnn_wsegsum_acc_f32`, K2's and K3's flags, for sym_sqrt edge
//     norms). Per model rank p and ring step s the caller launches it once
//     on bucket (p, q = (p - s) mod P): x is the source block the rank
//     holds at that step, src the bucket's block-local ids in target order,
//     out the rank's f32 accumulator. Empty buckets launch too (every row
//     returns at once), so the launch count is P*P per hop. The caller
//     counts these launches under K6's own names. What bounds it: the
//     hop's unique bytes (each source block once, the ids and weights, the
//     row pointers, each output row once); the schedule adds a read and a
//     write of every touched output row per bucket and the ring's P - 1
//     block copies per rank, made by the caller on a side stream so that
//     they overlap the previous bucket's launch.
//   * P2, the ablated segment-sum probe (`kAblate`; replaces
//     scripts/probe_overhead.py::ablated_segsum, whose kernel
//     `ablate_kernel` runs _segsum_kernel's grid and BlockSpecs with the
//     one-hot MXU dot replaced by a column sum): K1's walk, id broadcast,
//     unroll and row loads with the adds removed. Every edge's row is still
//     loaded; the loaded bits are folded by XOR into kUnroll words that are
//     stored only where `sink` is not null, which the caller keeps null, so
//     the compiler cannot drop a load. Each row then writes its last
//     source's row, out[t] = x[src[ptr[t+1] - 1]] (zeros for an empty row),
//     which a plain gather checks exactly. Beside K1 and P1
//     (csrc/probes.cu) on the same edge stream it splits K1's time between
//     the row loads, the adds and the serial row walk.
// The flags compose in the code; only the combinations the port launches
// are instantiated below.
//
// The TPU kernel sums with a one-hot matmul per chunk of edges only to
// avoid the TPU's serialized scatter. Here the edges are already sorted by
// target, so each target row is a contiguous range [ptr[t], ptr[t+1]) and
// one warp owns one row: no one-hot, no atomics, every row written once
// (K1/K2/K4 write zeros to rows without edges; K3 skips them). Each lane
// keeps kUnroll partial sums (the j-th edge of each group of 32 goes to sum
// j % kUnroll) and adds them by a fixed tree at the end, so the result is
// deterministic.
//
// What bounds it: memory. Per hop the kernel reads E gathered rows of
// D values (E*D*4 bytes in f32, half that in bf16), E source ids, the row
// pointers, in K2 also E f32 weights (4 bytes per edge more), and writes
// num_tgt*D*4 bytes; K3 reads and writes the output row once per (part,
// row) pair that has edges, so S source shards cost up to S times K1's
// output traffic. It does one add (K2: one multiply-add) per gathered
// value, far below the card's arithmetic rate. At gowalla scale the
// source table is 10-13 MB in f32 and fits in the 50 MB L2, so repeated
// row gathers can be served from L2; a 131,072-row shard of a 64-wide f32
// table (33.5 MB) fits too, where the flagship's 786k-row item table
// (201 MB) does not. The unique bytes (table once, ids, weights, pointers,
// output) are the floor.
//
// What the design does about it:
//   * each lane owns two adjacent columns (float2 / bf16x2), so at D = 64
//     one warp reads a whole 256-byte f32 row (128 bytes in bf16) in one
//     coalesced load;
//   * the warp loads 32 source ids (and in K2 their 32 weights) at once
//     and broadcasts them with __shfl_sync, and the edge loop is unrolled
//     by kUnroll so that many independent row loads are in flight before
//     the adds consume them, into kUnroll independent sums (no serial
//     chain of adds);
//   * K2, K3 and K4 are template flags of the same kernel, so K1 compiles
//     to the code it had and a later edge-balanced split of long rows
//     fixes every mode;
//   * offsets are 64-bit ((int64_t)src[e] * d).
// Degree skew (Zipf item popularity) makes some item rows thousands of
// edges long, walked serially by one warp; an edge-balanced split is left
// for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kUnroll = 8;
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

// Row `s` of the table: x + s*d in the [N, D] view; in the folded view
// (kFolded, x is [N/2, 2D]) half `s & 1` of row `s >> 1`.
template <bool kFolded, typename T>
__device__ __forceinline__ const T* table_row(const T* __restrict__ x, int s,
                                              int d) {
  if constexpr (kFolded) {
    return x + (int64_t)(s >> 1) * (2 * d) + (s & 1) * d;
  } else {
    return x + (int64_t)s * d;
  }
}

// One warp per target row; lane `lane` owns column pairs lane, lane+32, ...
// kWeighted: each gathered row is scaled by its edge's f32 weight w[e].
// kAccumulate: the row's sum is added to out (rows without edges are not
// touched). kFolded: x is the row-folded [N/2, 2D] view. kAblate (P2): the
// walk and the loads without the adds; `sink` is read only in this mode.
template <typename T, bool kWeighted, bool kAccumulate, bool kFolded,
          bool kAblate = false>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
segsum_rows_kernel(const T* __restrict__ x, const float* __restrict__ w,
                   const int* __restrict__ src, const int* __restrict__ ptr,
                   float* __restrict__ out, int num_tgt, int d,
                   unsigned* __restrict__ sink) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= num_tgt) return;  // whole warp leaves together
  const int beg = ptr[row];
  const int end = ptr[row + 1];
  if (kAccumulate && beg == end) return;  // zero_init: left as it was
  const int pairs = d >> 1;
  float2* out_row = reinterpret_cast<float2*>(out + (int64_t)row * d);

  for (int c0 = 0; c0 < pairs; c0 += 32) {
    const int c = c0 + lane;
    const bool active = c < pairs;
    // kUnroll partial sums, combined by a fixed tree at the end: the
    // rounding error of a long row is about sqrt(kUnroll) times smaller
    // than with one running sum, and the order is still fixed
    float2 acc[kUnroll];
    unsigned bits[kUnroll];  // P2's sink of the loaded values
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      acc[u] = make_float2(0.f, 0.f);
      bits[u] = 0u;
    }
    for (int base = beg; base < end; base += 32) {
      const int n = min(32, end - base);  // warp-uniform
      const int my_src = lane < n ? src[base + lane] : 0;
      const float my_w = kWeighted && lane < n ? w[base + lane] : 0.f;
      int j = 0;
      for (; j + kUnroll <= n; j += kUnroll) {
        float2 v[kUnroll];
        float wt[kUnroll];  // read only in K2
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int s = __shfl_sync(kFullMask, my_src, j + u);
          if constexpr (kWeighted) {
            wt[u] = __shfl_sync(kFullMask, my_w, j + u);
          }
          v[u] = active ? load_pair(table_row<kFolded>(x, s, d), c)
                        : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if constexpr (kAblate) {
            bits[u] ^= __float_as_uint(v[u].x) ^ __float_as_uint(v[u].y);
          } else if constexpr (kWeighted) {
            acc[u].x = fmaf(wt[u], v[u].x, acc[u].x);
            acc[u].y = fmaf(wt[u], v[u].y, acc[u].y);
          } else {
            acc[u].x += v[u].x;
            acc[u].y += v[u].y;
          }
        }
      }
      // the tail (< kUnroll edges): edge j + u goes to sum u, with a
      // static index so the sums stay in registers
#pragma unroll
      for (int u = 0; u < kUnroll - 1; ++u) {
        if (j + u < n) {  // warp-uniform
          const int s = __shfl_sync(kFullMask, my_src, j + u);
          float wt = 1.f;
          if constexpr (kWeighted) wt = __shfl_sync(kFullMask, my_w, j + u);
          if (active) {
            const float2 v = load_pair(table_row<kFolded>(x, s, d), c);
            if constexpr (kAblate) {
              bits[u] ^= __float_as_uint(v.x) ^ __float_as_uint(v.y);
            } else if constexpr (kWeighted) {
              acc[u].x = fmaf(wt, v.x, acc[u].x);
              acc[u].y = fmaf(wt, v.y, acc[u].y);
            } else {
              acc[u].x += v.x;
              acc[u].y += v.y;
            }
          }
        }
      }
    }
#pragma unroll
    for (int half = kUnroll / 2; half > 0; half /= 2) {
#pragma unroll
      for (int u = 0; u < half; ++u) {
        acc[u].x += acc[u + half].x;
        acc[u].y += acc[u + half].y;
      }
    }
    if constexpr (kAblate) {
#pragma unroll
      for (int u = 1; u < kUnroll; ++u) bits[0] ^= bits[u];
      if (sink != nullptr && active) sink[(int64_t)row * 32 + lane] = bits[0];
      if (active) {
        out_row[c] = beg < end
            ? load_pair(table_row<kFolded>(x, src[end - 1], d), c)
            : make_float2(0.f, 0.f);
      }
    } else if (active) {
      if constexpr (kAccumulate) {
        // JAX's `acc + partial`: one rounding of the finished partial
        const float2 o = out_row[c];
        out_row[c] = make_float2(o.x + acc[0].x, o.y + acc[0].y);
      } else {
        out_row[c] = acc[0];
      }
    }
  }
}

template <typename T, bool kWeighted, bool kAccumulate = false,
          bool kFolded = false, bool kAblate = false>
int launch(const void* x, const void* w, const void* src, const void* ptr,
           void* out, int num_tgt, int d, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (num_tgt <= 0) return (int)cudaSuccess;
  const dim3 grid((num_tgt + kWarpsPerBlock - 1) / kWarpsPerBlock);
  segsum_rows_kernel<T, kWeighted, kAccumulate, kFolded, kAblate>
      <<<grid, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(x), static_cast<const float*>(w),
          static_cast<const int*>(src), static_cast<const int*>(ptr),
          static_cast<float*>(out), num_tgt, d, nullptr);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: [N_src, d] f32; src: [E] int32; ptr: [num_tgt + 1] int32;
// out: [num_tgt, d] f32. d even. Launches on `stream`, does not sync.
// Returns the cudaError_t of the launch (0 = success).
int sagnn_segsum_f32(const void* x, const void* src, const void* ptr,
                     void* out, int num_tgt, int d, int device,
                     void* stream) {
  return launch<float, false>(x, nullptr, src, ptr, out, num_tgt, d, device,
                             stream);
}

// The same with x: [N_src, d] bf16, accumulated in f32.
int sagnn_segsum_bf16(const void* x, const void* src, const void* ptr,
                      void* out, int num_tgt, int d, int device,
                      void* stream) {
  return launch<__nv_bfloat16, false>(x, nullptr, src, ptr, out, num_tgt, d,
                                     device, stream);
}

// K2: the same with per-edge weights w: [len(src)] f32 in the plan's edge
// order, out[t] = sum_e w[e] * x[src[e]].
int sagnn_wsegsum_f32(const void* x, const void* w, const void* src,
                      const void* ptr, void* out, int num_tgt, int d,
                      int device, void* stream) {
  return launch<float, true>(x, w, src, ptr, out, num_tgt, d, device, stream);
}

// K2 with x: [N_src, d] bf16 (the weights stay f32), accumulated in f32.
int sagnn_wsegsum_bf16(const void* x, const void* w, const void* src,
                       const void* ptr, void* out, int num_tgt, int d,
                       int device, void* stream) {
  return launch<__nv_bfloat16, true>(x, w, src, ptr, out, num_tgt, d, device,
                                     stream);
}

// K3: K1's arguments, with out read and written: out[t] += the row's sum
// for every row with edges; rows without edges are left untouched. x is
// the part's window of the table (ids local to it).
int sagnn_segsum_acc_f32(const void* x, const void* src, const void* ptr,
                         void* out, int num_tgt, int d, int device,
                         void* stream) {
  return launch<float, false, true>(x, nullptr, src, ptr, out, num_tgt, d,
                                    device, stream);
}

int sagnn_segsum_acc_bf16(const void* x, const void* src, const void* ptr,
                          void* out, int num_tgt, int d, int device,
                          void* stream) {
  return launch<__nv_bfloat16, false, true>(x, nullptr, src, ptr, out,
                                            num_tgt, d, device, stream);
}

// K4: K1's arguments with x the row-folded [N_src/2, 2d] view (N_src
// even); d is the logical row width.
int sagnn_segsum_fold_f32(const void* x, const void* src, const void* ptr,
                          void* out, int num_tgt, int d, int device,
                          void* stream) {
  return launch<float, false, false, true>(x, nullptr, src, ptr, out,
                                           num_tgt, d, device, stream);
}

int sagnn_segsum_fold_bf16(const void* x, const void* src, const void* ptr,
                           void* out, int num_tgt, int d, int device,
                           void* stream) {
  return launch<__nv_bfloat16, false, false, true>(x, nullptr, src, ptr, out,
                                                   num_tgt, d, device,
                                                   stream);
}

// K3 + K4: accumulate from the folded view of the part's window.
int sagnn_segsum_fold_acc_f32(const void* x, const void* src,
                              const void* ptr, void* out, int num_tgt, int d,
                              int device, void* stream) {
  return launch<float, false, true, true>(x, nullptr, src, ptr, out, num_tgt,
                                          d, device, stream);
}

int sagnn_segsum_fold_acc_bf16(const void* x, const void* src,
                               const void* ptr, void* out, int num_tgt,
                               int d, int device, void* stream) {
  return launch<__nv_bfloat16, false, true, true>(x, nullptr, src, ptr, out,
                                                  num_tgt, d, device, stream);
}

// K2 + K3 (K6's weighted ring bucket): K2's arguments with out read and
// written, out[t] += sum_e w[e] * x[src[e]] for every row with edges; rows
// without edges are untouched.
int sagnn_wsegsum_acc_f32(const void* x, const void* w, const void* src,
                          const void* ptr, void* out, int num_tgt, int d,
                          int device, void* stream) {
  return launch<float, true, true>(x, w, src, ptr, out, num_tgt, d, device,
                                   stream);
}

// P2: K1's arguments; out[t] = x[src[ptr[t+1] - 1]] for every row with
// edges (each of its edges' rows loaded, none added), zeros for the others.
int sagnn_segsum_ablate_f32(const void* x, const void* src, const void* ptr,
                            void* out, int num_tgt, int d, int device,
                            void* stream) {
  return launch<float, false, false, false, true>(x, nullptr, src, ptr, out,
                                                  num_tgt, d, device, stream);
}

int sagnn_segsum_ablate_bf16(const void* x, const void* src, const void* ptr,
                             void* out, int num_tgt, int d, int device,
                             void* stream) {
  return launch<__nv_bfloat16, false, false, false, true>(
      x, nullptr, src, ptr, out, num_tgt, d, device, stream);
}

const char* sagnn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
