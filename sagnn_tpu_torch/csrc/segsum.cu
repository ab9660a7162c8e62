// Segment-sum SpMM over target-sorted CSR rows, for Hopper (sm_90a):
// unweighted (K1), weighted (K2), accumulating (K3) and row-folded (K4),
// the ring buckets' accumulating modes (K6) and the ablated probe (P2), on
// one edge-balanced, deterministic schedule.
//
// Replaces sagnn_tpu/ops/spmm_pallas.py::_segsum_kernel (launched by
// _segsum_pallas) in each of its modes, with an exact f32 table or a bf16
// table with f32 accumulation:
//
//     out[t, :] (+)= sum_{e in [ptr[t], ptr[t+1])} w[e] * x[src[e], :]  (f32)
//
//   * K1: w = 1, out written (`=`); a row without edges gets zeros.
//   * K2 (`weighted=True`, spmm_pallas.py:241-242, 258-259: the weights
//     ride the transposed one-hot): f32 weights in the plan's edge order
//     (w[e] belongs to the edge whose source id is src[e]). The forward of
//     the weighted propagation (edge_norm, edge_dropout_keep, edge
//     attention) and the backward of both it and the SDDMM
//     (csrc/sddmm.cu).
//   * K3 (`zero_init=True`, spmm_pallas.py:285-287, 327-334): one launch
//     per source shard or edge slice adds that part's partial sum into the
//     output, `out[t] = out[t] + partial`. Each row's partial is finished
//     first and then added once: the rounding order of JAX's
//     `acc + partial` (spmm_pallas.py:433, 635). A row with no edges in
//     the part is left untouched (zero_init: blocks a slice never visits
//     stay as they were). The caller offsets x to the shard's window, so
//     the kernel sees shard-local ids only.
//   * K4 (`folded=True`, spmm_pallas.py:233-239, 263-266): x is the
//     [N/2, 2D] row-folded view of the table; edge e reads row
//     src[e] >> 1 and its half src[e] & 1, which is the address of row
//     src[e] of the [N, D] table. K4 runs K1's schedule on the same bytes,
//     so it gives K1's bits; it exists so that the flag runs the mode it
//     names, counted under its own name.
//   * K3 with K4 (folded + accumulate) is the 1M-user flagship's mode, the
//     fold inside each shard's window, as JAX does at spmm_pallas.py:612-634.
//   * K6, the ring SpMM's bucket aggregation (replaces
//     sagnn_tpu/parallel/edge_partition.py::ring_spmm_pallas_arrays, whose
//     every bucket calls _segsum_pallas(zero_init=True, weights=..., exact
//     =True), edge_partition.py:408-471): the accumulating mode on an f32
//     table, unweighted (K3's `sagnn_segsum_acc_f32`) or weighted
//     (`sagnn_wsegsum_acc_f32`, K2's and K3's flags, for sym_sqrt edge
//     norms), launched once per (model rank, ring step) on that step's
//     bucket: x the source block the rank holds, src its block-local ids,
//     out the rank's f32 accumulator. An empty bucket's launch returns at
//     once.
//   * P2, the ablated segment-sum probe (`kAblate`; replaces
//     scripts/probe_overhead.py::ablated_segsum, whose kernel
//     `ablate_kernel` runs _segsum_kernel's grid with the one-hot MXU dot
//     replaced by a column sum): K1's schedule, walk and row loads with
//     the adds and the combine of split rows removed. The loaded bits are
//     XOR-folded into one word per lane, stored only where `sink` is not
//     null (the caller keeps it null), so the compiler cannot drop a load.
//     Each row writes its last source's row, out[t] = x[src[ptr[t+1] - 1]]
//     (zeros for an empty row), which a plain gather checks exactly.
//
// The schedule (merge path). A launch's work is T row ends and E edges,
// E = ptr[T] - ptr[0] read on the card (ptr[0] > 0 for a shard or a
// slice; pad slots after ptr[T] are never read). Walked in CSR order, row
// t's edges are followed by its end: item number t + (ptr[t] - ptr[0]) is
// its first edge (or its end, if it has none). The T + E items are cut
// into pieces of kPieceItems, and one warp takes one piece at a time with
// a grid stride over a persistent grid (sized by the caller from the SM
// count). A warp finds where its piece starts and ends by a 16-ary search
// of ptr (each half-warp searches one end, 15 probes per step), stages
// the piece's ids (K2: and weights) and row pointers in shared memory, and
// walks its edges in order with kUnroll row loads in flight (a full batch
// loads with no guard, so its loads issue back to back); each lane owns
// two adjacent columns (float2 / bf16x2), so at D = 64 one instruction
// loads a whole 256-byte f32 row (128 bytes in bf16), and the walk goes
// on across row ends. Every warp thus walks at most kPieceItems items per
// piece, whatever the degree skew.
//
// Rows split between pieces, deterministically. A row whose items lie in
// more than one piece is summed in parts: the piece where it starts
// stores its part in slot 1 of its scratch, each later piece in slot 0
// (2 x D floats per piece). After storing, a warp fences
// (__threadfence) and counts its arrival on the row's counter (the
// counter of the piece where the row starts); the warp that arrives last
// reads the parts through L2 (__ldcg), sums them in piece order into
// kUnroll interleaved sums added by a fixed tree, writes the row (K3:
// adds it once) and sets the counter back to 0, so the counters are clean
// for the next launch (the pattern of the CUDA sample
// threadFenceReduction). Which warp arrives last may vary; the sum's
// order never does: it depends on kPieceItems and the plan alone, not on
// the grid or the card. Rows inside one piece are summed in edge order.
// No float atomics, every row written once.
//
// What bounds it: memory. Per hop the kernel reads E gathered rows of D
// values (E*D*4 bytes in f32, half that in bf16), E source ids, the row
// pointers, in K2 also E f32 weights, and writes T*D*4 bytes; K3 reads
// and writes each row with edges once per part, so S source shards cost
// up to S times K1's output traffic. The unique bytes (the table once,
// ids, weights, pointers, the output) are the floor; at gowalla scale
// the table fits in the 50 MB L2, so repeated gathers can be served from
// there. One add (K2: multiply-add) per gathered value is far below the
// card's arithmetic rate. What the design does about it: each warp keeps
// kUnroll row loads in flight, the card holds kBlocksPerSm blocks of
// kWarpsPerBlock warps per SM, and the pieces balance the bytes across
// all of them, so no single long row paces a launch; offsets into the
// table are 64-bit ((int64_t)src[e] * d), edges are indexed in int32.
// What is left: a piece is a chain of dependent steps (the search, the
// staging, kPieceItems / kUnroll batches of loads), so a launch with
// fewer pieces than the card has warps (a ring bucket, a shard) takes
// about one piece's time, and a full launch is bound by the kUnroll rows
// each warp keeps in flight.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

// The schedule's constants come from `ops/spmm_cuda.py` (PIECE_ITEMS,
// WARPS_PER_BLOCK, BLOCKS_PER_SM), which sizes the grid and the scratch
// from them; `ops/_build.py` passes them to nvcc as -D defines.
#if !defined(SAGNN_PIECE_ITEMS) || !defined(SAGNN_WARPS_PER_BLOCK) || \
    !defined(SAGNN_BLOCKS_PER_SM)
#error "build with sagnn_tpu_torch/ops/_build.py, which defines the schedule"
#endif
constexpr int kPieceItems = SAGNN_PIECE_ITEMS;  // row ends + edges per piece
constexpr int kWarpsPerBlock = SAGNN_WARPS_PER_BLOCK;
constexpr int kBlocksPerSm = SAGNN_BLOCKS_PER_SM;  // the grid's blocks per SM
constexpr int kUnroll = 8;         // row loads in flight per warp
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

__device__ __forceinline__ float2* pair_row(float* base, int64_t row, int d) {
  return reinterpret_cast<float2*>(base + row * d);
}

// The merge path's row coordinate at item `diag`: the number of rows whose
// end lies before it, #{t : t + 1 + (ptr[t+1] - ptr0) <= diag}. Each
// half-warp searches its own `diag` (the whole warp calls this), 16-ary:
// lanes 0-14 of the half probe 15 points that cut [lo, hi) into 16 parts.
__device__ __forceinline__ int rows_before(const int* __restrict__ ptr,
                                           int ptr0, int num_tgt,
                                           int num_edges, int64_t diag) {
  const int lane = threadIdx.x & 31;
  const int sub = lane & 15;
  int lo = diag > num_edges ? (int)(diag - num_edges) : 0;
  int hi = diag < num_tgt ? (int)diag : num_tgt;
  while (__any_sync(kFullMask, lo < hi)) {
    const int64_t n = hi - lo;
    const int q = lo + (int)((n * (sub + 1)) >> 4);
    const bool before = lo < hi && sub < 15 &&
        (int64_t)(ptr[q + 1] - ptr0) + q + 1 <= diag;
    const unsigned ballot = __ballot_sync(kFullMask, before);
    const int c = __popc((ballot >> (lane & 16)) & 0xffffu);
    if (lo < hi) {
      const int new_lo = c == 0 ? lo : lo + (int)((n * c) >> 4) + 1;
      hi = c == 15 ? hi : lo + (int)((n * (c + 1)) >> 4);
      lo = new_lo;
    }
  }
  return lo;
}

// kWeighted: each gathered row is scaled by its edge's f32 weight w[e].
// kAccumulate: each row's sum is added to out (rows without edges are not
// touched). kFolded: x is the row-folded [N/2, 2D] view. kAblate (P2): the
// walk and the loads without the adds; `sink` is read only in this mode.
// scratch: 2 * d floats per piece; counters: one per piece, all 0.
template <typename T, bool kWeighted, bool kAccumulate, bool kFolded,
          bool kAblate = false>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, kBlocksPerSm)
segsum_pieces_kernel(const T* __restrict__ x, const float* __restrict__ w,
                     const int* __restrict__ src, const int* __restrict__ ptr,
                     float* __restrict__ out, int num_tgt, int d,
                     float* __restrict__ scratch,
                     unsigned* __restrict__ counters,
                     unsigned* __restrict__ sink) {
  __shared__ int s_src[kWarpsPerBlock][kPieceItems];
  __shared__ float s_w[kWarpsPerBlock][kWeighted ? kPieceItems : 1];
  // row pointers (relative to ptr0) of the piece's rows, and of the row
  // after its last, which the row split at its end needs
  __shared__ int s_ptr[kWarpsPerBlock][kPieceItems + 2];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int* const ids = s_src[warp];
  float* const wts = s_w[warp];
  int* const rp = s_ptr[warp];

  const int ptr0 = ptr[0];
  const int num_edges = ptr[num_tgt] - ptr0;
  if (kAccumulate && num_edges == 0) return;  // every row left as it was
  const int64_t items = (int64_t)num_tgt + num_edges;
  const int64_t pieces = (items + kPieceItems - 1) / kPieceItems;
  const int pairs = d >> 1;
  unsigned bits = 0u;  // P2's sink of the loaded values

  for (int64_t p = (int64_t)blockIdx.x * kWarpsPerBlock + warp; p < pieces;
       p += (int64_t)gridDim.x * kWarpsPerBlock) {
    // lanes 0-15 find the piece's start, lanes 16-31 its end
    const int64_t lo_item = p * kPieceItems;
    const int64_t hi_item =
        lo_item + kPieceItems < items ? lo_item + kPieceItems : items;
    const int found = rows_before(ptr, ptr0, num_tgt, num_edges,
                                  lane < 16 ? lo_item : hi_item);
    const int row0 = __shfl_sync(kFullMask, found, 0);
    const int row1 = __shfl_sync(kFullMask, found, 16);
    const int edge0 = (int)(lo_item - row0);  // relative to ptr0
    const int edge1 = (int)(hi_item - row1);
    const int nr = row1 - row0;  // rows that end in this piece
    const int ne = edge1 - edge0;  // edges in this piece
    const int np = min(nr + 2, num_tgt + 1 - row0);

    __syncwarp();  // the previous piece is done with the staging
    for (int k = lane; k < ne; k += 32) {
      ids[k] = src[ptr0 + edge0 + k];
      if constexpr (kWeighted) wts[k] = w[ptr0 + edge0 + k];
    }
    for (int k = lane; k < np; k += 32) rp[k] = ptr[row0 + k] - ptr0;
    __syncwarp();

    // head: row0 began in an earlier piece; tail: row1 begins here and
    // goes on into the next (a row inside one piece is neither)
    const bool head = edge0 > rp[0];
    const bool tail = row1 < num_tgt && edge1 > rp[nr] && (nr > 0 || !head);

    for (int c0 = 0; c0 < pairs; c0 += 32) {
      const int c = c0 + lane;
      const bool active = c < pairs;
      float2 acc = make_float2(0.f, 0.f);
      float2 last = make_float2(0.f, 0.f);  // P2: the last loaded row
      float2 prev = make_float2(0.f, 0.f);  // K3: out[row], loaded early
      int r = 0;  // rows of this piece ended so far
      // the piece-local edge at which row r ends
      int stop = nr > 0 ? rp[1] - edge0 : INT_MAX;

      // K3: load out[row0 + r] as soon as row r is the current row, so
      // the load overlaps the row's gathers
      auto fetch = [&](int k) {
        if constexpr (kAccumulate && !kAblate) {
          if (active && k < nr && !(k == 0 && head) && rp[k + 1] > rp[k]) {
            prev = pair_row(out, (int64_t)row0 + k, d)[c];
          }
        }
      };
      // row r ends: a row inside the piece is written, the end of a split
      // row (r == 0 && head) goes to scratch slot 0
      auto flush = [&](int k) {
        const int64_t row = (int64_t)row0 + k;
        if constexpr (kAblate) {
          const int beg = rp[k], end = rp[k + 1];
          float2 v = make_float2(0.f, 0.f);
          if (end > edge0 && end > beg) {
            v = last;  // its last edge was loaded in this piece
          } else if (end > beg && active) {
            v = load_pair(table_row<kFolded>(x, src[ptr0 + end - 1], d), c);
          }
          if (active) pair_row(out, row, d)[c] = v;
        } else if (k == 0 && head) {
          if (active) pair_row(scratch, 2 * p, d)[c] = acc;
        } else if (active) {
          if constexpr (kAccumulate) {
            // JAX's `acc + partial`: one rounding of the finished sum
            if (rp[k + 1] > rp[k]) {
              pair_row(out, row, d)[c] =
                  make_float2(prev.x + acc.x, prev.y + acc.y);
            }
          } else {
            pair_row(out, row, d)[c] = acc;
          }
        }
        acc = make_float2(0.f, 0.f);
      };

      // edge e of the piece: the rows that end before it, then its add
      auto consume = [&](int e, float2 v, float wt) {
        while (e == stop) {  // rows ending before edge e (empty too)
          flush(r);
          ++r;
          stop = r < nr ? rp[r + 1] - edge0 : INT_MAX;
          fetch(r);
        }
        if constexpr (kAblate) {
          bits ^= __float_as_uint(v.x) ^ __float_as_uint(v.y);
          last = v;
        } else if constexpr (kWeighted) {
          acc.x = fmaf(wt, v.x, acc.x);
          acc.y = fmaf(wt, v.y, acc.y);
        } else {
          acc.x += v.x;
          acc.y += v.y;
        }
      };

      fetch(0);
      // full batches load without guards: an inactive lane (c >= pairs)
      // reads column 0 and never stores what it sums
      const int cl = active ? c : 0;
      int e0 = 0;
      for (; e0 + kUnroll <= ne; e0 += kUnroll) {
        float2 v[kUnroll];
        float wt[kUnroll];  // read only in K2
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          wt[u] = kWeighted ? wts[e0 + u] : 0.f;
          v[u] = load_pair(table_row<kFolded>(x, ids[e0 + u], d), cl);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) consume(e0 + u, v[u], wt[u]);
      }
      if (e0 < ne) {  // the last, partial batch
        float2 v[kUnroll];
        float wt[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          v[u] = make_float2(0.f, 0.f);
          wt[u] = 0.f;
          if (e0 + u < ne) {
            wt[u] = kWeighted ? wts[e0 + u] : 0.f;
            v[u] = load_pair(table_row<kFolded>(x, ids[e0 + u], d), cl);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (e0 + u < ne) consume(e0 + u, v[u], wt[u]);
        }
      }
      for (; r < nr; ++r) {  // rows ending after the piece's last edge
        flush(r);
        fetch(r + 1);
      }
      if constexpr (!kAblate) {
        // the part of a row that goes on: slot 1 where it began, slot 0
        // of a piece that the row crosses whole
        if (active && (tail || (head && nr == 0))) {
          pair_row(scratch, 2 * p + (tail ? 1 : 0), d)[c] = acc;
        }
      }
    }

    if constexpr (!kAblate) {
      // each split row this piece holds a part of: count the arrival on
      // the counter of the row's first piece; the last to arrive sums the
      // parts in piece order
      for (int k = 0; k < 2; ++k) {
        if (k == 0 ? !head : !tail) continue;  // warp-uniform
        const int rr = k == 0 ? 0 : nr;        // the row's index in rp
        const int64_t row = (int64_t)row0 + rr;
        const int64_t first = (row + rp[rr]) / kPieceItems;
        const int64_t lastp = (row + rp[rr + 1]) / kPieceItems;
        __threadfence();  // this lane's part is visible to every SM
        __syncwarp();
        unsigned arrived = 0u;
        if (lane == 0) arrived = atomicAdd(&counters[first], 1u);
        arrived = __shfl_sync(kFullMask, arrived, 0);
        if (arrived != (unsigned)(lastp - first)) continue;
        __threadfence();
        if (lane == 0) counters[first] = 0u;  // clean for the next launch
        const int n = (int)(lastp - first + 1);
        for (int c0 = 0; c0 < pairs; c0 += 32) {
          const int c = c0 + lane;
          if (c >= pairs) continue;
          float2 s[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) s[u] = make_float2(0.f, 0.f);
          for (int j0 = 0; j0 < n; j0 += kUnroll) {
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
              const int j = j0 + u;
              if (j < n) {
                // the first piece's part is its slot 1, the others' slot 0
                const float2 v = __ldcg(
                    pair_row(scratch, 2 * (first + j) + (j == 0 ? 1 : 0), d)
                    + c);
                s[u].x += v.x;
                s[u].y += v.y;
              }
            }
          }
#pragma unroll
          for (int half = kUnroll / 2; half > 0; half /= 2) {
#pragma unroll
            for (int u = 0; u < half; ++u) {
              s[u].x += s[u + half].x;
              s[u].y += s[u + half].y;
            }
          }
          float2* o = pair_row(out, row, d) + c;
          if constexpr (kAccumulate) {
            const float2 before = *o;
            *o = make_float2(before.x + s[0].x, before.y + s[0].y);
          } else {
            *o = s[0];
          }
        }
      }
    }
  }
  if constexpr (kAblate) {
    if (sink != nullptr) {
      sink[((int64_t)blockIdx.x * kWarpsPerBlock + warp) * 32 + lane] = bits;
    }
  }
}

template <typename T, bool kWeighted, bool kAccumulate = false,
          bool kFolded = false, bool kAblate = false>
int launch(const void* x, const void* w, const void* src, const void* ptr,
           void* out, int num_tgt, int d, void* scratch, void* counters,
           int blocks, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (num_tgt <= 0 || blocks <= 0) return (int)cudaSuccess;
  segsum_pieces_kernel<T, kWeighted, kAccumulate, kFolded, kAblate>
      <<<blocks, kWarpsPerBlock * 32, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(x), static_cast<const float*>(w),
          static_cast<const int*>(src), static_cast<const int*>(ptr),
          static_cast<float*>(out), num_tgt, d,
          static_cast<float*>(scratch), static_cast<unsigned*>(counters),
          nullptr);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Every entry: x: [N_src, d] (f32, or bf16 accumulated in f32); src: [E]
// int32; ptr: [num_tgt + 1] int32; out: [num_tgt, d] f32; d even.
// scratch: 2 * d floats and counters: one unsigned int, all 0, for each
// piece of the largest launch, ceil((num_tgt + len(src)) / piece_items);
// blocks: the grid (any count >= 1 gives the same result). Launches on
// `stream`, does not sync. Returns the cudaError_t of the launch
// (0 = success).
int sagnn_segsum_f32(const void* x, const void* src, const void* ptr,
                     void* out, int num_tgt, int d, void* scratch,
                     void* counters, int blocks, int device, void* stream) {
  return launch<float, false>(x, nullptr, src, ptr, out, num_tgt, d, scratch,
                              counters, blocks, device, stream);
}

int sagnn_segsum_bf16(const void* x, const void* src, const void* ptr,
                      void* out, int num_tgt, int d, void* scratch,
                      void* counters, int blocks, int device, void* stream) {
  return launch<__nv_bfloat16, false>(x, nullptr, src, ptr, out, num_tgt, d,
                                      scratch, counters, blocks, device,
                                      stream);
}

// K2: the same with per-edge weights w: [len(src)] f32 in the plan's edge
// order, out[t] = sum_e w[e] * x[src[e]].
int sagnn_wsegsum_f32(const void* x, const void* w, const void* src,
                      const void* ptr, void* out, int num_tgt, int d,
                      void* scratch, void* counters, int blocks, int device,
                      void* stream) {
  return launch<float, true>(x, w, src, ptr, out, num_tgt, d, scratch,
                             counters, blocks, device, stream);
}

int sagnn_wsegsum_bf16(const void* x, const void* w, const void* src,
                       const void* ptr, void* out, int num_tgt, int d,
                       void* scratch, void* counters, int blocks, int device,
                       void* stream) {
  return launch<__nv_bfloat16, true>(x, w, src, ptr, out, num_tgt, d, scratch,
                                     counters, blocks, device, stream);
}

// K3: K1's arguments, with out read and written: out[t] += the row's sum
// for every row with edges; rows without edges are left untouched. x is
// the part's window of the table (ids local to it).
int sagnn_segsum_acc_f32(const void* x, const void* src, const void* ptr,
                         void* out, int num_tgt, int d, void* scratch,
                         void* counters, int blocks, int device,
                         void* stream) {
  return launch<float, false, true>(x, nullptr, src, ptr, out, num_tgt, d,
                                    scratch, counters, blocks, device,
                                    stream);
}

int sagnn_segsum_acc_bf16(const void* x, const void* src, const void* ptr,
                          void* out, int num_tgt, int d, void* scratch,
                          void* counters, int blocks, int device,
                          void* stream) {
  return launch<__nv_bfloat16, false, true>(x, nullptr, src, ptr, out,
                                            num_tgt, d, scratch, counters,
                                            blocks, device, stream);
}

// K4: K1's arguments with x the row-folded [N_src/2, 2d] view (N_src
// even); d is the logical row width.
int sagnn_segsum_fold_f32(const void* x, const void* src, const void* ptr,
                          void* out, int num_tgt, int d, void* scratch,
                          void* counters, int blocks, int device,
                          void* stream) {
  return launch<float, false, false, true>(x, nullptr, src, ptr, out,
                                           num_tgt, d, scratch, counters,
                                           blocks, device, stream);
}

int sagnn_segsum_fold_bf16(const void* x, const void* src, const void* ptr,
                           void* out, int num_tgt, int d, void* scratch,
                           void* counters, int blocks, int device,
                           void* stream) {
  return launch<__nv_bfloat16, false, false, true>(
      x, nullptr, src, ptr, out, num_tgt, d, scratch, counters, blocks,
      device, stream);
}

// K3 + K4: accumulate from the folded view of the part's window.
int sagnn_segsum_fold_acc_f32(const void* x, const void* src,
                              const void* ptr, void* out, int num_tgt, int d,
                              void* scratch, void* counters, int blocks,
                              int device, void* stream) {
  return launch<float, false, true, true>(x, nullptr, src, ptr, out, num_tgt,
                                          d, scratch, counters, blocks,
                                          device, stream);
}

int sagnn_segsum_fold_acc_bf16(const void* x, const void* src,
                               const void* ptr, void* out, int num_tgt,
                               int d, void* scratch, void* counters,
                               int blocks, int device, void* stream) {
  return launch<__nv_bfloat16, false, true, true>(
      x, nullptr, src, ptr, out, num_tgt, d, scratch, counters, blocks,
      device, stream);
}

// K2 + K3 (K6's weighted ring bucket): K2's arguments with out read and
// written, out[t] += sum_e w[e] * x[src[e]] for every row with edges; rows
// without edges are untouched.
int sagnn_wsegsum_acc_f32(const void* x, const void* w, const void* src,
                          const void* ptr, void* out, int num_tgt, int d,
                          void* scratch, void* counters, int blocks,
                          int device, void* stream) {
  return launch<float, true, true>(x, w, src, ptr, out, num_tgt, d, scratch,
                                   counters, blocks, device, stream);
}

// P2: K1's arguments; out[t] = x[src[ptr[t+1] - 1]] for every row with
// edges (each of its edges' rows loaded, none added), zeros for the
// others. It neither writes the scratch nor touches the counters.
int sagnn_segsum_ablate_f32(const void* x, const void* src, const void* ptr,
                            void* out, int num_tgt, int d, void* scratch,
                            void* counters, int blocks, int device,
                            void* stream) {
  return launch<float, false, false, false, true>(
      x, nullptr, src, ptr, out, num_tgt, d, scratch, counters, blocks,
      device, stream);
}

int sagnn_segsum_ablate_bf16(const void* x, const void* src, const void* ptr,
                             void* out, int num_tgt, int d, void* scratch,
                             void* counters, int blocks, int device,
                             void* stream) {
  return launch<__nv_bfloat16, false, false, false, true>(
      x, nullptr, src, ptr, out, num_tgt, d, scratch, counters, blocks,
      device, stream);
}

const char* sagnn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
