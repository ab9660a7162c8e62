// Interval multi-head self-attention, forward and backward, for Hopper
// (sm_90a): the attention core of the fusion stack (T = graph_num) and of
// the pooled sequence branch (T = 1).
//
// Replaces no Pallas kernel: the JAX package leaves its small-T path
// (sagnn_tpu/ops/attention.py, T <= 16) to XLA. It is the core of
// sagnn_tpu_torch/ops/attention.py's small-T path, for q, k, v of shape
// [N, T, D], D = H * dk, f32, per node and head:
//
//     l[t, s] = (q[t] . k[s]) / sqrt(dk)
//     raw:    p[t, s] = exp(l[t, s]) / (sum_s exp(l[t, s]) + 1e-8)
//             (quirk Q5: no max subtracted, so exp overflows to inf, and
//             p to NaN, where the plain path's does)
//     stable: p[t, s] = exp(l[t, s] - m[t]) / sum_s exp(l[t, s] - m[t]),
//             m[t] = max_s l[t, s]
//     ctx[t]  = sum_s p[t, s] v[s]
//
// and, for a cotangent g of ctx,
//
//     da[t, s] = g[t] . v[s];  c[t] = sum_s p[t, s] da[t, s]
//     dl[t, s] = p[t, s] (da[t, s] - c[t]) / sqrt(dk)
//     dq[t] = sum_s dl[t, s] k[s];  dk[s] = sum_t dl[t, s] q[t]
//     dv[s] = sum_t p[t, s] g[t]
//
// (both normalisations share dl: for p = e / (sum e + eps) the Jacobian
// dp/dl is diag(p) - p p^T, as for the softmax).
//
// What bounds it: bytes. The work needs q, k, v read and ctx written once
// forward (16 T D bytes a node) and q, k, v, g read and dq, dk, dv written
// once backward (28 T D bytes a node); its arithmetic, about 4 T^2 D
// operations and T^2 H exps a node each way, is far below the card's rate.
// The plain path instead writes and reads [N, T, T, H, dk] products (9,216
// floats a node at T = 12, H = 16, dk = 4) forward and through autograd.
//
// What the design does about it:
//   * One block takes whole nodes, as many as fill about kThreads threads
//     (one node at T = 12, H = 16); one thread takes one (node, row,
//     head). A node's [T, D] rows are contiguous and the row-major order of
//     (row, head) is the order of their dk-float pieces, so consecutive
//     threads own consecutive pieces: the thread's own q (forward) and the
//     outputs move between registers and device memory in coalesced
//     vector accesses (one float4 a thread at dk = 4).
//   * The rows every thread of a head reads (k and v forward; q, k, v and
//     g backward) are staged once a block in shared memory by coalesced
//     16-byte loads. A thread reads a head's dk values as one vector; the
//     threads of a warp read consecutive vectors (no bank conflict) or one
//     vector (a broadcast).
//   * The T x T scores stay in registers: a thread holds its query row's
//     logits, at most kMaxT (1, 4 or 16, the template bound on T) of them,
//     in fully unrolled loops; dk is the template parameter kDk (1, 2, 4,
//     8 or 16).
//   * The backward recomputes the scores instead of reading saved ones, in
//     two phases. Phase 1, a thread per query row t, recomputes row t of l,
//     p and da, writes dq[t] and leaves m[t], the denominator and c[t] in
//     shared memory; phase 2, a thread per key row s, recomputes column s
//     of l, p and da from them (the same operations on the same operands,
//     so the same bits) and writes dk[s] and dv[s]. No [T, T] or larger
//     tensor reaches device memory, and the forward saves nothing.
//   * Deterministic: every sum runs in a fixed order, no atomics.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// One node's [T, D] floats are at most this many (the wrapper's bound,
// ops/attention.py MAX_NODE_FLOATS; ops/_build.py passes it as a -D define):
// it bounds the shared memory of a block.
#if !defined(SAGNN_MHSA_MAX_NODE_FLOATS)
#error "build through sagnn_tpu_torch/ops/_build.py, which defines the bound"
#endif

namespace {

constexpr int kThreads = 256;   // threads a block, at most
constexpr int kMaxT = 16;       // the longest T the kernels take
constexpr int kMaxNodeFloats = SAGNN_MHSA_MAX_NODE_FLOATS;
constexpr int kDefaultSmem = 48 * 1024;

// kDk consecutive floats of a row, loaded and stored by the widest vector
// accesses their alignment (4 * kDk bytes, 16 at most) allows.
template <int kDk>
struct Piece {
  float x[kDk];

  __device__ __forceinline__ void load(const float* __restrict__ p) {
    if constexpr (kDk % 4 == 0) {
#pragma unroll
      for (int j = 0; j < kDk / 4; ++j) {
        const float4 f = reinterpret_cast<const float4*>(p)[j];
        x[4 * j] = f.x;
        x[4 * j + 1] = f.y;
        x[4 * j + 2] = f.z;
        x[4 * j + 3] = f.w;
      }
    } else if constexpr (kDk == 2) {
      const float2 f = *reinterpret_cast<const float2*>(p);
      x[0] = f.x;
      x[1] = f.y;
    } else {
      x[0] = *p;
    }
  }

  __device__ __forceinline__ void store(float* __restrict__ p) const {
    if constexpr (kDk % 4 == 0) {
#pragma unroll
      for (int j = 0; j < kDk / 4; ++j) {
        reinterpret_cast<float4*>(p)[j] =
            make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
      }
    } else if constexpr (kDk == 2) {
      *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
    } else {
      *p = x[0];
    }
  }

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < kDk; ++j) x[j] = 0.f;
  }

  __device__ __forceinline__ float dot(const Piece& o) const {
    float s = x[0] * o.x[0];
#pragma unroll
    for (int j = 1; j < kDk; ++j) s = fmaf(x[j], o.x[j], s);
    return s;
  }

  // this += a * o
  __device__ __forceinline__ void add(float a, const Piece& o) {
#pragma unroll
    for (int j = 0; j < kDk; ++j) x[j] = fmaf(a, o.x[j], x[j]);
  }
};

// q . k / sqrt(dk), rounded once after the product as the plain path's
// division rounds it: never contracted into the exp's subtraction, so the
// backward's two phases recompute the same bits.
template <int kDk>
__device__ __forceinline__ float logit(const Piece<kDk>& q,
                                       const Piece<kDk>& k, float inv_scale) {
  return __fmul_rn(q.dot(k), inv_scale);
}

// Copy `count` floats from device to shared memory, every thread of the
// block taking a share; 16-byte accesses when `vec4` (both ends 16-byte
// aligned, count a multiple of 4).
__device__ __forceinline__ void stage(float* __restrict__ dst,
                                      const float* __restrict__ src,
                                      int count, bool vec4) {
  if (vec4) {
    const float4* s = reinterpret_cast<const float4*>(src);
    float4* d = reinterpret_cast<float4*>(dst);
    for (int i = threadIdx.x; i < count / 4; i += blockDim.x) d[i] = s[i];
  } else {
    for (int i = threadIdx.x; i < count; i += blockDim.x) dst[i] = src[i];
  }
}

// A block's nodes and its place in the launch.
struct Tile {
  int64_t base;   // the first float of the block's first node
  int nodes;      // whole nodes in the block (the last block's may be fewer)
  int row;        // floats of one node's [T, D]
  int per_node;   // (row, head) pieces of one node: T * H
};

__device__ __forceinline__ Tile tile_of(int64_t n, int t, int heads,
                                        int head_dim, int nodes_per_block) {
  const int64_t node0 = (int64_t)blockIdx.x * nodes_per_block;
  Tile tl;
  tl.per_node = t * heads;
  tl.row = tl.per_node * head_dim;
  tl.base = node0 * tl.row;
  const int64_t left = n - node0;
  tl.nodes = left < nodes_per_block ? (int)left : nodes_per_block;
  return tl;
}

// Row t's logits l[0..t) become p, exactly as the plain path normalises;
// m and den are what p[s] = exp(l[s] - m) / den recomputes it from.
template <int kT>
__device__ __forceinline__ void normalise(float (&l)[kT], int t, bool stable,
                                          float& m, float& den) {
  m = 0.f;
  if (stable) {
    m = -INFINITY;
#pragma unroll
    for (int s = 0; s < kT; ++s) {
      if (s < t) m = fmaxf(m, l[s]);
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int s = 0; s < kT; ++s) {
    if (s < t) {
      l[s] = expf(l[s] - m);
      sum += l[s];
    }
  }
  den = stable ? sum : sum + 1e-8f;
#pragma unroll
  for (int s = 0; s < kT; ++s) {
    if (s < t) l[s] = l[s] / den;
  }
}

// ctx [N, T, D] from q, k, v [N, T, D]; t <= kT.
template <int kDk, int kT>
__global__ void __launch_bounds__(kThreads) interval_mhsa_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ ctx, int64_t n, int t,
    int heads, int nodes_per_block, float inv_scale, bool stable,
    bool vec4) {
  extern __shared__ float4 smem4[];
  const Tile tl = tile_of(n, t, heads, kDk, nodes_per_block);
  float* const ks = reinterpret_cast<float*>(smem4);
  float* const vs = ks + nodes_per_block * tl.row;
  stage(ks, k + tl.base, tl.nodes * tl.row, vec4);
  stage(vs, v + tl.base, tl.nodes * tl.row, vec4);
  __syncthreads();
  for (int i = threadIdx.x; i < tl.nodes * tl.per_node; i += blockDim.x) {
    // piece i is (node, row, head); kv0 is (node, 0, head)
    const int kv0 = (i / tl.per_node) * tl.per_node + i % heads;
    Piece<kDk> qi;
    qi.load(q + tl.base + (int64_t)i * kDk);
    float l[kT];
#pragma unroll
    for (int s = 0; s < kT; ++s) {
      if (s < t) {
        Piece<kDk> kj;
        kj.load(ks + (kv0 + s * heads) * kDk);
        l[s] = logit(qi, kj, inv_scale);
      }
    }
    float m, den;
    normalise<kT>(l, t, stable, m, den);
    Piece<kDk> out;
    out.zero();
#pragma unroll
    for (int s = 0; s < kT; ++s) {
      if (s < t) {
        Piece<kDk> vj;
        vj.load(vs + (kv0 + s * heads) * kDk);
        out.add(l[s], vj);
      }
    }
    out.store(ctx + tl.base + (int64_t)i * kDk);
  }
}

// dq, dk, dv [N, T, D] from q, k, v and the cotangent g [N, T, D].
template <int kDk, int kT>
__global__ void __launch_bounds__(kThreads) interval_mhsa_bwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ g,
    float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
    int64_t n, int t, int heads, int nodes_per_block, float inv_scale,
    bool stable, bool vec4) {
  extern __shared__ float4 smem4[];
  const Tile tl = tile_of(n, t, heads, kDk, nodes_per_block);
  const int cap = nodes_per_block * tl.row;
  float* const qs = reinterpret_cast<float*>(smem4);
  float* const ks = qs + cap;
  float* const vs = ks + cap;
  float* const gs = vs + cap;
  // per (node, row, head) piece: m, den, c of its query row
  float* const stats = gs + cap;
  const int count = tl.nodes * tl.row;
  stage(qs, q + tl.base, count, vec4);
  stage(ks, k + tl.base, count, vec4);
  stage(vs, v + tl.base, count, vec4);
  stage(gs, g + tl.base, count, vec4);
  __syncthreads();
  const int pieces = tl.nodes * tl.per_node;
  // phase 1: piece i is (node, query row, head)
  for (int i = threadIdx.x; i < pieces; i += blockDim.x) {
    const int kv0 = (i / tl.per_node) * tl.per_node + i % heads;
    Piece<kDk> qi, gi;
    qi.load(qs + i * kDk);
    gi.load(gs + i * kDk);
    float l[kT], da[kT];
#pragma unroll
    for (int s = 0; s < kT; ++s) {
      if (s < t) {
        Piece<kDk> kj, vj;
        kj.load(ks + (kv0 + s * heads) * kDk);
        vj.load(vs + (kv0 + s * heads) * kDk);
        l[s] = logit(qi, kj, inv_scale);
        da[s] = gi.dot(vj);
      }
    }
    float m, den;
    normalise<kT>(l, t, stable, m, den);
    float c = 0.f;
#pragma unroll
    for (int s = 0; s < kT; ++s) {
      if (s < t) c = fmaf(l[s], da[s], c);
    }
    Piece<kDk> dqi;
    dqi.zero();
#pragma unroll
    for (int s = 0; s < kT; ++s) {
      if (s < t) {
        Piece<kDk> kj;
        kj.load(ks + (kv0 + s * heads) * kDk);
        dqi.add(l[s] * (da[s] - c) * inv_scale, kj);
      }
    }
    dqi.store(dq + tl.base + (int64_t)i * kDk);
    stats[3 * i] = m;
    stats[3 * i + 1] = den;
    stats[3 * i + 2] = c;
  }
  __syncthreads();
  // phase 2: piece i is (node, key row, head)
  for (int i = threadIdx.x; i < pieces; i += blockDim.x) {
    const int kv0 = (i / tl.per_node) * tl.per_node + i % heads;
    Piece<kDk> kj, vj, dkj, dvj;
    kj.load(ks + i * kDk);
    vj.load(vs + i * kDk);
    dkj.zero();
    dvj.zero();
    for (int r = 0; r < t; ++r) {
      const int j = kv0 + r * heads;   // (node, query row r, head)
      Piece<kDk> qr, gr;
      qr.load(qs + j * kDk);
      gr.load(gs + j * kDk);
      const float p = expf(logit(qr, kj, inv_scale) - stats[3 * j]) /
                      stats[3 * j + 1];
      const float da = gr.dot(vj);
      dkj.add(p * (da - stats[3 * j + 2]) * inv_scale, qr);
      dvj.add(p, gr);
    }
    dkj.store(dk + tl.base + (int64_t)i * kDk);
    dvj.store(dv + tl.base + (int64_t)i * kDk);
  }
}

// The launch's shape: nodes a block, threads a block, blocks; 0 blocks for
// a shape the kernels do not take.
struct Shape {
  int nodes_per_block = 0;
  int threads = 0;
  int64_t blocks = 0;
  int heads = 0;
  bool vec4 = false;
};

Shape shape_of(int n, int t, int d, int head_dim) {
  Shape sh;
  if (n < 0 || t < 1 || t > kMaxT || d <= 0 || head_dim <= 0 ||
      d % head_dim || (int64_t)t * d > kMaxNodeFloats) {
    return sh;
  }
  sh.heads = d / head_dim;
  const int per_node = t * sh.heads;
  sh.nodes_per_block = per_node >= kThreads ? 1 : kThreads / per_node;
  const int pieces = sh.nodes_per_block * per_node;
  sh.threads = pieces >= kThreads ? kThreads : (pieces + 31) / 32 * 32;
  sh.blocks = ((int64_t)n + sh.nodes_per_block - 1) / sh.nodes_per_block;
  sh.vec4 = (t * d) % 4 == 0;
  return sh;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= (size_t)kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int kDk, int kT>
cudaError_t launch_forward(const Shape& sh, const void* q, const void* k,
                           const void* v, void* ctx, int n, int t,
                           float inv_scale, bool stable,
                           cudaStream_t stream) {
  const size_t smem =
      2 * (size_t)sh.nodes_per_block * t * sh.heads * kDk * sizeof(float);
  auto kernel = interval_mhsa_fwd_kernel<kDk, kT>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)sh.blocks, sh.threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(ctx), n, t,
      sh.heads, sh.nodes_per_block, inv_scale, stable, sh.vec4);
  return cudaGetLastError();
}

// the smallest bound on T that holds t
template <int kDk>
cudaError_t forward(const Shape& sh, const void* q, const void* k,
                    const void* v, void* ctx, int n, int t, float inv_scale,
                    bool stable, cudaStream_t stream) {
  if (t == 1) {
    return launch_forward<kDk, 1>(sh, q, k, v, ctx, n, t, inv_scale, stable,
                                  stream);
  }
  if (t <= 4) {
    return launch_forward<kDk, 4>(sh, q, k, v, ctx, n, t, inv_scale, stable,
                                  stream);
  }
  return launch_forward<kDk, kMaxT>(sh, q, k, v, ctx, n, t, inv_scale,
                                    stable, stream);
}

template <int kDk, int kT>
cudaError_t launch_backward(const Shape& sh, const void* q, const void* k,
                            const void* v, const void* g, void* dq,
                            void* dk, void* dv, int n, int t,
                            float inv_scale, bool stable,
                            cudaStream_t stream) {
  const size_t per_node = (size_t)t * sh.heads;
  const size_t smem =
      (4 * per_node * kDk + 3 * per_node) * sh.nodes_per_block *
      sizeof(float);
  auto kernel = interval_mhsa_bwd_kernel<kDk, kT>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)sh.blocks, sh.threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(g),
      static_cast<float*>(dq), static_cast<float*>(dk),
      static_cast<float*>(dv), n, t, sh.heads, sh.nodes_per_block,
      inv_scale, stable, sh.vec4);
  return cudaGetLastError();
}

template <int kDk>
cudaError_t backward(const Shape& sh, const void* q, const void* k,
                     const void* v, const void* g, void* dq, void* dk,
                     void* dv, int n, int t, float inv_scale, bool stable,
                     cudaStream_t stream) {
  if (t == 1) {
    return launch_backward<kDk, 1>(sh, q, k, v, g, dq, dk, dv, n, t,
                                   inv_scale, stable, stream);
  }
  if (t <= 4) {
    return launch_backward<kDk, 4>(sh, q, k, v, g, dq, dk, dv, n, t,
                                   inv_scale, stable, stream);
  }
  return launch_backward<kDk, kMaxT>(sh, q, k, v, g, dq, dk, dv, n, t,
                                     inv_scale, stable, stream);
}

}  // namespace

extern "C" {

// q, k, v, ctx: [n, t, d] f32, contiguous, 16-byte aligned; d = heads x
// head_dim with head_dim 1, 2, 4, 8 or 16; 1 <= t <= 16; t x d at most
// SAGNN_MHSA_MAX_NODE_FLOATS. stable: 0 for the raw exp normalisation (Q5),
// 1 for the max-subtracted softmax. One launch on `stream`, no sync; none
// for n = 0. Returns the cudaError_t of the launch (0 = success;
// cudaErrorInvalidValue for a shape the kernel does not take).
int sagnn_interval_mhsa_f32(const void* q, const void* k, const void* v,
                            void* ctx, int n, int t, int d, int head_dim,
                            int stable, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Shape sh = shape_of(n, t, d, head_dim);
  if (sh.threads == 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const float inv_scale = 1.f / sqrtf((float)head_dim);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool st = stable != 0;
  switch (head_dim) {
    case 1: return (int)forward<1>(sh, q, k, v, ctx, n, t, inv_scale, st, s);
    case 2: return (int)forward<2>(sh, q, k, v, ctx, n, t, inv_scale, st, s);
    case 4: return (int)forward<4>(sh, q, k, v, ctx, n, t, inv_scale, st, s);
    case 8: return (int)forward<8>(sh, q, k, v, ctx, n, t, inv_scale, st, s);
    case 16:
      return (int)forward<16>(sh, q, k, v, ctx, n, t, inv_scale, st, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The gradient of sagnn_interval_mhsa_f32 for the cotangent g of ctx: dq,
// dk, dv, each [n, t, d] f32 like q; the same shapes, alignment and stable
// flag as the forward it differentiates.
int sagnn_interval_mhsa_bwd_f32(const void* q, const void* k, const void* v,
                                const void* g, void* dq, void* dk, void* dv,
                                int n, int t, int d, int head_dim,
                                int stable, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Shape sh = shape_of(n, t, d, head_dim);
  if (sh.threads == 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const float inv_scale = 1.f / sqrtf((float)head_dim);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool st = stable != 0;
  switch (head_dim) {
    case 1:
      return (int)backward<1>(sh, q, k, v, g, dq, dk, dv, n, t, inv_scale,
                              st, s);
    case 2:
      return (int)backward<2>(sh, q, k, v, g, dq, dk, dv, n, t, inv_scale,
                              st, s);
    case 4:
      return (int)backward<4>(sh, q, k, v, g, dq, dk, dv, n, t, inv_scale,
                              st, s);
    case 8:
      return (int)backward<8>(sh, q, k, v, g, dq, dk, dv, n, t, inv_scale,
                              st, s);
    case 16:
      return (int)backward<16>(sh, q, k, v, g, dq, dk, dv, n, t, inv_scale,
                               st, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
