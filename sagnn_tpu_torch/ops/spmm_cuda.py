"""Segment-sum SpMM (unweighted K1, weighted K2) and SDDMM (K5) through the
hand-written CUDA kernels; the port of `sagnn_tpu/ops/spmm_pallas.py`
(`plan_spmm`, `spmm_apply`, `build_stacked_plans`, the differentiable
`spmm`, `spmm_weighted` and `sddmm`, spmm_pallas.py:459-492, 689-892).

The plan is CSR row pointers over the target-sorted COO that
`data.graph.compile_interval_graphs` emits: `ptr = searchsorted(tgt,
arange(num_tgt + 1))`. Pad edges (tgt == num_tgt) sort after
`ptr[num_tgt]` and are never read. This replaces the TPU plan's chunk and
one-hot layout, which existed only to avoid the TPU's scatter. Per-edge
values (weights, scores) lie in the plan's own COO order: slot e belongs
to the edge (src[e], tgt[e]). The TPU's canonical-order indirection
(`edge_slot`/`edge_pos`) is not needed; where a value crosses to the
other direction's plan, it is gathered through the cross-direction
permutation (`data.graph.direction_permutation`).

Kernels (each on a CUDA tensor launches `csrc/*.cu` or raises; on a CPU
tensor runs its plain PyTorch version, which the tests and
`chip_smoke.py` hold the kernel against):
  * `spmm_apply(x, src, ptr, exact)`: out[t] = Σ_{e in row t} x[src[e]]
    (K1, `csrc/segsum.cu`).
  * `spmm_weighted_apply(x, w, src, ptr, exact)`: out[t] = Σ w[e]·x[src[e]]
    (K2, the weighted mode of the same kernel).
  * `sddmm_apply(x, y, src, tgt, ptr, exact)`: s[e] = x[src[e]]·y[tgt[e]]
    for the plan's real edges, 0 on pad slots (K5, `csrc/sddmm.cu`).
In every one the sums run in f32; exact=False casts the gathered tables
to bf16 first (as the JAX package does) and keeps weights in f32.

Differentiable forms (`torch.autograd.Function`s whose backwards are the
same kernels; JAX's `jax.custom_vjp`s):
  * `spmm` (`SpmmFunction`): A @ x, dx = Aᵀ g, K1 on the transpose plan.
    For a bipartite interval graph the transpose plan is the other
    direction's CSR of the same interval.
  * `spmm_weighted` (`SpmmWeightedFunction`): A_w @ x, differentiable in x
    and w: dx = K2 on the transpose plan with w gathered into its order;
    dw = K5(x, g) over the forward plan, only when w needs a gradient.
  * `sddmm` (`SddmmFunction`): dy = K2 on the forward plan weighted by the
    cotangent ḡ; dx = K2 on the transpose plan weighted by ḡ gathered
    into its order.
The "_bwd" launch counts are the launches these backwards make.
"""

from __future__ import annotations

import numpy as np
import torch

from sagnn_tpu_torch.ops.segment import gather_segment_sum

# Kernel launches per kernel name, incremented only where a launch happens;
# the "_bwd" names count the launches made by the autograd Functions'
# backwards. segsum: K1; wsegsum: K2; sddmm: K5.
LAUNCHES = {f"{kernel}_{mode}{bwd}": 0
            for kernel in ("segsum", "wsegsum", "sddmm")
            for bwd in ("", "_bwd") for mode in ("f32", "bf16")}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def csr_row_ptr(tgt: np.ndarray, num_tgt: int) -> np.ndarray:
    """[num_tgt + 1] int32 row pointers of target-sorted edges `tgt`
    (pad edges, tgt == num_tgt, fall after ptr[num_tgt])."""
    tgt = np.asarray(tgt)
    if tgt.size and (np.diff(tgt) < 0).any():
        raise ValueError("edges must be sorted by target")
    if tgt.size >= 2 ** 31:
        raise ValueError("the kernel indexes edges with int32")
    return np.searchsorted(tgt, np.arange(num_tgt + 1)).astype(np.int32)


def build_stacked_plans(u_src: np.ndarray, u_tgt: np.ndarray,
                        i_src: np.ndarray, i_tgt: np.ndarray,
                        num_users: int, num_items: int) -> dict:
    """CSR row pointers for every interval in both directions, stacked
    [g, ...]: {"u_ptr": [g, U+1], "i_ptr": [g, I+1]}. The source ids stay
    the COO's (`u_src`/`i_src`, already in target order). Each real source
    id is checked against its table size here, once, on the host, because
    the kernel does not check it."""
    def row_ptrs(src, tgt, num_tgt, num_src):
        ptr = np.stack([csr_row_ptr(t, num_tgt) for t in tgt])
        for k in range(src.shape[0]):
            real = src[k, :ptr[k, -1]]
            if real.size and (real.min() < 0 or real.max() >= num_src):
                raise ValueError(f"interval {k}: source id out of range")
        return ptr

    return {"u_ptr": row_ptrs(u_src, u_tgt, num_users, num_items),
            "i_ptr": row_ptrs(i_src, i_tgt, num_items, num_users)}


def _plain_table(x: torch.Tensor, exact: bool) -> torch.Tensor:
    """The table a plain version gathers from: bf16-rounded in bf16 mode,
    held in f64 when x is f64 (a reference for the kernels' own f32
    rounding), else in f32."""
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    return (x if exact else x.to(torch.bfloat16)).to(acc)


def _plan_edges(src: torch.Tensor, ptr: torch.Tensor
                ) -> tuple[int, torch.Tensor]:
    """(real edge count, per-edge target ids) of a CSR plan."""
    counts = (ptr[1:] - ptr[:-1]).long()
    n_edges = int(ptr[-1])
    if src.numel() < n_edges:
        raise ValueError(f"the plan has {n_edges} edges, src {src.numel()}")
    tgt = torch.repeat_interleave(
        torch.arange(ptr.numel() - 1, device=ptr.device), counts)
    return n_edges, tgt


def spmm_apply_plain(x: torch.Tensor, src: torch.Tensor, ptr: torch.Tensor,
                     exact: bool = True) -> torch.Tensor:
    """The plain PyTorch version of K1: expand the row pointers to per-edge
    targets, then gather + index_add_. bf16 mode sums the bf16-rounded
    table, as the kernel does. The sum runs in f32, or in f64 when x is
    f64."""
    n_edges, tgt = _plan_edges(src, ptr)
    return gather_segment_sum(_plain_table(x, exact), src[:n_edges].long(),
                              tgt, ptr.numel() - 1)


def spmm_weighted_apply_plain(x: torch.Tensor, w: torch.Tensor,
                              src: torch.Tensor, ptr: torch.Tensor,
                              exact: bool = True) -> torch.Tensor:
    """The plain version of K2: as `spmm_apply_plain`, each gathered row
    scaled by its edge's weight (kept in f32, or f64 with an f64 x)."""
    n_edges, tgt = _plan_edges(src, ptr)
    table = _plain_table(x, exact)
    return gather_segment_sum(table, src[:n_edges].long(), tgt,
                              ptr.numel() - 1,
                              weights=w[:n_edges].to(table.dtype))


def sddmm_apply_plain(x: torch.Tensor, y: torch.Tensor, src: torch.Tensor,
                      tgt: torch.Tensor, ptr: torch.Tensor,
                      exact: bool = True) -> torch.Tensor:
    """The plain version of K5: [len(src)] scores x[src[e]]·y[tgt[e]] for
    the plan's ptr[-1] real edges, 0 on the pad slots after them."""
    n_edges = int(ptr[-1])
    if src.numel() < n_edges or tgt.numel() != src.numel():
        raise ValueError(f"the plan has {n_edges} edges, src "
                         f"{src.numel()}, tgt {tgt.numel()}")
    xs = _plain_table(x, exact)[src[:n_edges].long()]
    yt = _plain_table(y, exact)[tgt[:n_edges].long()]
    out = torch.zeros(src.numel(), dtype=xs.dtype, device=xs.device)
    out[:n_edges] = torch.sum(xs * yt, dim=-1)
    return out


def _check_table(name: str, x: torch.Tensor) -> None:
    if x.dim() != 2 or x.shape[1] % 2 or x.shape[1] == 0:
        raise ValueError(f"{name} must be [N, D] with D even and > 0, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} must be float32 or bfloat16, got {x.dtype}")
    if x.shape[0] >= 2 ** 31:
        raise ValueError(f"the kernels index {name}'s rows with int32")


def _check_ids(device: torch.device, **ids: torch.Tensor) -> None:
    for name, t in ids.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, x on {device}")
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int32 tensor")


def _check_cuda_args(x: torch.Tensor, src: torch.Tensor,
                     ptr: torch.Tensor) -> None:
    _check_table("x", x)
    _check_ids(x.device, src=src, ptr=ptr)
    if ptr.numel() < 1 or ptr.numel() - 1 >= 2 ** 31:
        raise ValueError(f"ptr has {ptr.numel()} entries")
    if src.numel() >= 2 ** 31:
        raise ValueError("the kernels index edges with int32")


def _kernel_table(x: torch.Tensor, exact: bool) -> torch.Tensor:
    """x as the kernel reads it: contiguous f32, or bf16 in bf16 mode,
    aligned for float2 / bf16x2 loads."""
    table = (x.float() if exact else x.to(torch.bfloat16)).contiguous()
    if table.data_ptr() % (8 if exact else 4):
        table = table.clone()
    return table


def _launch(name: str, device: torch.device, backward: bool,
            *args) -> None:
    """Call the library's `sagnn_<name>` with `args`, the device and the
    current stream; raise on a refused launch; count it."""
    from sagnn_tpu_torch.ops._build import load_library

    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, f"sagnn_{name}")(
            *args, torch.cuda.current_device(), stream)
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.sagnn_error_string(err).decode()}")
    LAUNCHES[name + ("_bwd" if backward else "")] += 1


def spmm_apply(x: torch.Tensor, src: torch.Tensor, ptr: torch.Tensor,
               exact: bool = True) -> torch.Tensor:
    """out [num_tgt, D] f32 = Σ over each CSR row of x[src] (K1; see module
    docstring). CUDA: launches the kernel on the current stream without
    synchronising; CPU: the plain version. No gradient flows through it:
    `spmm` is the differentiable form.

    `ptr`/`src` must be a plan as `build_stacked_plans` makes and checks
    it: ptr non-decreasing from 0, ptr[-1] <= len(src), every id in
    src[:ptr[-1]] a row of x. The CPU path checks the length; the kernel
    checks none of it (that would cost a read of ptr back to the host on
    every launch) and reads out of bounds on a malformed plan."""
    return _segsum(x, src, ptr, exact, backward=False)


def spmm_weighted_apply(x: torch.Tensor, w: torch.Tensor, src: torch.Tensor,
                        ptr: torch.Tensor, exact: bool = True
                        ) -> torch.Tensor:
    """out [num_tgt, D] f32 = Σ over each CSR row of w[e]·x[src[e]] (K2).
    w: [len(src)] in the plan's edge order, used in f32 in both table
    modes. The plan's contract is `spmm_apply`'s; `spmm_weighted` is the
    differentiable form."""
    return _segsum(x, src, ptr, exact, backward=False, w=w)


def _segsum(x: torch.Tensor, src: torch.Tensor, ptr: torch.Tensor,
            exact: bool, backward: bool,
            w: torch.Tensor | None = None) -> torch.Tensor:
    """K1 (w None) or K2, counting a CUDA launch under the forward or the
    backward name."""
    if x.device.type == "cpu":
        if w is None:
            return spmm_apply_plain(x, src, ptr, exact)
        return spmm_weighted_apply_plain(x, w, src, ptr, exact)
    if x.device.type != "cuda":
        raise ValueError(f"spmm_apply runs on cuda or cpu, not {x.device}")
    _check_cuda_args(x, src, ptr)
    if w is not None:
        if w.device != x.device or w.dim() != 1 or w.numel() != src.numel():
            raise ValueError(f"w must be [{src.numel()}] on {x.device}, got "
                             f"{tuple(w.shape)} on {w.device}")
        w = w.float().contiguous()
    table = _kernel_table(x, exact)
    num_tgt, d = ptr.numel() - 1, x.shape[1]
    out = torch.empty((num_tgt, d), dtype=torch.float32, device=x.device)
    if num_tgt == 0:
        return out
    kernel = "segsum" if w is None else "wsegsum"
    name = f"{kernel}_{'f32' if exact else 'bf16'}"
    ids = (src.data_ptr(), ptr.data_ptr(), out.data_ptr(), num_tgt, d)
    if w is None:
        _launch(name, x.device, backward, table.data_ptr(), *ids)
    else:
        _launch(name, x.device, backward, table.data_ptr(), w.data_ptr(),
                *ids)
    return out


def sddmm_apply(x: torch.Tensor, y: torch.Tensor, src: torch.Tensor,
                tgt: torch.Tensor, ptr: torch.Tensor,
                exact: bool = True) -> torch.Tensor:
    """s [len(src)] f32 = x[src[e]]·y[tgt[e]] for the plan's real edges,
    0 on the pad slots (K5). y has one row per target of the plan
    (ptr.numel() - 1); src/tgt are the plan's target-sorted COO. The
    kernel reads the edge count from ptr[-1] on the device. `sddmm` is the
    differentiable form."""
    return _sddmm(x, y, src, tgt, ptr, exact, backward=False)


def _sddmm(x: torch.Tensor, y: torch.Tensor, src: torch.Tensor,
           tgt: torch.Tensor, ptr: torch.Tensor, exact: bool,
           backward: bool) -> torch.Tensor:
    if y.shape[0] != ptr.numel() - 1:
        raise ValueError(f"y has {y.shape[0]} rows, the plan "
                         f"{ptr.numel() - 1} targets")
    if x.device.type == "cpu":
        return sddmm_apply_plain(x, y, src, tgt, ptr, exact)
    if x.device.type != "cuda":
        raise ValueError(f"sddmm_apply runs on cuda or cpu, not {x.device}")
    _check_cuda_args(x, src, ptr)
    _check_table("y", y)
    _check_ids(x.device, tgt=tgt)
    if y.device != x.device or y.shape[1] != x.shape[1]:
        raise ValueError(f"y {tuple(y.shape)} on {y.device} does not fit x "
                         f"{tuple(x.shape)} on {x.device}")
    if tgt.numel() != src.numel():
        raise ValueError(f"tgt has {tgt.numel()} slots, src {src.numel()}")
    xt, yt = _kernel_table(x, exact), _kernel_table(y, exact)
    slots = src.numel()
    out = torch.empty(slots, dtype=torch.float32, device=x.device)
    if slots == 0:
        return out
    _launch(f"sddmm_{'f32' if exact else 'bf16'}", x.device, backward,
            xt.data_ptr(), yt.data_ptr(), src.data_ptr(), tgt.data_ptr(),
            ptr.data_ptr(), out.data_ptr(), ptr.numel() - 1, slots,
            x.shape[1])
    return out


class SpmmFunction(torch.autograd.Function):
    """A @ x with dx = Aᵀ g; JAX `spmm`/`_spmm_fwd`/`_spmm_bwd`
    (`sagnn_tpu/ops/spmm_pallas.py:459-492`). The plans get no gradient.
    In bf16 mode the backward casts the cotangent to bf16 before the
    gather, as `_spmm_bwd` does through `spmm_apply(g, ..., exact)`."""

    @staticmethod
    def forward(ctx, x, fwd_src, fwd_ptr, bwd_src, bwd_ptr, exact):
        _check_transpose_plan(bwd_ptr, x)
        ctx.save_for_backward(bwd_src, bwd_ptr)
        ctx.exact = exact
        return _segsum(x, fwd_src, fwd_ptr, exact, backward=False)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return (None,) * 6
        bwd_src, bwd_ptr = ctx.saved_tensors
        dx = _segsum(g.contiguous(), bwd_src, bwd_ptr, ctx.exact,
                     backward=True)
        return dx, None, None, None, None, None


def _check_transpose_plan(bwd_ptr: torch.Tensor, x: torch.Tensor) -> None:
    if bwd_ptr.numel() - 1 != x.shape[0]:
        raise ValueError(f"the backward plan has {bwd_ptr.numel() - 1} "
                         f"targets, x {x.shape[0]} rows")


def spmm(x: torch.Tensor, fwd_src: torch.Tensor, fwd_ptr: torch.Tensor,
         bwd_src: torch.Tensor, bwd_ptr: torch.Tensor,
         exact: bool = True) -> torch.Tensor:
    """Differentiable out = A @ x: (fwd_src, fwd_ptr) is A's plan,
    (bwd_src, bwd_ptr) Aᵀ's (the transpose direction's plan of the same
    graph, whose targets are x's rows). Both plans follow `spmm_apply`'s
    contract."""
    return SpmmFunction.apply(x, fwd_src, fwd_ptr, bwd_src, bwd_ptr, exact)


class SpmmWeightedFunction(torch.autograd.Function):
    """A_w @ x, differentiable in x and w; JAX `spmm_weighted` /
    `_spmm_weighted_bwd` (`sagnn_tpu/ops/spmm_pallas.py:797-832`):
      dx = A_wᵀ g: K2 on the transpose plan, w gathered into its order;
      dw[e] = x[src[e]]·g[tgt[e]]: K5 over the forward plan, launched only
      when w needs a gradient (a constant w, as with edge_norm, never
      launches it).
    In bf16 mode both gathered tables (g for dx, x and g for dw) are cast
    to bf16; w stays f32."""

    @staticmethod
    def forward(ctx, x, w, fwd_src, fwd_tgt, fwd_ptr, bwd_src, bwd_ptr,
                to_bwd, exact):
        _check_transpose_plan(bwd_ptr, x)
        if to_bwd.numel() != w.numel():
            raise ValueError(f"to_bwd has {to_bwd.numel()} slots, w "
                             f"{w.numel()}")
        ctx.save_for_backward(x, w, fwd_src, fwd_tgt, fwd_ptr, bwd_src,
                              bwd_ptr, to_bwd)
        ctx.exact = exact
        return _segsum(x, fwd_src, fwd_ptr, exact, backward=False, w=w)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, w, fwd_src, fwd_tgt, fwd_ptr, bwd_src, bwd_ptr, to_bwd = \
            ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _segsum(g, bwd_src, bwd_ptr, ctx.exact, backward=True,
                         w=w.index_select(0, to_bwd))
        if ctx.needs_input_grad[1]:
            dw = _sddmm(x, g, fwd_src, fwd_tgt, fwd_ptr, ctx.exact,
                        backward=True)
        return (dx, dw) + (None,) * 7


def spmm_weighted(x: torch.Tensor, w: torch.Tensor, fwd_src: torch.Tensor,
                  fwd_tgt: torch.Tensor, fwd_ptr: torch.Tensor,
                  bwd_src: torch.Tensor, bwd_ptr: torch.Tensor,
                  to_bwd: torch.Tensor, exact: bool = True) -> torch.Tensor:
    """Differentiable out = A_w @ x. (fwd_src, fwd_tgt, fwd_ptr): A's plan
    and its COO targets; (bwd_src, bwd_ptr): Aᵀ's plan; w [len(fwd_src)]
    in A's edge order; to_bwd [len(bwd_src)]: for each slot of Aᵀ's plan,
    the slot of the same edge in A's (so w.index_select(0, to_bwd) is w in
    Aᵀ's order)."""
    return SpmmWeightedFunction.apply(x, w, fwd_src, fwd_tgt, fwd_ptr,
                                      bwd_src, bwd_ptr, to_bwd, exact)


class SddmmFunction(torch.autograd.Function):
    """s[e] = x[src[e]]·y[tgt[e]], differentiable in x and y; JAX `sddmm` /
    `_sddmm_bwd` (`sagnn_tpu/ops/spmm_pallas.py:835-869`):
      dy[t] = Σ_{e: tgt=t} ḡ[e]·x[src[e]]: K2 on the forward plan;
      dx[u] = Σ_{e: src=u} ḡ[e]·y[tgt[e]]: K2 on the transpose plan, ḡ
      gathered into its order.
    In bf16 mode the gathered tables (x, y) are cast to bf16; ḡ stays
    f32."""

    @staticmethod
    def forward(ctx, x, y, fwd_src, fwd_tgt, fwd_ptr, bwd_src, bwd_ptr,
                to_bwd, exact):
        _check_transpose_plan(bwd_ptr, x)
        ctx.save_for_backward(x, y, fwd_src, fwd_ptr, bwd_src, bwd_ptr,
                              to_bwd)
        ctx.exact = exact
        return _sddmm(x, y, fwd_src, fwd_tgt, fwd_ptr, exact, backward=False)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, y, fwd_src, fwd_ptr, bwd_src, bwd_ptr, to_bwd = ctx.saved_tensors
        g = g.contiguous()
        dx = dy = None
        if ctx.needs_input_grad[0]:
            dx = _segsum(y, bwd_src, bwd_ptr, ctx.exact, backward=True,
                         w=g.index_select(0, to_bwd))
        if ctx.needs_input_grad[1]:
            dy = _segsum(x, fwd_src, fwd_ptr, ctx.exact, backward=True, w=g)
        return (dx, dy) + (None,) * 7


def sddmm(x: torch.Tensor, y: torch.Tensor, fwd_src: torch.Tensor,
          fwd_tgt: torch.Tensor, fwd_ptr: torch.Tensor,
          bwd_src: torch.Tensor, bwd_ptr: torch.Tensor, to_bwd: torch.Tensor,
          exact: bool = True) -> torch.Tensor:
    """Differentiable edge scores [len(fwd_src)] in A's edge order (pad
    slots 0); the arguments as `spmm_weighted`'s, y with one row per
    target of A."""
    return SddmmFunction.apply(x, y, fwd_src, fwd_tgt, fwd_ptr, bwd_src,
                               bwd_ptr, to_bwd, exact)
