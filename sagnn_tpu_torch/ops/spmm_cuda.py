"""Segment-sum SpMM through the hand-written CUDA kernel; the port of the
unweighted path of `sagnn_tpu/ops/spmm_pallas.py` (`plan_spmm`,
`spmm_apply`, `build_stacked_plans`, and the differentiable `spmm`).

The plan is CSR row pointers over the target-sorted COO that
`data.graph.compile_interval_graphs` emits: `ptr = searchsorted(tgt,
arange(num_tgt + 1))`. Pad edges (tgt == num_tgt) sort after
`ptr[num_tgt]` and are never read. This replaces the TPU plan's chunk and
one-hot layout, which existed only to avoid the TPU's scatter.

`spmm_apply(x, src, ptr, exact)` computes out[t] = Σ_{e in row t} x[src[e]]
in f32. On a CUDA tensor it launches `csrc/segsum.cu` (exact: the f32
table; bf16 mode: the table cast once to bf16, accumulated in f32) or
raises; on a CPU tensor it runs the plain PyTorch version,
`spmm_apply_plain`, which the tests and `chip_smoke.py` hold the kernel
against.

`spmm(x, fwd_src, fwd_ptr, bwd_src, bwd_ptr, exact)` is A @ x with a
gradient (`SpmmFunction`, JAX's `jax.custom_vjp` `spmm`): the forward runs
the kernel on A's plan, the backward runs the same kernel on the transpose
plan, dx = Aᵀ g. For a bipartite interval graph the transpose plan is the
other direction's CSR of the same interval (the u-direction's targets are
the i-direction's sources), so no second kernel is needed.
"""

from __future__ import annotations

import numpy as np
import torch

from sagnn_tpu_torch.ops.segment import gather_segment_sum

# Kernel launches per kernel name, incremented only where a launch happens;
# the "_bwd" names count the launches made by SpmmFunction's backward.
LAUNCHES = {"segsum_f32": 0, "segsum_bf16": 0, "segsum_f32_bwd": 0,
            "segsum_bf16_bwd": 0}


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


def spmm_apply_plain(x: torch.Tensor, src: torch.Tensor, ptr: torch.Tensor,
                     exact: bool = True) -> torch.Tensor:
    """The plain PyTorch version of the kernel: expand the row pointers to
    per-edge targets, then gather + index_add_. bf16 mode sums the
    bf16-rounded table, as the kernel does. The sum runs in f32, or in f64
    when x is f64 (a reference for the kernel's own rounding)."""
    num_tgt = ptr.numel() - 1
    counts = (ptr[1:] - ptr[:-1]).long()
    n_edges = int(ptr[-1])
    if src.numel() < n_edges:
        raise ValueError(f"the plan has {n_edges} edges, src {src.numel()}")
    tgt = torch.repeat_interleave(
        torch.arange(num_tgt, device=ptr.device), counts)
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    table = (x if exact else x.to(torch.bfloat16)).to(acc)
    return gather_segment_sum(table, src[:n_edges].long(), tgt, num_tgt)


def _check_cuda_args(x: torch.Tensor, src: torch.Tensor,
                     ptr: torch.Tensor) -> None:
    if x.dim() != 2 or x.shape[1] % 2 or x.shape[1] == 0:
        raise ValueError(f"x must be [N, D] with D even and > 0, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    for name, t in (("src", src), ("ptr", ptr)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int32 tensor")
    if ptr.numel() < 1 or ptr.numel() - 1 >= 2 ** 31:
        raise ValueError(f"ptr has {ptr.numel()} entries")
    if x.shape[0] >= 2 ** 31:
        raise ValueError("the kernel indexes source rows with int32")


def spmm_apply(x: torch.Tensor, src: torch.Tensor, ptr: torch.Tensor,
               exact: bool = True) -> torch.Tensor:
    """out [num_tgt, D] f32 = Σ over each CSR row of x[src] (see module
    docstring). CUDA: launches the kernel on the current stream without
    synchronising; CPU: the plain version. No gradient flows through it:
    `spmm` is the differentiable form.

    `ptr`/`src` must be a plan as `build_stacked_plans` makes and checks
    it: ptr non-decreasing from 0, ptr[-1] <= len(src), every id in
    src[:ptr[-1]] a row of x. The CPU path checks the length; the kernel
    checks none of it (that would cost a read of ptr back to the host on
    every launch) and reads out of bounds on a malformed plan."""
    return _segsum(x, src, ptr, exact, backward=False)


def _segsum(x: torch.Tensor, src: torch.Tensor, ptr: torch.Tensor,
            exact: bool, backward: bool) -> torch.Tensor:
    """`spmm_apply`, counting a CUDA launch under the forward or the
    backward name."""
    if x.device.type == "cpu":
        return spmm_apply_plain(x, src, ptr, exact)
    if x.device.type != "cuda":
        raise ValueError(f"spmm_apply runs on cuda or cpu, not {x.device}")
    _check_cuda_args(x, src, ptr)
    from sagnn_tpu_torch.ops._build import load_library

    lib = load_library()
    table = (x.float() if exact else x.to(torch.bfloat16)).contiguous()
    if table.data_ptr() % (8 if exact else 4):  # float2 / bf16x2 loads
        table = table.clone()
    num_tgt, d = ptr.numel() - 1, x.shape[1]
    out = torch.empty((num_tgt, d), dtype=torch.float32, device=x.device)
    if num_tgt == 0:
        return out
    name = "segsum_f32" if exact else "segsum_bf16"
    fn = lib.sagnn_segsum_f32 if exact else lib.sagnn_segsum_bf16
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(table.data_ptr(), src.data_ptr(), ptr.data_ptr(),
                 out.data_ptr(), num_tgt, d, torch.cuda.current_device(),
                 stream)
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.sagnn_error_string(err).decode()}")
    LAUNCHES[name + ("_bwd" if backward else "")] += 1
    return out


class SpmmFunction(torch.autograd.Function):
    """A @ x with dx = Aᵀ g; JAX `spmm`/`_spmm_fwd`/`_spmm_bwd`
    (`sagnn_tpu/ops/spmm_pallas.py:459-492`). The plans get no gradient.
    In bf16 mode the backward casts the cotangent to bf16 before the
    gather, as `_spmm_bwd` does through `spmm_apply(g, ..., exact)`."""

    @staticmethod
    def forward(ctx, x, fwd_src, fwd_ptr, bwd_src, bwd_ptr, exact):
        if bwd_ptr.numel() - 1 != x.shape[0]:
            raise ValueError(f"the backward plan has {bwd_ptr.numel() - 1} "
                             f"targets, x {x.shape[0]} rows")
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


def spmm(x: torch.Tensor, fwd_src: torch.Tensor, fwd_ptr: torch.Tensor,
         bwd_src: torch.Tensor, bwd_ptr: torch.Tensor,
         exact: bool = True) -> torch.Tensor:
    """Differentiable out = A @ x: (fwd_src, fwd_ptr) is A's plan,
    (bwd_src, bwd_ptr) Aᵀ's (the transpose direction's plan of the same
    graph, whose targets are x's rows). Both plans follow `spmm_apply`'s
    contract."""
    return SpmmFunction.apply(x, fwd_src, fwd_ptr, bwd_src, bwd_ptr, exact)
