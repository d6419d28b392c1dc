"""Grouped matrix products over rows sorted by group (G1): the CUDA kernel,
its wrappers, its plain PyTorch version and the autograd function that ties
forward, dgrad and wgrad together.

Replaces no Pallas kernel: it is the port's counterpart of
`jax.lax.ragged_dot`, which the MoE block calls for its three expert
projections (`llm_training_tpu/models/moe.py:429-431`) and which XLA lowers
itself. Rows `offsets[g] .. offsets[g+1]` of `x [M, K]` belong to group g,
and `w [G, K, N]` stacks one matrix a group:

- `grouped_gemm_fwd(x, w, offsets)`: `y[r] = x[r] @ w[g]`, `[M, N]`;
- `grouped_gemm_dgrad(dy, w, offsets)`: `dx[r] = dy[r] @ w[g]^T`, `[M, K]`;
- `grouped_gemm_wgrad(x, dy, offsets, groups)`: `dw[g] = x_g^T @ dy_g`,
  `[G, K, N]`, zeros for a group with no rows (the contraction over the
  ragged rows that JAX's autodiff of `ragged_dot` gives);
- `grouped_gemm(x, w, offsets)`: the forward with both gradients, for the
  model.

`offsets` is `[G+1]` int32 (`offsets[0] = 0`, `offsets[G] = M`,
non-decreasing) and stays on the device: the kernel reads it, nothing
syncs with the host. Each wrapper is a public entry point with its own
device routing: it launches the kernel for CUDA tensors and raises on what
the kernel cannot take; it takes the plain version (a loop over groups of
`torch.matmul` on slices) only for tensors on the CPU, where the offsets
are read on the host. Each wrapper's `launches` counts its kernel's
launches.

What bounds it on an H100, and the design (`csrc/grouped_gemm.cu`): at
Qwen3-30B-A3B's shapes the bytes (its training shape reads 0.40 GB of
weights a projection against 0.10 ms of FLOPs; at decode only the touched
experts' weights are read), at Mixtral-8x7B's the FLOPs. bf16 runs on
Hopper's own path: TMA copies into a ring of swizzled shared-memory
stages, `wgmma` products with fp32 accumulation, one persistent block an
SM walking 128 x 128 output tiles; a block finds a tile's (group, row
tile) from the offsets on the device, no tile crosses a group's edge and
a group with no rows costs no weight reads. fp32 runs on FMA. No atomics:
two launches give the same bits.

Build: `build.py` compiles every `csrc/*.cu` for sm_90a into one shared
library with a plain C interface at the first launch. Nothing is built or
imported from CUDA when this module is imported.
"""

from __future__ import annotations

import ctypes

import torch

from llm_training_tpu_torch.ops.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
BF16_MAX_GROUPS = 2048  # kMaxGroups of the bf16 forward and dgrad
_OPS = {"fwd": 0, "dgrad": 1, "wgrad": 2}

_declared = False


def _load() -> ctypes.CDLL:
    """The port's kernel library with this kernel's entry point declared."""
    global _declared
    lib = build.load()
    if not _declared:
        lib.grouped_gemm_launch.argtypes = [
            ctypes.c_int, ctypes.c_int,  # op, dtype
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # a, b, offsets, out
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # rows, k, n, groups
            ctypes.c_void_p,  # stream
        ]
        lib.grouped_gemm_launch.restype = ctypes.c_int
        _declared = True
    return lib


def _check(what: str, a: torch.Tensor, b: torch.Tensor, offsets: torch.Tensor,
           rows: int, k: int, n: int, groups: int) -> None:
    """Validate what the kernel takes (shapes were matched by the caller)."""
    if a.dtype not in _DTYPE_CODES or b.dtype != a.dtype:
        raise ValueError(f"{what}: dtypes {a.dtype} / {b.dtype} not supported "
                         f"(both one of {list(_DTYPE_CODES)})")
    if offsets.dtype != torch.int32 or offsets.shape != (groups + 1,):
        raise ValueError(f"{what}: offsets must be int32 [{groups + 1}], got "
                         f"{offsets.dtype} {tuple(offsets.shape)}")
    if any(t.device != a.device for t in (b, offsets)):
        raise ValueError(f"{what}: all inputs must be on one device")
    if not all(t.is_contiguous() for t in (a, b, offsets)):
        raise ValueError(f"{what}: the grouped-GEMM kernel takes contiguous tensors only")
    if groups > 65535 or max(rows, k, n) >= 2**31:
        raise ValueError(f"{what}: {groups} groups of [{rows}, {k}, {n}] exceed the kernel's grid")
    if a.dtype == torch.bfloat16:
        if k % 8 or n % 8:
            raise ValueError(f"{what}: bf16 needs K and N multiples of 8, got K {k} N {n}")
        if what != "grouped_gemm_wgrad" and groups > BF16_MAX_GROUPS:
            raise ValueError(f"{what}: bf16 takes at most {BF16_MAX_GROUPS} groups (the "
                             f"kernel's shared prefix of their tiles), got {groups}")
        if any(t.data_ptr() % 16 for t in (a, b)):
            raise ValueError(f"{what}: bf16 operands must be 16-byte aligned")


def _launch(op: str, a: torch.Tensor, b: torch.Tensor, offsets: torch.Tensor, out: torch.Tensor,
            rows: int, k: int, n: int, groups: int) -> None:
    lib = _load()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.grouped_gemm_launch(
            _OPS[op], _DTYPE_CODES[a.dtype], a.data_ptr(), b.data_ptr(), offsets.data_ptr(),
            out.data_ptr(), rows, k, n, groups, stream,
        )
    build.check_launch(err, f"grouped-GEMM {op}")


def _route(what: str, *tensors: torch.Tensor) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU)."""
    build.refuse_dtensor(what, *tensors)
    device = tensors[0].device.type
    if device == "cpu":
        return False
    if device != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {tensors[0].device}")
    return True


def _shapes(what: str, a: torch.Tensor, b: torch.Tensor, b_dims: int = 3) -> None:
    if a.dim() != 2 or b.dim() != b_dims:
        raise ValueError(f"{what}: unexpected ranks {tuple(a.shape)} / {tuple(b.shape)}")


def grouped_gemm_fwd(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """`y [M, N]`, `y[r] = x[r] @ w[g]` for the rows r of group g."""
    what = "grouped_gemm_fwd"
    _shapes(what, x, w)
    if x.shape[1] != w.shape[1]:
        raise ValueError(f"{what}: x {tuple(x.shape)} does not match w {tuple(w.shape)}")
    if not _route(what, x, w, offsets):
        return grouped_gemm_fwd_torch(x, w, offsets)
    (rows, k), (groups, _, n) = x.shape, w.shape
    _check(what, x, w, offsets, rows, k, n, groups)
    y = torch.empty((rows, n), dtype=x.dtype, device=x.device)
    if rows:
        _launch("fwd", x, w, offsets, y, rows, k, n, groups)
        grouped_gemm_fwd.launches += 1
    return y


def grouped_gemm_dgrad(dy: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """`dx [M, K]`, `dx[r] = dy[r] @ w[g]^T` for the rows r of group g."""
    what = "grouped_gemm_dgrad"
    _shapes(what, dy, w)
    if dy.shape[1] != w.shape[2]:
        raise ValueError(f"{what}: dy {tuple(dy.shape)} does not match w {tuple(w.shape)}")
    if not _route(what, dy, w, offsets):
        return grouped_gemm_dgrad_torch(dy, w, offsets)
    (rows, n), (groups, k, _) = dy.shape, w.shape
    _check(what, dy, w, offsets, rows, k, n, groups)
    dx = torch.empty((rows, k), dtype=dy.dtype, device=dy.device)
    if rows:
        _launch("dgrad", dy, w, offsets, dx, rows, k, n, groups)
        grouped_gemm_dgrad.launches += 1
    return dx


def grouped_gemm_wgrad(x: torch.Tensor, dy: torch.Tensor, offsets: torch.Tensor,
                       groups: int) -> torch.Tensor:
    """`dw [G, K, N]`, `dw[g] = x_g^T @ dy_g` over group g's rows; zeros
    for a group with no rows."""
    what = "grouped_gemm_wgrad"
    _shapes(what, x, dy, 2)
    if x.shape[0] != dy.shape[0]:
        raise ValueError(f"{what}: x {tuple(x.shape)} and dy {tuple(dy.shape)} differ in rows")
    if not _route(what, x, dy, offsets):
        return grouped_gemm_wgrad_torch(x, dy, offsets, groups)
    (rows, k), n = x.shape, dy.shape[1]
    _check(what, x, dy, offsets, rows, k, n, groups)
    dw = torch.empty((groups, k, n), dtype=x.dtype, device=x.device)
    _launch("wgrad", x, dy, offsets, dw, rows, k, n, groups)
    grouped_gemm_wgrad.launches += 1
    return dw


grouped_gemm_fwd.launches = 0
grouped_gemm_dgrad.launches = 0
grouped_gemm_wgrad.launches = 0
LAUNCHERS = (grouped_gemm_fwd, grouped_gemm_dgrad, grouped_gemm_wgrad)


def _bounds(offsets: torch.Tensor) -> list[tuple[int, int, int]]:
    """(group, first row, end row) of each group, read on the host."""
    ends = offsets.tolist()
    return [(g, lo, hi) for g, (lo, hi) in enumerate(zip(ends[:-1], ends[1:]))]


def grouped_gemm_fwd_torch(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """The forward's plain version: one `torch.matmul` a group's slice. On
    any device autograd differentiates it through the slices' matmuls: the
    plain path that the card's parity checks hold the kernels' path to."""
    parts = [x[lo:hi] @ w[g] for g, lo, hi in _bounds(offsets)]
    return torch.cat(parts) if parts else x.new_zeros((0, w.shape[2]))


def grouped_gemm_dgrad_torch(dy: torch.Tensor, w: torch.Tensor,
                             offsets: torch.Tensor) -> torch.Tensor:
    """dgrad's plain version: one `torch.matmul` by `w[g]^T` a group's slice."""
    parts = [dy[lo:hi] @ w[g].t() for g, lo, hi in _bounds(offsets)]
    return torch.cat(parts) if parts else dy.new_zeros((0, w.shape[1]))


def grouped_gemm_wgrad_torch(x: torch.Tensor, dy: torch.Tensor, offsets: torch.Tensor,
                             groups: int) -> torch.Tensor:
    """wgrad's plain version: `x_g^T @ dy_g` a group, zeros for an empty one."""
    dw = x.new_zeros((groups, x.shape[1], dy.shape[1]))
    for g, lo, hi in _bounds(offsets):
        if hi > lo:
            dw[g] = x[lo:hi].t() @ dy[lo:hi]
    return dw


class _GroupedGemm(torch.autograd.Function):
    """`grouped_gemm_fwd` with `grouped_gemm_dgrad` and `grouped_gemm_wgrad`
    as its backward (each routed by device, as their wrappers are)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x, w, offsets)
        return grouped_gemm_fwd(x, w, offsets)

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        x, w, offsets = ctx.saved_tensors
        dy = dy.contiguous()
        dx = grouped_gemm_dgrad(dy, w, offsets) if ctx.needs_input_grad[0] else None
        dw = grouped_gemm_wgrad(x, dy, offsets, w.shape[0]) if ctx.needs_input_grad[1] else None
        return dx, dw, None


def grouped_gemm(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """`y[r] = x[r] @ w[g]` for the rows r of group g (x `[M, K]` sorted by
    group, w `[G, K, N]`, offsets `[G+1]` int32 on x's device), with
    gradients for x and w: JAX's `ragged_dot(x, w, group_sizes)`."""
    return _GroupedGemm.apply(x.contiguous(), w.contiguous(), offsets)


def offsets_from_sizes(group_sizes: torch.Tensor) -> torch.Tensor:
    """`[G+1]` int32 offsets (a leading 0, then the running sum) from `[G]`
    group sizes, on their device without a host sync."""
    return torch.nn.functional.pad(torch.cumsum(group_sizes, 0), (1, 0)).to(torch.int32)
