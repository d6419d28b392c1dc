"""Flash attention for training: the CUDA kernels, their wrapper, their
autograd and their plain PyTorch versions.

Replaces the three Pallas TPU kernels of
`llm_training_tpu/ops/pallas/flash_attention.py`: `_fwd_kernel` (K1,
`csrc/flash_fwd.cu`), `_dq_kernel` (K2) and `_dkv_kernel` (K3, both in
`csrc/flash_bwd.cu`), with the glue of its `jax.custom_vjp`: delta =
rowsum(dO * O) in fp32 and the sink gradient. `flash_attention` is the
counterpart of the JAX wrapper of the same name: it folds the softmax scale
into q (rounded to q's type, as there), pads head_dim to 64, 128 or 256 and the
sequences to the 128-row block with segment id 0, and slices the outputs
back.

What bounds the kernels on an H100 is in the sources' notes: they are bound
by operations. In bf16 all three are built for Hopper (wgmma fed by a TMA
ring, warp specialisation, a block of 128 rows); fp32 runs on FMA from
shared memory.

Routing. `flash_attention` launches the kernels for CUDA tensors and
raises on what they cannot take; it takes the plain version only for
tensors on the CPU. The kernel forward is the custom op
`llm_training_tpu_torch::flash_fwd`, so that selective recompute
(`models/remat.py`) can name it and save its outputs. Each launcher counts
its launches: `flash_fwd_kernel.launches` (K1), `flash_dq_kernel.launches`
(K2), `flash_dkv_kernel.launches` (K3).

Nothing is built or loaded when this module is imported (`build.py`).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from llm_training_tpu_torch.ops.attention import _xla_attention, make_attention_mask
from llm_training_tpu_torch.ops.kernels import build

TILE = 64  # rows of a q or kv tile: what the kernels stream and skip by
BLOCK = 128  # rows a bf16 kernel block owns; the wrapper pads sequences to it
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128, 256)
_NO_SEGMENT = 2**30  # a tile range's smallest id when the tile is all padding

_declared = False


def _load() -> ctypes.CDLL:
    """The port's kernel library with the flash entry points declared."""
    global _declared
    lib = build.load()
    if not _declared:
        common = [
            ctypes.c_int, ctypes.c_int,  # dtype, head_dim
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q, k, v
            ctypes.c_void_p, ctypes.c_void_p,  # seg_q, seg_kv
            ctypes.c_void_p, ctypes.c_void_p,  # q tile ranges, kv tile ranges
        ]
        shape = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B Sq Skv Hq Hkv
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,  # causal window cap q_offset
            ctypes.c_void_p,  # stream
        ]
        # the q blocks' ranges, sinks, out, lse; after the stream, out_f32
        lib.flash_fwd_launch.argtypes = [*common, *[ctypes.c_void_p] * 4, *shape, ctypes.c_int]
        # the launcher's own 128-row block ranges, then dout lse delta and the outputs
        lib.flash_dq_launch.argtypes = [*common, *[ctypes.c_void_p] * 5, *shape]
        lib.flash_dkv_launch.argtypes = [*common, *[ctypes.c_void_p] * 6, *shape]
        for fn in (lib.flash_fwd_launch, lib.flash_dq_launch, lib.flash_dkv_launch):
            fn.restype = ctypes.c_int
        _declared = True
    return lib


def tile_ranges(segment_ids: torch.Tensor, rows: int = TILE) -> torch.Tensor:
    """`[B, S/rows, 2]` int32: the smallest nonzero segment id of each span
    of `rows` rows (`2**30` for an all-padding span) and its largest id. The
    kernels skip a (q span, kv span) pair whose ranges do not meet, which
    makes packed attention cost the sum of the documents' squares, as the
    Pallas kernels' `_segment_block_bounds` did. A 128-row block's range is
    the smallest and largest over its two 64-row tiles' ranges."""
    tiles = segment_ids.reshape(segment_ids.shape[0], -1, rows)
    low = torch.where(tiles > 0, tiles, _NO_SEGMENT).amin(-1)
    return torch.stack([low, tiles.amax(-1)], -1).to(torch.int32).contiguous()


def _check_flat(q, k, v, seg_q, seg_kv) -> None:
    """What the kernels take: the layout of `csrc/flash_common.cuh`."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"expected q [B, Sq, Hq, D] and k/v [B, Skv, Hkv, D]; got q {tuple(q.shape)}, "
            f"k {tuple(k.shape)}, v {tuple(v.shape)}"
        )
    batch, sq, hq, head_dim = q.shape
    _, skv, hkv, _ = k.shape
    if k.shape[0] != batch or k.shape[3] != head_dim or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} does not match k/v {tuple(k.shape)}")
    if head_dim not in _HEAD_DIMS:
        raise ValueError(f"head_dim {head_dim} not supported by the kernels ({_HEAD_DIMS}; "
                         "ROADMAP B, kernel limits)")
    if sq % TILE or skv % TILE:
        raise ValueError(f"sequence lengths ({sq}, {skv}) must be multiples of {TILE}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes q {q.dtype} / k {k.dtype} / v {v.dtype}: one of float32, bfloat16")
    if seg_q.shape != (batch, sq) or seg_kv.shape != (batch, skv):
        raise ValueError(f"segment ids {tuple(seg_q.shape)}, {tuple(seg_kv.shape)} do not match")
    if seg_q.dtype != torch.int32 or seg_kv.dtype != torch.int32:
        raise ValueError("segment ids must be int32")
    tensors = (q, k, v, seg_q, seg_kv)
    if any(t.device != q.device for t in tensors) or q.device.type != "cuda":
        raise ValueError("the flash kernels take tensors on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the flash kernels take contiguous tensors only")


def _shape_args(q, k, causal, window, cap, q_offset) -> list:
    batch, sq, hq, _ = q.shape
    return [batch, sq, k.shape[1], hq, k.shape[2], int(causal), int(window), float(cap),
            int(q_offset), torch.cuda.current_stream(q.device).cuda_stream]


def flash_fwd_kernel(
    q, k, v, seg_q, seg_kv, q_ranges, k_ranges, sinks, *, q_blocks, causal, window, cap,
    q_offset, out_dtype=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1 on flat padded inputs (scale already folded into q): returns O
    `[B, Sq, Hq, D]` in q's type (or fp32 with `out_dtype=torch.float32`:
    the same accumulator, unrounded) and LSE `[B, Hq, Sq]` fp32. `window`
    and `cap` are 0 for none; `sinks` is `[Hq]` fp32 or None; `q_blocks` is
    `tile_ranges(seg_q, BLOCK)`."""
    _check_blocks("flash forward", q, q_blocks)
    _check_flat(q, k, v, seg_q, seg_kv)
    if out_dtype not in (None, q.dtype, torch.float32):
        raise ValueError(f"flash forward writes O in {q.dtype} or float32, not {out_dtype}")
    lib = _load()
    batch, sq, hq, head_dim = q.shape
    out = torch.empty_like(q, dtype=out_dtype or q.dtype)
    lse = torch.empty((batch, hq, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.flash_fwd_launch(
            _DTYPE_CODES[q.dtype], head_dim, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            seg_q.data_ptr(), seg_kv.data_ptr(), q_ranges.data_ptr(), k_ranges.data_ptr(),
            q_blocks.data_ptr(), None if sinks is None else sinks.data_ptr(), out.data_ptr(),
            lse.data_ptr(),
            *_shape_args(q, k, causal, window, cap, q_offset), int(out.dtype == torch.float32),
        )
    build.check_launch(err, "flash forward")
    flash_fwd_kernel.launches += 1
    return out, lse


def _check_blocks(what: str, rows: torch.Tensor, blocks: torch.Tensor) -> None:
    """The bf16 kernels own 128-row blocks of `rows` (q for the forward and
    dq, k for dk/dv) and read those blocks' segment-id ranges."""
    batch, length = rows.shape[:2]
    if rows.dtype == torch.bfloat16 and length % BLOCK:
        raise ValueError(f"{what}: in bfloat16 the sequence ({length}) must be a multiple of {BLOCK}")
    if (blocks.dtype != torch.int32 or not blocks.is_contiguous() or blocks.device != rows.device
            or blocks.shape != (batch, -(-length // BLOCK), 2)):
        raise ValueError(f"{what}: block ranges must be tile_ranges(segment ids, {BLOCK}) "
                         f"on {rows.device}; got {tuple(blocks.shape)} {blocks.dtype}")


def flash_dq_kernel(
    q, k, v, seg_q, seg_kv, q_ranges, k_ranges, dout, lse, delta, *, q_blocks, causal, window,
    cap, q_offset,
) -> torch.Tensor:
    """K2: dQ (of the scaled q) from dO, LSE and delta `[B, Hq, Sq]` fp32.
    `q_blocks` is `tile_ranges(seg_q, BLOCK)`."""
    _check_blocks("flash dq", q, q_blocks)
    lib = _load()
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.flash_dq_launch(
            _DTYPE_CODES[q.dtype], q.shape[3], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            seg_q.data_ptr(), seg_kv.data_ptr(), q_ranges.data_ptr(), k_ranges.data_ptr(),
            q_blocks.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            *_shape_args(q, k, causal, window, cap, q_offset),
        )
    build.check_launch(err, "flash dq")
    flash_dq_kernel.launches += 1
    return dq


def flash_dkv_kernel(
    q, k, v, seg_q, seg_kv, q_ranges, k_ranges, dout, lse, delta, *, k_blocks, causal, window,
    cap, q_offset,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K3: dK and dV, each kv head summed over the q heads of its group.
    `k_blocks` is `tile_ranges(seg_kv, BLOCK)`. In bf16 the one call runs
    the kernel twice, for dV and for dK; it counts as one launch of K3."""
    _check_blocks("flash dkv", k, k_blocks)
    lib = _load()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = lib.flash_dkv_launch(
            _DTYPE_CODES[q.dtype], q.shape[3], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            seg_q.data_ptr(), seg_kv.data_ptr(), q_ranges.data_ptr(), k_ranges.data_ptr(),
            k_blocks.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *_shape_args(q, k, causal, window, cap, q_offset),
        )
    build.check_launch(err, "flash dkv")
    flash_dkv_kernel.launches += 1
    return dk, dv


flash_fwd_kernel.launches = 0
flash_dq_kernel.launches = 0
flash_dkv_kernel.launches = 0


@torch.library.custom_op("llm_training_tpu_torch::flash_fwd", mutates_args=())
def flash_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seg_q: torch.Tensor,
    seg_kv: torch.Tensor, q_ranges: torch.Tensor, k_ranges: torch.Tensor,
    q_blocks: torch.Tensor, sinks: Optional[torch.Tensor], causal: bool, window: int,
    cap: float, q_offset: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1 as a dispatcher op (its outputs are what selective recompute
    saves; a recompute that finds them cached does not launch K1 again)."""
    return flash_fwd_kernel(
        q, k, v, seg_q, seg_kv, q_ranges, k_ranges, sinks,
        q_blocks=q_blocks, causal=causal, window=window, cap=cap, q_offset=q_offset,
    )


@flash_fwd.register_fake
def _(q, k, v, seg_q, seg_kv, q_ranges, k_ranges, q_blocks, sinks, causal, window, cap, q_offset):
    batch, sq, hq, _ = q.shape
    return torch.empty_like(q), q.new_empty((batch, hq, sq), dtype=torch.float32)


class FlashAttention(torch.autograd.Function):
    """K1 forward, K2 + K3 backward, over flat padded inputs (the
    counterpart of `_make_attention`'s custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, seg_q, seg_kv, sinks, causal, window, cap, q_offset):
        q_ranges, k_ranges = tile_ranges(seg_q), tile_ranges(seg_kv)
        q_blocks, k_blocks = tile_ranges(seg_q, BLOCK), tile_ranges(seg_kv, BLOCK)
        out, lse = flash_fwd(
            q, k, v, seg_q, seg_kv, q_ranges, k_ranges, q_blocks, sinks, causal, window, cap,
            q_offset,
        )
        ctx.save_for_backward(q, k, v, seg_q, seg_kv, q_ranges, k_ranges, q_blocks, k_blocks,
                              sinks, out, lse)
        ctx.hyper = dict(causal=causal, window=window, cap=cap, q_offset=q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        (q, k, v, seg_q, seg_kv, q_ranges, k_ranges, q_blocks, k_blocks, sinks, out,
         lse) = ctx.saved_tensors
        dout = dout.contiguous()
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        flat = (q, k, v, seg_q, seg_kv, q_ranges, k_ranges, dout, lse, delta)
        dq = flash_dq_kernel(*flat, q_blocks=q_blocks, **ctx.hyper)
        dk, dv = flash_dkv_kernel(*flat, k_blocks=k_blocks, **ctx.hyper)
        d_sinks = None if sinks is None else sink_grad(sinks, lse, delta)
        return dq, dk, dv, None, None, d_sinks, None, None, None, None


def sink_grad(sinks: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """d loss / d sink per q head: -sum over rows of exp(sink - LSE) * delta
    (the sink's probability times delta; `attention_bwd` in JAX)."""
    return -(torch.exp(sinks.float()[None, :, None] - lse) * delta).sum((0, 2)).to(sinks.dtype)


def _pad_to(x: torch.Tensor, dim: int, size: int, value=0) -> torch.Tensor:
    extra = size - x.shape[dim]
    if extra == 0:
        return x
    pad = [0, 0] * (x.dim() - 1 - dim) + [0, extra]
    return F.pad(x, pad, value=value)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segment_ids: torch.Tensor | None = None,
    q_segment_ids: torch.Tensor | None = None,
    causal: bool = True,
    sliding_window: int | None = None,
    logits_soft_cap: float | None = None,
    scale: float | None = None,
    q_offset: int = 0,
    sinks: torch.Tensor | None = None,
) -> torch.Tensor:
    """Flash attention over packed sequences (the JAX wrapper's contract).

    q `[B, Sq, Hq, D]`, k/v `[B, Skv, Hkv, D]`; segment ids `[B, S]` (0 =
    padding, 1..N = packed documents); `q_offset` is the position of q row 0
    in the kv sequence; `sinks` `[Hq]` gpt-oss sink logits. Returns `[B, Sq,
    Hq, D]` in q's type. CUDA tensors go through K1 (and K2/K3 in the
    backward); CPU tensors take the plain version."""
    build.refuse_dtensor("flash_attention", q, k, v, segment_ids, q_segment_ids, sinks)
    batch, q_len, num_q_heads, head_dim = q.shape
    kv_len, num_kv_heads = k.shape[1], k.shape[2]
    if num_q_heads % num_kv_heads:
        raise ValueError(f"num_q_heads ({num_q_heads}) not divisible by num_kv_heads ({num_kv_heads})")
    if scale is None:
        scale = head_dim**-0.5
    if q_segment_ids is None:
        if segment_ids is not None and q_len != kv_len:
            raise ValueError(
                "q_segment_ids is required when segment_ids is given and "
                f"q_len ({q_len}) != kv_len ({kv_len})"
            )
        q_segment_ids = segment_ids
    if q.device.type == "cpu":
        return flash_attention_torch(
            q, k, v, segment_ids, q_segment_ids, causal, sliding_window,
            logits_soft_cap, scale, q_offset, sinks,
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    if sliding_window is not None and sliding_window < 1:
        raise ValueError(f"sliding_window must be >= 1, got {sliding_window}")
    if logits_soft_cap is not None and logits_soft_cap <= 0:
        raise ValueError(f"logits_soft_cap must be > 0, got {logits_soft_cap}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    if head_dim > max(_HEAD_DIMS):
        raise ValueError(f"head_dim {head_dim} not supported by the kernels (at most "
                         f"{max(_HEAD_DIMS)}; ROADMAP B, kernel limits)")
    if sinks is not None and sinks.shape != (num_q_heads,):
        raise ValueError(f"sinks must be [{num_q_heads}], got {tuple(sinks.shape)}")
    return _through_kernels(
        q, k, v, segment_ids, q_segment_ids, causal, int(sliding_window or 0),
        float(logits_soft_cap or 0.0), scale, int(q_offset), sinks,
    )


def _through_kernels(q, k, v, segment_ids, q_segment_ids, causal, window, cap, scale, q_offset,
                     sinks, attend=None) -> torch.Tensor:
    """The CUDA route of `flash_attention` around the kernels: scale folded
    into q, default segment ids, padding to what the kernels take, the
    autograd function, and the output sliced back to the caller's lengths.
    `attend` (same arguments as `FlashAttention.apply`) stands in for the
    kernels where there is no card, as the CPU tests do."""
    batch, q_len, _, head_dim = q.shape
    kv_len = k.shape[1]
    orig_dtype = q.dtype
    # fold the scale into q, rounded to q's type as the JAX wrapper does
    if scale != 1.0:
        q = q * torch.tensor(scale, dtype=q.dtype, device=q.device)
    ones = dict(dtype=torch.int32, device=q.device)
    seg_q = (torch.ones((batch, q_len), **ones) if q_segment_ids is None
             else q_segment_ids.to(torch.int32))
    seg_kv = (torch.ones((batch, kv_len), **ones) if segment_ids is None
              else segment_ids.to(torch.int32))
    q, k, v, seg_q, seg_kv = pad_inputs(q, k, v, seg_q, seg_kv)
    if sinks is not None:
        sinks = sinks.float().contiguous()
    out = (attend or FlashAttention.apply)(
        q, k, v, seg_q, seg_kv, sinks, causal, window, cap, q_offset
    )
    return out[:, :q_len, :, :head_dim].to(orig_dtype)


def pad_inputs(q, k, v, seg_q, seg_kv):
    """What the kernels take: the sequences padded to the 128-row block
    (padding gets segment id 0, so it is masked, not attended) and head_dim
    to the next of 64, 128 and 256 (zeros change no score; JAX pads to its
    128 lanes and leaves 64 and any multiple of 128 alone), all contiguous."""
    d_pad = next(d for d in _HEAD_DIMS if q.shape[3] <= d)
    sq, skv = _round_up(q.shape[1], BLOCK), _round_up(k.shape[1], BLOCK)
    q = _pad_to(_pad_to(q, 1, sq), 3, d_pad).contiguous()
    k = _pad_to(_pad_to(k, 1, skv), 3, d_pad).contiguous()
    v = _pad_to(_pad_to(v, 1, skv), 3, d_pad).contiguous()
    return q, k, v, _pad_to(seg_q, 1, sq).contiguous(), _pad_to(seg_kv, 1, skv).contiguous()


def flash_fwd_torch(
    q, k, v, seg_q, seg_kv, sinks=None, *, causal=True, window=0, cap=0.0, q_offset=0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1's plain version on the same flat inputs (scale folded into q):
    `_xla_attention` under the mask of `make_attention_mask`, with sinks,
    returning O and the row LSE `[B, Hq, Sq]`. The backward's plain version
    is autograd through it."""
    mask = make_attention_mask(
        seg_q, seg_kv, q.shape[1], k.shape[1], causal=causal,
        sliding_window=window or None, q_offset=q_offset,
    )
    return _xla_attention(q, k, v, mask, 1.0, cap or None, sinks=sinks, return_lse=True)


def flash_attention_torch(
    q, k, v, segment_ids=None, q_segment_ids=None, causal=True, sliding_window=None,
    logits_soft_cap=None, scale=None, q_offset=0, sinks=None,
) -> torch.Tensor:
    """The wrapper's plain version: the reference attention of
    `dot_product_attention(impl="xla")` in JAX."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q_segment_ids is None:
        q_segment_ids = segment_ids
    mask = None
    if segment_ids is not None or causal or sliding_window is not None:
        mask = make_attention_mask(
            q_segment_ids, segment_ids, q.shape[1], k.shape[1], causal=causal,
            sliding_window=sliding_window, q_offset=q_offset, device=q.device,
        )
    return _xla_attention(q, k, v, mask, scale, logits_soft_cap, sinks=sinks)
