"""Ragged paged-decode attention: the CUDA kernel, its wrapper and its plain
PyTorch version.

Replaces the Pallas TPU kernel `_decode_kernel` of
`llm_training_tpu/ops/pallas/paged_attention.py` (`paged_decode_attention`
there). One decode token per row attends over that row's own cache,
reading K/V pages through the row's block table.

What bounds it on an H100: HBM bytes. A call must read
`sum_b len_b * Hkv * D * 2 (K and V) * bytes/elem` plus q, out and the
`ceil(len_b / page)` table entries of each row, and does ~4 flops per
byte read -- far below the ~295 flops per byte where the tensor cores
would become the limit. The kernel (`csrc/paged_decode.cu`) reads each
needed byte once and keeps scores, the running max/denominator and the
accumulator on chip. In bf16 (what serving runs) it splits each row's
cache across the blocks of a thread-block cluster, which merge their
partial softmax states on chip in a fixed order: `plan_splits` picks the
split count on the host, and `paged_decode_split_torch` is that split
and merge in plain PyTorch.

The wrapper is a public entry point with its own device routing: it
launches the kernel for CUDA tensors and raises on what it cannot take;
it takes the plain version only for tensors on the CPU. The model reaches
it through `ops/paged_attention.py`, whose `impl` chooses between decode
through this wrapper and the gather path for chunks.
`paged_decode_attention.launches` counts kernel launches.

Build: `build.py` compiles every `csrc/*.cu` for sm_90a into one shared
library with a plain C interface at the first launch, loaded with
`ctypes`. Nothing is built or imported from CUDA when this module is
imported.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from llm_training_tpu_torch.ops.attention import _xla_attention
from llm_training_tpu_torch.ops.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 96, 128)
_MAX_GROUP = 8
MAX_SPLITS = 16  # blocks of a cluster (above 8 with the non-portable attribute)
MIN_SPLIT_SLOTS = 64  # no split shorter than this many of the kv slots a row can hold

_declared = False


def _load() -> ctypes.CDLL:
    """The port's kernel library with this kernel's entry point declared."""
    global _declared
    lib = build.load()
    if not _declared:
        lib.paged_decode_launch.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # q dtype, kv dtype, head_dim
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q, k pool, v pool
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # tables, lens, out
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # batch, kv heads, group
            ctypes.c_int, ctypes.c_int,  # page, pages per row
            ctypes.c_float, ctypes.c_float, ctypes.c_int,  # scale, cap, window
            ctypes.c_int, ctypes.c_void_p,  # splits, stream
        ]
        lib.paged_decode_launch.restype = ctypes.c_int
        _declared = True
    return lib


def _check(q, k_pages, v_pages, block_tables, lengths) -> int:
    """Validate what the kernel takes; returns the GQA group."""
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(
            f"expected q [B, Hq, D] and pools [N, page, Hkv, D]; got q "
            f"{tuple(q.shape)}, k {tuple(k_pages.shape)}, v {tuple(v_pages.shape)}"
        )
    batch, num_q_heads, head_dim = q.shape
    _, page_size, num_kv_heads, pool_dim = k_pages.shape
    if pool_dim != head_dim or num_q_heads % num_kv_heads:
        raise ValueError(
            f"q {tuple(q.shape)} does not match pool {tuple(k_pages.shape)}: "
            "head_dim must agree and Hq must be a multiple of Hkv"
        )
    group = num_q_heads // num_kv_heads
    if head_dim not in _HEAD_DIMS:
        raise ValueError(f"head_dim {head_dim} not supported (expected one of {_HEAD_DIMS})")
    if group > _MAX_GROUP:
        raise ValueError(f"GQA group {group} (Hq {num_q_heads} / Hkv {num_kv_heads}) exceeds {_MAX_GROUP}")
    if block_tables.dim() != 2 or block_tables.shape[0] != batch or lengths.shape != (batch,):
        raise ValueError(
            f"block_tables {tuple(block_tables.shape)} / lengths {tuple(lengths.shape)} "
            f"do not match batch {batch}"
        )
    if block_tables.shape[1] < 1:
        raise ValueError("block_tables needs at least one page per row")
    if q.dtype not in _DTYPE_CODES or k_pages.dtype not in _DTYPE_CODES:
        raise ValueError(f"dtypes q {q.dtype} / pool {k_pages.dtype} not supported")
    if v_pages.dtype != k_pages.dtype:
        raise ValueError(f"k pool {k_pages.dtype} and v pool {v_pages.dtype} differ")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("block_tables and lengths must be int32")
    tensors = (q, k_pages, v_pages, block_tables, lengths)
    if any(t.device != q.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the paged-decode kernel takes contiguous tensors only")
    return group


def plan_splits(slots: int, rows: int, sms: int) -> int:
    """Blocks per (row, kv head) for the bf16 kernel: enough that `rows`
    (B * Hkv) times the split count fills about one wave of `sms` SMs, no
    split shorter than MIN_SPLIT_SLOTS of the `slots` a row's table can
    hold, 1 to MAX_SPLITS."""
    by_wave = sms // max(rows, 1)
    by_length = -(-max(slots, 1) // MIN_SPLIT_SLOTS)
    return max(1, min(MAX_SPLITS, by_wave, by_length))


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def paged_decode_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: float | None = None,
    sliding_window: int | None = None,
    logits_soft_cap: float | None = None,
) -> torch.Tensor:
    """One ragged decode step: q `[B, Hq, D]` against pools `[N, page, Hkv,
    D]` through `block_tables [B, P]` (int32); `lengths [B]` (int32) counts
    tokens written INCLUDING this step's. Idle rows carry length 1 and a
    table of trash block 0. Returns `[B, Hq, D]` in q's dtype. The bf16
    kernel's split is planned from the table's capacity (`P * page`
    slots); lengths stay on the device."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return paged_decode_attention_torch(
            q, k_pages, v_pages, block_tables, lengths, scale=scale,
            sliding_window=sliding_window, logits_soft_cap=logits_soft_cap,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention runs on cuda or cpu, not {q.device}")
    group = _check(q, k_pages, v_pages, block_tables, lengths)
    if sliding_window is not None and sliding_window < 1:
        raise ValueError(f"sliding_window must be >= 1, got {sliding_window}")
    if logits_soft_cap is not None and logits_soft_cap <= 0:
        raise ValueError(f"logits_soft_cap must be > 0, got {logits_soft_cap}")
    lib = _load()
    batch, _, head_dim = q.shape
    _, page_size, num_kv_heads, _ = k_pages.shape
    splits = 1
    if q.dtype == torch.bfloat16 and k_pages.dtype == torch.bfloat16:
        splits = plan_splits(block_tables.shape[1] * page_size, batch * num_kv_heads,
                             _sm_count(q.device.index))
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paged_decode_launch(
            _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_pages.dtype], head_dim,
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            batch, num_kv_heads, group, page_size, block_tables.shape[1],
            float(scale), float(logits_soft_cap or 0.0), int(sliding_window or 0),
            splits, stream,
        )
    build.check_launch(err, "paged-decode")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def paged_decode_attention_torch(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: float | None = None,
    sliding_window: int | None = None,
    logits_soft_cap: float | None = None,
) -> torch.Tensor:
    """The kernel's plain version: gather each row's pages into a dense
    `[B, P*page, Hkv, D]` view, mask positions past `lengths - 1` (and
    outside the window), and run the reference attention."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    batch, _, _ = q.shape
    page_size = k_pages.shape[1]
    num_pages = block_tables.shape[1]
    tables = block_tables.long()
    gk = k_pages[tables].reshape(batch, num_pages * page_size, *k_pages.shape[2:])
    gv = v_pages[tables].reshape(batch, num_pages * page_size, *v_pages.shape[2:])
    q_pos = lengths.long()[:, None] - 1
    kv_pos = torch.arange(num_pages * page_size, device=q.device)[None, :]
    mask = kv_pos <= q_pos
    if sliding_window is not None:
        mask &= q_pos - kv_pos < sliding_window
    out = _xla_attention(
        q[:, None], gk.to(q.dtype), gv.to(q.dtype), mask[:, None, None, :],
        scale, logits_soft_cap,
    )
    return out[:, 0]


CHUNK = 16  # kv slots the bf16 kernel's warps take at a time; a split is whole chunks


def split_bounds(length: int, window: int | None, splits: int) -> list[tuple[int, int]]:
    """The kv slots `[lo, hi)` of each of `splits` splits of one row, as the
    bf16 kernel cuts them: the visible slots `[start, length)` in runs of
    whole CHUNKs, the same count of chunks to each split, the last split
    short or empty."""
    start = max(length - window, 0) if window else 0
    visible = max(length - start, 0)
    per = -(-visible // (splits * CHUNK)) * CHUNK
    return [(start + i * per, min(length, start + (i + 1) * per)) for i in range(splits)]


def merge_states(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor):
    """Merge partial softmax states over dim 0, in order, as the kernel
    does: m (the parts' maxima, -inf for a part that saw nothing) and l
    `[parts, ...]`, acc `[parts, ..., D]`. Returns the merged (m, l, acc);
    m is -inf and l 0 when no part saw anything."""
    top = m.amax(0)
    weight = torch.where(m == -math.inf, 0.0, torch.exp2(m - torch.where(top == -math.inf, 0.0, top)))
    l_sum, a_sum = torch.zeros_like(l[0]), torch.zeros_like(acc[0])
    for i in range(m.shape[0]):  # fixed order
        l_sum = l_sum + weight[i] * l[i]
        a_sum = a_sum + weight[i][..., None] * acc[i]
    return top, l_sum, a_sum


def paged_decode_split_torch(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,
    lengths: torch.Tensor,
    splits: int,
    *,
    scale: float | None = None,
    sliding_window: int | None = None,
    logits_soft_cap: float | None = None,
) -> torch.Tensor:
    """The bf16 kernel's algebra in plain PyTorch, in fp32: each row's
    visible slots cut into `splits` splits (`split_bounds`), each split's
    (m, l, acc) from its own slots (scores in log2 units, as the kernel
    keeps them), then the splits merged in order (`merge_states`). A row
    with no visible slot gives 0. Returns `[B, Hq, D]` in fp32."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    batch, num_q_heads, head_dim = q.shape
    page = k_pages.shape[1]
    num_kv_heads = k_pages.shape[2]
    group = num_q_heads // num_kv_heads
    log2e = 1.0 / math.log(2.0)
    out = torch.zeros((batch, num_q_heads, head_dim), dtype=torch.float32, device=q.device)
    for b in range(batch):
        length = int(lengths[b])
        qb = q[b].float().reshape(num_kv_heads, group, head_dim)
        states = []
        for lo, hi in split_bounds(length, sliding_window, splits):
            if hi <= lo:
                on = dict(device=q.device)
                states.append((torch.full((num_kv_heads, group), -math.inf, **on),
                               torch.zeros((num_kv_heads, group), **on),
                               torch.zeros((num_kv_heads, group, head_dim), **on)))
                continue
            slots = torch.arange(lo, hi)
            pages = block_tables[b].long()[slots // page]
            k = k_pages[pages, slots % page].float()  # [n, Hkv, D]
            v = v_pages[pages, slots % page].float()
            x = torch.einsum("hgd,nhd->hgn", qb, k) * scale
            if logits_soft_cap is not None:
                x = logits_soft_cap * torch.tanh(x / logits_soft_cap)
            x = x * log2e
            m = x.amax(-1)
            p = torch.exp2(x - m[..., None])
            states.append((m, p.sum(-1), torch.einsum("hgn,nhd->hgd", p, v)))
        m, l, acc = (torch.stack(part) for part in zip(*states))
        _, l_sum, a_sum = merge_states(m, l, acc)
        merged = torch.where(l_sum[..., None] > 0, a_sum / l_sum.clamp_min(1e-30)[..., None], 0.0)
        out[b] = merged.reshape(num_q_heads, head_dim)
    return out
