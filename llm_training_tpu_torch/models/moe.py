"""Mixture-of-experts MLP block.

Counterpart of `llm_training_tpu/models/moe.py`, with JAX's names and
layouts at the public functions:

- router: an fp32 softmax over the expert logits of a compute-dtype gate
  product, top-k, optional renormalisation, or Phi-3.5-MoE's SparseMixer
  (`sparsemixer_topk`); every router of the port selects through `top_k`,
  which orders ties as `lax.top_k` does;
- experts: one stacked parameter a projection (`experts_gate_proj`,
  `experts_up_proj` `[E, H, I]`, `experts_down_proj` `[E, I, H]`, JAX's
  layout), never E separate modules;
- `dropless_moe_apply`'s impls: 'ragged' sorts the (token, slot) rows by
  expert and runs the three projections as grouped GEMMs
  (`ops/kernels/grouped_gemm.py`, G1: the kernel on CUDA, its plain
  version on the CPU); 'dense' runs every expert on every token (exact;
  E/K times the FLOPs); 'bucketed' gathers fixed-capacity buckets and
  drops the overflow (counted), each expert's capacity and its drops
  those of the global batch on a mesh, as JAX's are under GSPMD; 'auto'
  is 'ragged' on CUDA and 'dense' on the CPU, as JAX's is 'ragged' on the
  TPU only;
- the combine: each token's K weighted rows are added into a zero row of
  the compute dtype in ascending expert id, rounded after each add, as
  JAX's scatter-add runs over the expert-sorted rows; no `index_add_`
  atomics, so the sum is the same on every run and device;
- an optional shared expert, sigmoid-gated (qwen2_moe) or always on
  (granitemoeshared), and the router statistics the caller pools into the
  load-balancing loss (`router_block_stats`).

Expert parallelism (JAX's `_ep_ragged_apply`) is not ported: an active
mesh whose `expert` axis is above 1 raises naming ROADMAP A.9b.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from llm_training_tpu_torch.ops.kernels import grouped_gemm as gg
from llm_training_tpu_torch.ops.swiglu import silu_mul
from llm_training_tpu_torch.parallel.batch import batch_group, batch_index
from llm_training_tpu_torch.parallel.mesh import EXPERT_AXIS, SEQUENCE_AXIS, active_mesh

def router_block_stats(topk_idx: torch.Tensor, probs: torch.Tensor, num_experts: int,
                       pad_mask: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(sel_frac [E], mean_prob [E]) of one layer's routing, fp32: each of
    the K selections a token counts (so sel_frac sums to ~top_k, HF's
    `load_balancing_loss_func` scale), mean_prob is the mean routing
    probability; tokens where `pad_mask` is False are left out."""
    n_tokens, top_k = topk_idx.shape
    if pad_mask is None:
        valid = torch.ones((n_tokens,), dtype=torch.float32, device=probs.device)
    else:
        valid = pad_mask.reshape(-1).float()
    n_valid = valid.sum().clamp_min(1.0)
    # sums of 0/1 in fp32: exact in any order
    sel = torch.zeros((num_experts,), dtype=torch.float32, device=probs.device)
    sel = sel.index_add(0, topk_idx.reshape(-1), valid.repeat_interleave(top_k)) / n_valid
    mean_prob = (probs.float() * valid[:, None]).sum(0) / n_valid
    return sel, mean_prob


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries of the last dim, in JAX's
    `lax.top_k` order: descending, the lower index first among ties (a
    stable descending sort cut to k). `torch.topk` leaves the order of
    ties unspecified, and an upcycled router's duplicated columns or a
    group-limited router's masked zeros tie exactly."""
    idx = torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]
    return x.gather(-1, idx), idx


def sparsemixer_topk(logits: torch.Tensor, jitter_eps: float,
                     top_k: int = 2) -> tuple[torch.Tensor, torch.Tensor]:
    """Phi-3.5-MoE's SparseMixer selection in its deterministic form: the
    argmax, weighted by a softmax over the logits within a 2 * jitter_eps
    relative band of the max; then the same with the pick masked out.
    Returns (weights [T, 2], indices [T, 2]), not renormalised."""
    if top_k != 2:
        raise ValueError("sparsemixer routing is defined for top_k=2")

    def pick(scores):
        top = scores.amax(-1, keepdim=True)
        factor = torch.maximum(scores.abs(), top)
        mask = ((top - scores) / factor) > (2 * jitter_eps)
        gates = torch.softmax(scores.masked_fill(mask, -math.inf), -1)
        idx = scores.argmax(-1)
        return idx, gates.gather(-1, idx[:, None])[:, 0]

    i1, w1 = pick(logits)
    i2, w2 = pick(logits.scatter(-1, i1[:, None], -math.inf))
    return torch.stack([w1, w2], -1), torch.stack([i1, i2], -1)


def _sorted_dispatch(topk_idx: torch.Tensor, topk_weights: torch.Tensor, num_experts: int):
    """(flat_expert, flat_weight, flat_token, order, group_sizes) of the
    expert-sorted row layout (a stable sort, as JAX's argsort)."""
    n_tokens, top_k = topk_idx.shape
    flat_expert = topk_idx.reshape(-1)
    flat_weight = topk_weights.reshape(-1)
    flat_token = torch.arange(n_tokens * top_k, device=topk_idx.device) // top_k
    order = torch.argsort(flat_expert, stable=True)
    group_sizes = torch.bincount(flat_expert, minlength=num_experts).to(torch.int32)
    return flat_expert, flat_weight, flat_token, order, group_sizes


def _combine(rows: torch.Tensor, topk_idx: torch.Tensor) -> torch.Tensor:
    """`out [T, H]` from `rows [T, K, H]` (each token's weighted rows in its
    top-k slot order): the rows added into a zero row in ascending expert
    id, in the rows' dtype, rounding after each add (JAX's scatter-add over
    the expert-sorted rows)."""
    by_expert = topk_idx.argsort(-1)  # a token's K experts are distinct
    ordered = rows.gather(1, by_expert[..., None].expand_as(rows))
    out = ordered[:, 0]
    for j in range(1, ordered.shape[1]):
        out = out + ordered[:, j]
    return out


def _rows_before(group_sizes: torch.Tensor, rows: int) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Where this rank's expert-sorted rows stand in the global batch's:
    (each expert's rows on the batch's ranks that hold earlier tokens, each
    expert's rows over the whole batch, the batch's rows). JAX buckets the
    global batch, its rows in (batch, sequence, slot) order; a rank holds
    whole rows of the batch, so its tokens are one contiguous run of that
    order after the ranks of lower batch index. Off a mesh: (0, the sizes,
    `rows`). A `sequence` axis above 1 cuts each row across ranks, whose
    tokens are then not one run: it raises naming ROADMAP A.9b."""
    group = batch_group()
    if group is None or dist.get_world_size(group) == 1:
        return torch.zeros_like(group_sizes), group_sizes, rows
    mesh = active_mesh()
    if mesh[SEQUENCE_AXIS].size() > 1:
        raise NotImplementedError(
            "moe_impl='bucketed' on a `sequence` mesh axis above 1 is not ported "
            "(ROADMAP A.9b): the global capacity's row order spans the sequence's ranks")
    mine = torch.cat([group_sizes.new_tensor([batch_index(mesh)]), group_sizes])
    everyone = [torch.empty_like(mine) for _ in range(dist.get_world_size(group))]
    dist.all_gather(everyone, mine, group=group)
    everyone = torch.stack(everyone)
    earlier = everyone[:, 0] < mine[0]
    return (everyone[:, 1:] * earlier[:, None]).sum(0), everyone[:, 1:].sum(0), rows * len(everyone)


def _bucketed_apply(x, topk_idx, topk_weights, num_experts: int, bmm_fn: Callable,
                    capacity_factor: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Fixed-capacity buckets: sort the (token, slot) rows by expert, gather
    bucket e's first C rows into `[E, C, H]`, run `bmm_fn`, weight and
    combine. Rows beyond an expert's capacity are dropped and counted. On a
    mesh C and the drops are the global batch's (`_rows_before`): a rank
    keeps its rows whose place in their expert's global queue is under C,
    and the dropped count is the whole batch's."""
    n_tokens, top_k = topk_idx.shape
    hidden = x.shape[-1]
    rows = n_tokens * top_k
    _, flat_weight, flat_token, order, gs = _sorted_dispatch(topk_idx, topk_weights, num_experts)
    gs = gs.long()
    before, global_gs, global_rows = _rows_before(gs, rows)
    capacity = min(math.ceil(global_rows / num_experts * capacity_factor), global_rows)
    kept = (capacity - before).clamp(min=0).minimum(gs)  # this rank's rows of each bucket
    width = min(capacity, rows)  # a bucket's slots on this rank
    start = torch.cumsum(gs, 0) - gs
    offs = torch.arange(width, device=x.device)
    src_sorted = (start[:, None] + offs[None, :]).clamp(0, rows - 1)
    valid = offs[None, :] < kept[:, None]  # [E, C]
    src = order[src_sorted.reshape(-1)]  # the original (token, slot) rows
    tok = flat_token[src]
    xb = torch.where(valid.reshape(-1)[:, None], x[tok], 0).reshape(num_experts, width, hidden)
    yb = bmm_fn(xb)
    w = flat_weight[src] * valid.reshape(-1).to(flat_weight.dtype)
    ys = (yb.reshape(-1, hidden) * w.to(yb.dtype)[:, None]).to(x.dtype)
    # each kept (token, slot) row sits in exactly one bucket slot; a dropped
    # one reads the zero row appended at index E * C
    slots = valid.reshape(-1)
    row_of = torch.full((rows,), slots.numel(), dtype=torch.long, device=x.device)
    row_of[src[slots]] = torch.arange(slots.numel(), device=x.device)[slots]
    gathered = torch.cat([ys, ys.new_zeros((1, hidden))])[row_of]
    out = _combine(gathered.reshape(n_tokens, top_k, hidden), topk_idx)
    dropped = (global_rows - global_gs.clamp(max=capacity).sum()).float()
    return out, dropped


def _ep_group_size() -> int:
    """Size of the active mesh's expert axis (1 = no expert parallelism)."""
    mesh = active_mesh()
    if mesh is None or EXPERT_AXIS not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh[EXPERT_AXIS].size()


def dropless_moe_apply(
    x: torch.Tensor,
    topk_idx: torch.Tensor,
    topk_weights: torch.Tensor,
    num_experts: int,
    impl: str,
    dense_fn: Callable,
    ragged_fn: Callable,
    weights=None,
    ep_capacity_factor: float = 2.0,
    bmm_fn: Callable | None = None,
    moe_capacity_factor: float = 1.25,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The dispatch and combine every MoE family shares. x `[T, H]` in the
    compute dtype, topk_idx / topk_weights `[T, K]`. `dense_fn(x) -> [T, E,
    H]`; `ragged_fn(xs, offsets, expert_order, weights) -> [rows, H]` over
    the expert-sorted rows xs (`offsets [E+1]` int32 on the device);
    `bmm_fn(xb [E, C, H]) -> [E, C, H]` enables 'bucketed'. Returns (out
    `[T, H]`, dropped rows fp32: 0 on the dropless paths)."""
    n_tokens, top_k = topk_idx.shape
    no_drops = torch.zeros((), dtype=torch.float32, device=x.device)
    if impl == "auto":
        impl = "ragged" if x.device.type == "cuda" else "dense"
    if impl not in ("dense", "ragged", "bucketed"):
        raise ValueError(f"unknown moe_impl {impl!r}; expected auto/dense/ragged/bucketed")
    if _ep_group_size() > 1:
        raise NotImplementedError(
            "expert parallelism (an `expert` mesh axis above 1) is not ported (ROADMAP A.9b)")
    if impl == "bucketed":
        if bmm_fn is None:
            raise ValueError(
                "moe_impl='bucketed' needs the family to provide bmm_fn "
                "(currently: the Llama-family MoEMLP)"
            )
        return _bucketed_apply(x, topk_idx, topk_weights, num_experts, bmm_fn,
                               moe_capacity_factor)
    if impl == "dense":
        y = dense_fn(x)
        combine = torch.zeros((n_tokens, num_experts), dtype=x.dtype, device=x.device)
        combine = combine.scatter(1, topk_idx, topk_weights.to(x.dtype))
        return torch.einsum("teh,te->th", y, combine), no_drops
    flat_expert, flat_weight, flat_token, order, group_sizes = _sorted_dispatch(
        topk_idx, topk_weights, num_experts)
    token_order = flat_token[order]
    ys = ragged_fn(x[token_order], gg.offsets_from_sizes(group_sizes), flat_expert[order], weights)
    ys = ys * flat_weight[order][:, None].to(ys.dtype)
    # back to (token, slot) order, then each token's rows by ascending expert
    unsorted = torch.empty_like(ys).index_copy(0, order, ys)
    return _combine(unsorted.reshape(n_tokens, top_k, -1), topk_idx), no_drops


class MoEMLP(nn.Module):
    """The sparse MoE block with LlamaMLP's config surface.

    `forward(hidden [B, S, H], pad_mask [B, S] bool | None)` returns (out
    `[B, S, H]`, (sel_frac [E], mean_prob [E], dropped)): the layer's fp32
    router statistics, which the caller pools across depth before the
    E * sum(f * P) product (HF's `load_balancing_loss_func` concatenates
    every layer's logits first); padding tokens are left out of both.
    Parameters, in JAX's order: `gate` (the router, `[E, H]` as a torch
    Linear), the expert stacks, then the shared expert's `[H, si]` /
    `[si, H]` matrices and its `[H, 1]` gate (JAX's layouts)."""

    def __init__(self, config, device=None):
        super().__init__()
        self.config = config
        e, h, i = config.num_experts, config.hidden_size, config.moe_intermediate_size
        dtype = config.param_torch_dtype

        def param(*shape):
            return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device))

        self.gate = nn.Linear(h, e, bias=False, dtype=dtype, device=device)
        self.experts_gate_proj = param(e, h, i)
        self.experts_up_proj = param(e, h, i)
        self.experts_down_proj = param(e, i, h)
        si = config.shared_expert_intermediate_size
        if si:
            self.shared_gate_proj = param(h, si)
            self.shared_up_proj = param(h, si)
            self.shared_down_proj = param(si, h)
            if config.shared_expert_gated:
                self.shared_expert_gate = param(h, 1)

    def forward(self, hidden: torch.Tensor, pad_mask: torch.Tensor | None = None):
        cfg = self.config
        num_experts, k = cfg.num_experts, cfg.num_experts_per_tok
        cd = cfg.compute_torch_dtype
        batch, seq, embed = hidden.shape
        x = hidden.reshape(-1, embed).to(cd)

        # router: a compute-dtype product, an fp32 softmax
        logits = F.linear(x, self.gate.weight.to(cd)).float()
        probs = torch.softmax(logits, -1)
        if cfg.moe_router_impl == "sparsemixer":
            topk_probs, topk_idx = sparsemixer_topk(logits, cfg.router_jitter_eps, k)
        else:
            topk_probs, topk_idx = top_k(probs, k)
            if cfg.norm_topk_prob:
                topk_probs = topk_probs / topk_probs.sum(-1, keepdim=True)
        topk_probs = topk_probs.to(cd)

        w_gate = self.experts_gate_proj.to(cd)
        w_up = self.experts_up_proj.to(cd)
        w_down = self.experts_down_proj.to(cd)

        def dense_fn(xc):
            gate = torch.einsum("th,ehi->tei", xc, w_gate)
            up = torch.einsum("th,ehi->tei", xc, w_up)
            return torch.einsum("tei,eih->teh", silu_mul(gate, up), w_down)

        def ragged_fn(xs, offsets, expert_order, w):
            wg, wu, wd = w
            gate = gg.grouped_gemm(xs, wg, offsets)
            up = gg.grouped_gemm(xs, wu, offsets)
            return gg.grouped_gemm(silu_mul(gate, up), wd, offsets)

        def bmm_fn(xb):  # [E, C, H]: the buckets as equal groups of G1
            experts, capacity, width = xb.shape
            offsets = torch.arange(0, (experts + 1) * capacity, capacity, dtype=torch.int32,
                                   device=xb.device)
            flat = xb.reshape(-1, width)
            out = ragged_fn(flat, offsets, None, (w_gate, w_up, w_down))
            return out.reshape(experts, capacity, -1)

        out, dropped = dropless_moe_apply(
            x, topk_idx, topk_probs, num_experts, cfg.moe_impl, dense_fn, ragged_fn,
            weights=(w_gate, w_up, w_down), ep_capacity_factor=cfg.ep_capacity_factor,
            bmm_fn=bmm_fn, moe_capacity_factor=cfg.moe_capacity_factor,
        )

        if cfg.shared_expert_intermediate_size:
            shared = silu_mul(x @ self.shared_gate_proj.to(cd), x @ self.shared_up_proj.to(cd))
            shared = shared @ self.shared_down_proj.to(cd)
            if cfg.shared_expert_gated:
                shared = torch.sigmoid(x @ self.shared_expert_gate.to(cd)) * shared
            out = out + shared

        sel_frac, mean_prob = router_block_stats(topk_idx, probs, num_experts, pad_mask)
        return out.reshape(batch, seq, embed).to(hidden.dtype), (sel_frac, mean_prob, dropped)
