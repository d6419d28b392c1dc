"""Cross-entropy losses, including the chunked fused-linear cross-entropy.

Counterpart of `llm_training_tpu/ops/cross_entropy.py`: `shift_labels`,
`cross_entropy`, `fused_linear_cross_entropy`, `fused_linear_log_probs`
(the per-row label log-probs of DPO and ORPO) and
`fused_linear_token_log_probs` (GRPO's per-token ones). The fused ones
chunk the tokens and run each chunk under `torch.utils.checkpoint`, so forward and
backward peak at one chunk's fp32 logits instead of the whole
`tokens x vocab`. The head product is a plain matrix product (the JAX
package left it to XLA), so it is `torch.mm`. In bf16 the logits are the
product's fp32 accumulator, never rounded to bf16, as with JAX's
`preferred_element_type=float32`.

Vocab-parallel: when the head is a DTensor sharded on `vocab` over the
tensor ranks (the mesh's plan), each rank takes its chunk's local
`[chunk, V/tp]` logits from its own slice of the head; the row max and the
sum of exponentials are all-reduced over the tensor group and the label's
logit is picked on the rank that owns it (`_VocabParallelNLL`), and the
hidden states' gradient is all-reduced there in the backward. No rank
holds a `[chunk, V]` tensor or the whole head.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def shift_labels(labels: torch.Tensor, ignore_index: int = -100) -> torch.Tensor:
    """Next-token shift: labels[i] = input[i+1]; the final position is ignored."""
    shifted = torch.roll(labels, -1, dims=-1)
    shifted[..., -1] = ignore_index
    return shifted


class _VocabShard:
    """The tensor group of a vocab-sharded head and this rank's first
    vocab id."""

    def __init__(self, group, start: int):
        self.group, self.start = group, start


def _local_head(weight: torch.Tensor, bias: torch.Tensor | None):
    """(local weight, local bias, _VocabShard or None): a DTensor head
    sharded on its vocab dim (1 of `[embed, vocab]`) over a 1-D mesh gives
    its local slice; a plain one is itself."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(weight, DTensor):
        return weight, bias, None
    mesh = weight.device_mesh
    if mesh.ndim != 1 or weight.placements[0] != Shard(1):
        raise ValueError(f"the head must be sharded on vocab over one mesh dim, got "
                         f"{weight.placements} over {mesh}")
    local = weight.to_local()
    if bias is not None and isinstance(bias, DTensor):
        bias = bias.to_local()
    return local, bias, _VocabShard(mesh.get_group(), mesh.get_local_rank() * local.shape[1])


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over `group` (each tensor
    rank's logits slice contributes its part of d hidden)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        torch.distributed.all_reduce(grad, group=ctx.group)
        return grad, None


class _VocabParallelNLL(torch.autograd.Function):
    """Per-token NLL of vocab-sharded fp32 logits `[n, V/tp]`: the max and
    the sum of exponentials all-reduced, the label's logit from its owner."""

    @staticmethod
    def forward(ctx, logits, labels, ignore_index, shard):
        dist = torch.distributed
        valid = labels != ignore_index
        m = logits.amax(-1)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=shard.group)
        e = torch.exp(logits - m[:, None])
        total = e.sum(-1)
        dist.all_reduce(total, group=shard.group)
        local = valid & (labels >= shard.start) & (labels < shard.start + logits.shape[1])
        index = torch.where(local, labels - shard.start, 0)
        picked = torch.where(local, torch.gather(logits, 1, index[:, None])[:, 0], 0.0)
        dist.all_reduce(picked, group=shard.group)
        nll = torch.where(valid, m + torch.log(total) - picked, 0.0)
        ctx.save_for_backward(e / total[:, None], index, local, valid)
        return nll

    @staticmethod
    def backward(ctx, grad):
        probs, index, local, valid = ctx.saved_tensors
        grad = torch.where(valid, grad, 0.0)
        d = probs * grad[:, None]
        d.scatter_add_(1, index[:, None], torch.where(local, -grad, 0.0)[:, None])
        return d, None, None, None


def _token_nll(logits32: torch.Tensor, labels: torch.Tensor, ignore_index: int, shard=None):
    """Per-token negative log-likelihood (fp32) and validity mask; over a
    vocab shard's local logits when `shard` is given."""
    if shard is not None:
        return _VocabParallelNLL.apply(logits32, labels, ignore_index, shard), labels != ignore_index
    valid = labels != ignore_index
    safe_labels = torch.where(valid, labels, 0)
    lse = torch.logsumexp(logits32, dim=-1)
    label_logits = torch.gather(logits32, -1, safe_labels[..., None].long())[..., 0]
    return torch.where(valid, lse - label_logits, 0.0), valid


def cross_entropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    ignore_index: int = -100,
    reduction: str = "mean",
) -> torch.Tensor:
    """Cross-entropy over the last dim of `logits`, fp32 accumulation.
    reduction: 'mean' (over non-ignored tokens), 'sum', or 'none'."""
    nll, valid = _token_nll(logits.float(), labels, ignore_index)
    if reduction == "none":
        return nll
    if reduction == "sum":
        return nll.sum()
    if reduction == "mean":
        return nll.sum() / valid.sum().clamp_min(1).float()
    raise ValueError(f"unknown reduction {reduction!r}")


class _HeadProduct(torch.autograd.Function):
    """`h @ weight` of low-precision CUDA operands as fp32 logits, straight
    from the product's fp32 accumulator (`torch.mm(..., out_dtype=)`, which
    only the CUDA build has). The backward rounds the logits' gradient to
    the operands' type and takes the two products in it, so `h` and
    `weight` get gradients of their own types."""

    @staticmethod
    def forward(ctx, h, weight):
        ctx.save_for_backward(h, weight)
        return torch.mm(h, weight, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, grad):
        h, weight = ctx.saved_tensors
        grad = grad.to(h.dtype)
        d_h = torch.mm(grad, weight.t()) if ctx.needs_input_grad[0] else None
        d_weight = torch.mm(h.t(), grad) if ctx.needs_input_grad[1] else None
        return d_h, d_weight


def _head_logits(h: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """fp32 logits `[chunk, vocab]` of `h @ weight`, accumulated in fp32
    and never rounded to the operands' type. On the CPU the operands are
    upcast: products of bf16 values are exact in fp32, so it is the same
    arithmetic."""
    if h.dtype == torch.float32:
        return torch.mm(h, weight)
    if h.device.type == "cuda":
        return _HeadProduct.apply(h, weight)
    return torch.mm(h.float(), weight.float())


def _chunk_logits(h, weight, bias, logits_soft_cap):
    """fp32 logits `[chunk, vocab]` of one chunk: the head product, the
    bias, the soft cap."""
    logits = _head_logits(h, weight)
    if bias is not None:
        logits = logits + bias.float()
    if logits_soft_cap is not None:
        logits = logits_soft_cap * torch.tanh(logits / logits_soft_cap)
    return logits


def _checkpointed(fn, *args):
    """`fn(*args)`, recomputed in the backward when gradients flow."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _chunk_loss(h, weight, labels, bias, logits_soft_cap, ignore_index, shard=None):
    logits = _chunk_logits(h, weight, bias, logits_soft_cap)
    nll, valid = _token_nll(logits, labels, ignore_index, shard)
    return nll.sum(), valid.sum()


def fused_linear_cross_entropy(
    hidden: torch.Tensor,
    weight: torch.Tensor,
    labels: torch.Tensor,
    ignore_index: int = -100,
    chunk_size: int = 1024,
    logits_soft_cap: float | None = None,
    bias: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """CE of `hidden @ weight (+ bias)` against `labels` without the full
    logits. hidden `[tokens, embed]` (any leading shape is flattened),
    weight `[embed, vocab]`, bias `[vocab]`. Returns (sum of the NLL as an
    fp32 scalar, number of counted tokens); callers divide for the mean."""
    embed = hidden.shape[-1]
    weight, bias, shard = _local_head(weight, bias)
    if shard is not None:
        hidden = _CopyToGroup.apply(hidden, shard.group)
    hidden = hidden.reshape(-1, embed)
    labels = labels.reshape(-1)
    chunk_size = min(chunk_size, hidden.shape[0])
    total = hidden.new_zeros((), dtype=torch.float32)
    count = torch.zeros((), dtype=torch.int64, device=hidden.device)
    # the uneven last chunk runs as it is: padding it with ignored labels, as
    # the JAX scan does for its static shapes, adds nothing to either sum
    for start in range(0, hidden.shape[0], chunk_size):
        h = hidden[start:start + chunk_size]
        l = labels[start:start + chunk_size]
        s, c = _checkpointed(_chunk_loss, h, weight, l, bias, logits_soft_cap, ignore_index,
                             shard)
        total = total + s
        count = count + c
    return total, count


def _chunk_token_logps(h, weight, labels, bias, logits_soft_cap, ignore_index, shard=None):
    """Label log-probs (0 where ignored) and the validity mask of one
    sequence chunk: h `[batch, chunk, embed]`, labels `[batch, chunk]`."""
    rows, width, embed = h.shape
    logits = _chunk_logits(h.reshape(-1, embed), weight, bias, logits_soft_cap)
    nll, valid = _token_nll(logits, labels.reshape(-1), ignore_index, shard)
    return -nll.reshape(rows, width), valid.reshape(rows, width)


def _chunk_logps(h, weight, labels, bias, logits_soft_cap, ignore_index, shard=None):
    """Per-row sums of label log-probs and valid counts of one chunk."""
    logps, valid = _chunk_token_logps(h, weight, labels, bias, logits_soft_cap, ignore_index,
                                      shard)
    return logps.sum(-1), valid.sum(-1)


def _sequence_chunks(fn, hidden, weight, labels, ignore_index, chunk_size, logits_soft_cap,
                     bias):
    """`fn` over the sequence axis, `chunk_size` positions of every row at a
    time, each chunk recomputed in the backward. The last chunk is padded
    to `chunk_size` with zero hidden states and ignored labels, as the JAX
    scan pads it, so every chunk has one shape; callers strip or sum away
    the padding. Yields (the chunk's unpadded width, fn's outputs)."""
    batch, seq, embed = hidden.shape
    weight, bias, shard = _local_head(weight, bias)
    if shard is not None:
        hidden = _CopyToGroup.apply(hidden, shard.group)
    chunk_size = min(chunk_size, seq)
    for start in range(0, seq, chunk_size):
        h = hidden[:, start:start + chunk_size]
        l = labels[:, start:start + chunk_size]
        width = h.shape[1]
        if width < chunk_size:
            h = torch.cat([h, h.new_zeros((batch, chunk_size - width, embed))], dim=1)
            l = torch.cat([l, l.new_full((batch, chunk_size - width), ignore_index)], dim=1)
        yield width, _checkpointed(fn, h, weight, l, bias, logits_soft_cap, ignore_index, shard)


def fused_linear_log_probs(
    hidden: torch.Tensor,
    weight: torch.Tensor,
    labels: torch.Tensor,
    ignore_index: int = -100,
    chunk_size: int = 1024,
    logits_soft_cap: float | None = None,
    bias: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-sequence label log-probs of `hidden @ weight (+ bias)` without
    the full logits. hidden `[batch, seq, embed]`, labels `[batch, seq]`.
    Returns (sum of log p per row `[batch]` fp32, valid-token counts
    `[batch]`). Chunked over the sequence axis, `chunk_size` positions of
    every row at a time, each chunk recomputed in the backward, so memory
    peaks at `batch x chunk_size x vocab` fp32 logits."""
    batch = hidden.shape[0]
    logps = torch.zeros((batch,), dtype=torch.float32, device=hidden.device)
    counts = torch.zeros((batch,), dtype=torch.int64, device=hidden.device)
    # the padding of the last chunk adds nothing to either sum
    for _, (s, c) in _sequence_chunks(_chunk_logps, hidden, weight, labels, ignore_index,
                                      chunk_size, logits_soft_cap, bias):
        logps = logps + s
        counts = counts + c
    return logps, counts


def fused_linear_token_log_probs(
    hidden: torch.Tensor,
    weight: torch.Tensor,
    labels: torch.Tensor,
    ignore_index: int = -100,
    chunk_size: int = 1024,
    logits_soft_cap: float | None = None,
    bias: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-TOKEN label log-probs of `hidden @ weight (+ bias)` without the
    full logits (GRPO's token-level ratio and KL). hidden `[batch, seq,
    embed]`, labels `[batch, seq]`. Returns (log p per token `[batch, seq]`
    fp32, 0 at `ignore_index`; the validity mask `[batch, seq]` bool): the
    chunk loop of `fused_linear_log_probs`, its chunks concatenated instead
    of summed."""
    chunks = [(out[0][:, :width], out[1][:, :width]) for width, out in _sequence_chunks(
        _chunk_token_logps, hidden, weight, labels, ignore_index, chunk_size,
        logits_soft_cap, bias)]
    return torch.cat([c[0] for c in chunks], dim=1), torch.cat([c[1] for c in chunks], dim=1)
