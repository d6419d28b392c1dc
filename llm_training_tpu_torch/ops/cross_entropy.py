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
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def shift_labels(labels: torch.Tensor, ignore_index: int = -100) -> torch.Tensor:
    """Next-token shift: labels[i] = input[i+1]; the final position is ignored."""
    shifted = torch.roll(labels, -1, dims=-1)
    shifted[..., -1] = ignore_index
    return shifted


def _token_nll(logits32: torch.Tensor, labels: torch.Tensor, ignore_index: int):
    """Per-token negative log-likelihood (fp32) and validity mask."""
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


def _chunk_loss(h, weight, labels, bias, logits_soft_cap, ignore_index):
    logits = _chunk_logits(h, weight, bias, logits_soft_cap)
    nll, valid = _token_nll(logits, labels, ignore_index)
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
        s, c = _checkpointed(_chunk_loss, h, weight, l, bias, logits_soft_cap, ignore_index)
        total = total + s
        count = count + c
    return total, count


def _chunk_token_logps(h, weight, labels, bias, logits_soft_cap, ignore_index):
    """Label log-probs (0 where ignored) and the validity mask of one
    sequence chunk: h `[batch, chunk, embed]`, labels `[batch, chunk]`."""
    rows, width, embed = h.shape
    logits = _chunk_logits(h.reshape(-1, embed), weight, bias, logits_soft_cap)
    nll, valid = _token_nll(logits, labels.reshape(-1), ignore_index)
    return -nll.reshape(rows, width), valid.reshape(rows, width)


def _chunk_logps(h, weight, labels, bias, logits_soft_cap, ignore_index):
    """Per-row sums of label log-probs and valid counts of one chunk."""
    logps, valid = _chunk_token_logps(h, weight, labels, bias, logits_soft_cap, ignore_index)
    return logps.sum(-1), valid.sum(-1)


def _sequence_chunks(fn, hidden, weight, labels, ignore_index, chunk_size, logits_soft_cap,
                     bias):
    """`fn` over the sequence axis, `chunk_size` positions of every row at a
    time, each chunk recomputed in the backward. The last chunk is padded
    to `chunk_size` with zero hidden states and ignored labels, as the JAX
    scan pads it, so every chunk has one shape; callers strip or sum away
    the padding. Yields (the chunk's unpadded width, fn's outputs)."""
    batch, seq, embed = hidden.shape
    chunk_size = min(chunk_size, seq)
    for start in range(0, seq, chunk_size):
        h = hidden[:, start:start + chunk_size]
        l = labels[:, start:start + chunk_size]
        width = h.shape[1]
        if width < chunk_size:
            h = torch.cat([h, h.new_zeros((batch, chunk_size - width, embed))], dim=1)
            l = torch.cat([l, l.new_full((batch, chunk_size - width), ignore_index)], dim=1)
        yield width, _checkpointed(fn, h, weight, l, bias, logits_soft_cap, ignore_index)


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
