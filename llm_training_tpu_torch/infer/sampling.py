"""Token sampling: greedy, temperature, top-k, top-p.

Counterpart of `llm_training_tpu/infer/sampling.py`. Transforms act on fp32
next-token logits `[batch, vocab]`. The categorical draw takes an explicit
`torch.Generator`; temperature 0 is greedy argmax and draws nothing.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

_FILTERED = -1e10  # large-negative fill for filtered logits (fp32-safe)


@dataclass
class SamplingConfig:
    """Filters compose in HF order: temperature first, then top_k, then
    top_p over the survivors, then the draw."""

    temperature: float = 0.0
    top_k: int | None = None
    top_p: float | None = None

    def __post_init__(self):
        if self.temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k is not None and self.top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {self.top_k}")
        if self.top_p is not None and not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")


def top_k_filter(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep each row's k largest logits; fill the rest with -inf-like."""
    if k >= logits.shape[-1]:
        return logits
    threshold = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits >= threshold, logits, _FILTERED)


def top_p_filter(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering: keep the smallest prefix of the probability-sorted
    vocab whose mass reaches p (the crossing token stays)."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    mass_before = torch.cumsum(probs, dim=-1) - probs
    keep = mass_before < p
    threshold = torch.where(keep, sorted_logits, torch.inf).min(dim=-1, keepdim=True).values
    return torch.where(logits >= threshold, logits, _FILTERED)


def filtered_logits(logits: torch.Tensor, config: SamplingConfig) -> torch.Tensor:
    """The logits of the distribution the draw samples from (temperature
    > 0 only)."""
    logits = logits / config.temperature
    if config.top_k is not None:
        logits = top_k_filter(logits, config.top_k)
    if config.top_p is not None:
        logits = top_p_filter(logits, config.top_p)
    return logits


def sample_tokens_with_logprob(
    logits: torch.Tensor,
    generator: torch.Generator | None,
    config: SamplingConfig,
) -> tuple[torch.Tensor, torch.Tensor]:
    """logits `[batch, vocab]` (fp32) -> (token ids `[batch]` int64, chosen
    logprobs `[batch]` fp32). Greedy scores under the raw log-softmax;
    sampling under the filtered distribution it drew from."""
    if config.temperature == 0.0:
        tokens = torch.argmax(logits, dim=-1)
        log_probs = torch.log_softmax(logits, dim=-1)
    else:
        if generator is None:
            raise ValueError("temperature > 0 sampling requires a torch.Generator")
        filtered = filtered_logits(logits, config)
        log_probs = torch.log_softmax(filtered, dim=-1)
        tokens = torch.multinomial(log_probs.exp(), 1, generator=generator)[:, 0]
    chosen = torch.gather(log_probs, -1, tokens[:, None])[:, 0]
    return tokens, chosen.to(torch.float32)
