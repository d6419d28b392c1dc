"""Held-out evaluation: stream a datamodule through the objective.

Counterpart of `llm_training_tpu/infer/evaluate.py` (`run_evaluation`):
the objective's own loss over packed batches, with its segment-id masking
(packed-document boundaries and padding never count), so the numbers
compare directly with the trainer's `val_loss`. The per-token NLL is the
token-weighted corpus mean (each batch's mean loss times its
`target_tokens`, summed, over the total), the perplexity its exp.
"""

from __future__ import annotations

import logging
import math
import time
from typing import Any

import numpy as np
import torch

logger = logging.getLogger(__name__)


@torch.no_grad()
def run_evaluation(
    objective: Any,
    datamodule: Any,
    device: torch.device | str,
    limit_batches: int | None = None,
    split: str = "val",
) -> dict[str, float]:
    """-> {eval/nll_per_token, eval/perplexity, eval/tokens, eval/batches,
    eval/time_s, eval/tokens_per_sec} of `objective.model` over the
    datamodule's `split` batches (at most `limit_batches`)."""
    if split not in ("val", "train"):
        raise ValueError(f"split must be 'val' or 'train', got {split!r}")
    if split == "train" and not limit_batches:
        raise ValueError(
            "split='train' streams an infinite batch sequence; set limit_batches"
        )
    datamodule.setup()
    batches = datamodule.val_batches() if split == "val" else datamodule.train_batches()

    total_nll = 0.0
    total_tokens = 0.0
    n_batches = 0
    t0 = time.perf_counter()
    for i, batch in enumerate(batches):
        if limit_batches and i >= limit_batches:
            break
        on_device = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                     for k, v in batch.items()}
        _, metrics = objective.loss_and_metrics(on_device, train=False)
        tokens = float(metrics["target_tokens"])
        total_nll += float(metrics["loss"]) * tokens
        total_tokens += tokens
        n_batches += 1
    elapsed = time.perf_counter() - t0
    if n_batches == 0:
        raise ValueError(
            f"datamodule produced no {split} batches "
            "(set validation_split or provide a val dataset)"
        )

    nll = total_nll / max(total_tokens, 1.0)
    result = {
        "eval/nll_per_token": nll,
        "eval/perplexity": (float(np.exp(np.minimum(nll, 700.0))) if math.isfinite(nll)
                            else float("inf")),
        "eval/tokens": total_tokens,
        "eval/batches": float(n_batches),
        "eval/time_s": elapsed,
        "eval/tokens_per_sec": total_tokens / elapsed if elapsed > 0 else 0.0,
    }
    logger.info(
        "evaluate[%s]: nll/token %.4f | ppl %.2f | %d tokens in %d batches (%.1f tok/s)",
        split, nll, result["eval/perplexity"], int(total_tokens), n_batches,
        result["eval/tokens_per_sec"],
    )
    return result
