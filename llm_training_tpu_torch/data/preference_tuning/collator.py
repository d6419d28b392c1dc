"""Preference-pair collator.

Counterpart of `llm_training_tpu/data/preference_tuning/collator.py`: pads
the chosen and the rejected sides of each pair to one common width (the
longest side of the batch, rounded up to `pad_to_multiple_of`) on the
configured side, with labels -100, segment id 0 and position 0 on padding,
and one segment (id 1) with positions from 0 on each response row.
"""

from __future__ import annotations

from typing import Any

import numpy as np


class PreferenceTuningDataCollator:
    """`config` carries `tokenizer.pad_token_id` and `pad_to_multiple_of`,
    as the JAX datamodule config does. Each example holds, for each side
    `chosen` and `rejected`, `{side}_input_ids`, `{side}_labels` and
    `{side}_length`."""

    def __init__(self, config: Any, padding_side: str = "right"):
        self.config = config
        tokenizer = config.tokenizer
        if tokenizer.pad_token_id is None:
            raise ValueError("tokenizer needs a pad token")
        self.pad_token_id = tokenizer.pad_token_id
        self.padding_side = padding_side

    def __call__(self, examples: list[dict]) -> dict[str, np.ndarray]:
        longest = max(max(e["chosen_length"], e["rejected_length"]) for e in examples)
        multiple = self.config.pad_to_multiple_of
        width = -(-longest // multiple) * multiple if multiple else longest
        batch = len(examples)
        out: dict[str, np.ndarray] = {}
        for side in ("chosen", "rejected"):
            input_ids = np.full((batch, width), self.pad_token_id, np.int32)
            labels = np.full((batch, width), -100, np.int32)
            segment_ids = np.zeros((batch, width), np.int32)
            position_ids = np.zeros((batch, width), np.int32)
            for row, example in enumerate(examples):
                n = example[f"{side}_length"]
                span = slice(0, n) if self.padding_side == "right" else slice(width - n, width)
                input_ids[row, span] = example[f"{side}_input_ids"]
                labels[row, span] = example[f"{side}_labels"]
                segment_ids[row, span] = 1
                position_ids[row, span] = np.arange(n, dtype=np.int32)
            out[f"{side}_input_ids"] = input_ids
            out[f"{side}_labels"] = labels
            out[f"{side}_segment_ids"] = segment_ids
            out[f"{side}_position_ids"] = position_ids
        return out
