"""Pre-training collator.

Counterpart of `llm_training_tpu/data/pre_training/collator.py`: pad to
the longest row (rounded up to `pad_to_multiple_of`) on the configured
side, labels with BOS and padding masked (-100), segment ids 0 on padding,
and one shared position stream per row (positions run across packed
documents). Right padding runs through the host packer's `pad_batch`
(`llm_training_tpu_torch/native`), as JAX's does; left padding through the
numpy loop, which is also the plain version the tests hold it to.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from llm_training_tpu_torch import native


class PreTrainingDataCollator:
    """`config` carries `tokenizer.pad_token_id`, `tokenizer.bos_token_id`
    and `pad_to_multiple_of`, as the JAX datamodule config does."""

    def __init__(self, config: Any, padding_side: str = "right"):
        self.config = config
        self.padding_side = padding_side
        tokenizer = config.tokenizer
        if tokenizer.pad_token_id is None:
            raise ValueError("tokenizer needs a pad token")
        self.pad_token_id = tokenizer.pad_token_id
        self.bos_token_id = tokenizer.bos_token_id

    def _padded_len(self, longest: int) -> int:
        multiple = self.config.pad_to_multiple_of
        if multiple:
            return -(-longest // multiple) * multiple
        return longest

    def __call__(self, examples: list[dict]) -> dict[str, np.ndarray]:
        width = self._padded_len(max(len(e["input_ids"]) for e in examples))
        if self.padding_side == "right":
            rows = [np.asarray(e["input_ids"], np.int32) for e in examples]
            row_labels = [
                np.where(ids == self.bos_token_id, -100, ids).astype(np.int32)
                if self.bos_token_id is not None else ids
                for ids in rows
            ]
            return native.pad_batch(
                rows, [np.asarray(e["segment_ids"], np.int32) for e in examples], row_labels,
                width, self.pad_token_id, restart_positions=False,  # one stream per row
            )
        return self.plain(examples, width)

    def plain(self, examples: list[dict], width: int) -> dict[str, np.ndarray]:
        """The numpy loop: either side, JAX's fallback path."""
        batch = len(examples)
        input_ids = np.full((batch, width), self.pad_token_id, np.int32)
        segment_ids = np.zeros((batch, width), np.int32)
        labels = np.full((batch, width), -100, np.int32)
        position_ids = np.zeros((batch, width), np.int32)
        for row, example in enumerate(examples):
            ids = np.asarray(example["input_ids"], np.int32)
            segs = np.asarray(example["segment_ids"], np.int32)
            sl = slice(0, len(ids)) if self.padding_side == "right" else slice(width - len(ids), width)
            input_ids[row, sl] = ids
            segment_ids[row, sl] = segs
            row_labels = ids.copy()
            if self.bos_token_id is not None:
                row_labels[ids == self.bos_token_id] = -100
            labels[row, sl] = row_labels
            # positions start at 0 at the first real token, whichever side
            # the padding is on
            position_ids[row, sl] = np.arange(len(ids), dtype=np.int32)
        return {
            "input_ids": input_ids,
            "labels": labels,
            "segment_ids": segment_ids,
            "position_ids": position_ids,
        }
