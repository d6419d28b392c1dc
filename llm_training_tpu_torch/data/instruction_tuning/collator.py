"""Instruction-tuning collator.

Counterpart of `llm_training_tpu/data/instruction_tuning/collator.py`:
packing-aware padding to the longest row (rounded up to
`pad_to_multiple_of`), position ids restarting at 0 for each packed
document, per-document segment ids kept (0 on padding) and labels as the
datamodule masked them (-100 outside the assistant's tokens, and on
padding). Right-padded rows whose segment ids never decrease (all the
packers emit) go through the host packer's `pad_batch`, as JAX's do; any
other row through the numpy loop, which is also the plain version the
tests hold it to.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from llm_training_tpu_torch import native


class InstructionTuningDataCollator:
    """`config` carries `tokenizer.pad_token_id` and `pad_to_multiple_of`,
    as the JAX datamodule config does."""

    def __init__(self, config: Any, padding_side: str = "right"):
        self.config = config
        tokenizer = config.tokenizer
        if tokenizer.pad_token_id is None:
            raise ValueError("tokenizer needs a pad token")
        self.pad_token_id = tokenizer.pad_token_id
        self.padding_side = padding_side

    def _padded_len(self, longest: int) -> int:
        multiple = self.config.pad_to_multiple_of
        if multiple:
            return -(-longest // multiple) * multiple
        return longest

    def __call__(self, examples: list[dict]) -> dict[str, np.ndarray]:
        width = self._padded_len(max(len(e["input_ids"]) for e in examples))
        if self.padding_side == "right":
            segs_rows = [np.asarray(e["segment_ids"], np.int32) for e in examples]
            # the native loop restarts positions where the segment id
            # changes: the numpy loop's per-unique-id rule only for ids that
            # never decrease
            if all(np.all(np.diff(s) >= 0) for s in segs_rows):
                return native.pad_batch(
                    [np.asarray(e["input_ids"], np.int32) for e in examples], segs_rows,
                    [np.asarray(e["labels"], np.int32) for e in examples], width,
                    self.pad_token_id, restart_positions=True,
                )
        return self.plain(examples, width)

    def plain(self, examples: list[dict], width: int) -> dict[str, np.ndarray]:
        """The numpy loop: either side, any segment ids (JAX's fallback path)."""
        batch = len(examples)
        input_ids = np.full((batch, width), self.pad_token_id, np.int32)
        labels = np.full((batch, width), -100, np.int32)
        segment_ids = np.zeros((batch, width), np.int32)
        position_ids = np.zeros((batch, width), np.int32)
        for row, example in enumerate(examples):
            n = len(example["input_ids"])
            sl = slice(0, n) if self.padding_side == "right" else slice(width - n, width)
            input_ids[row, sl] = example["input_ids"]
            labels[row, sl] = example["labels"]
            segs = np.asarray(example["segment_ids"], np.int32)
            segment_ids[row, sl] = segs
            # positions restart at each packed document boundary
            positions = np.arange(n, dtype=np.int32)
            for seg in np.unique(segs):
                mask = segs == seg
                positions[mask] -= positions[mask][0]
            position_ids[row, sl] = positions
        return {
            "input_ids": input_ids,
            "labels": labels,
            "segment_ids": segment_ids,
            "position_ids": position_ids,
        }
