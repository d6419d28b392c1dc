"""Seeded synthetic token stream for smoke and performance runs.

Counterpart of `llm_training_tpu/data/dummy.py` (numpy, copied).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from llm_training_tpu_torch.data.base import BaseDataModule, BaseDataModuleConfig


@dataclass
class DummyDataModuleConfig(BaseDataModuleConfig):
    vocab_size: int = 32000
    max_length: int = 2048
    num_samples: int | None = None
    num_tokens: int | None = None


class DummyDataModule(BaseDataModule):
    config: DummyDataModuleConfig

    def setup(self) -> None:
        cfg = self.config
        if cfg.num_samples is None and cfg.num_tokens is None:
            raise ValueError("one of num_samples / num_tokens is required")
        n = cfg.num_samples if cfg.num_samples is not None else -(-cfg.num_tokens // cfg.max_length)
        rng = np.random.default_rng(cfg.seed)
        self.train_dataset = rng.integers(
            0, cfg.vocab_size, size=(n, cfg.max_length), dtype=np.int32
        )
        if cfg.validation_split:
            n_val = (
                int(cfg.validation_split)
                if cfg.validation_split >= 1
                else max(1, int(n * cfg.validation_split))
            )
            self.val_dataset = self.train_dataset[:n_val]
            self.train_dataset = self.train_dataset[n_val:]

    def collate(self, examples: list[np.ndarray]) -> dict[str, np.ndarray]:
        input_ids = np.stack(examples)
        batch, seq = input_ids.shape
        return {
            "input_ids": input_ids,
            "labels": input_ids.copy(),
            "segment_ids": np.ones((batch, seq), np.int32),
            "position_ids": np.broadcast_to(np.arange(seq, dtype=np.int32), (batch, seq)).copy(),
        }
