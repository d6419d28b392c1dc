"""Base datamodule: set up, then seeded batch streams.

Counterpart of `llm_training_tpu/data/base.py` (numpy, copied): the batch
order is a pure function of (seed, epoch, step), so a stream started at
`start_step` is the same stream from there on.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterator

import numpy as np


@dataclass
class BaseDataModuleConfig:
    batch_size: int = 1
    validation_split: float | int | None = None
    seed: int = 42


class BaseDataModule:
    """Subclasses implement `setup()` filling `self.train_dataset` /
    `self.val_dataset` (sequences of examples) and `collate(examples)`."""

    def __init__(self, config: BaseDataModuleConfig):
        self.config = config
        self.train_dataset: Any = None
        self.val_dataset: Any = None

    def setup(self) -> None:
        raise NotImplementedError

    def collate(self, examples: list[Any]) -> dict[str, np.ndarray]:
        raise NotImplementedError

    def _batch_indices(self, n: int, epoch: int, shuffle: bool) -> np.ndarray:
        order = np.arange(n)
        if shuffle:
            order = np.random.default_rng((self.config.seed, epoch)).permutation(n)
        usable = (n // self.config.batch_size) * self.config.batch_size
        return order[:usable].reshape(-1, self.config.batch_size)

    def steps_per_epoch(self) -> int:
        return len(self.train_dataset) // self.config.batch_size

    def train_batches(self, start_step: int = 0) -> Iterator[dict[str, np.ndarray]]:
        """Infinite shuffled stream, deterministic in (seed, step)."""
        step = 0
        epoch = 0
        while True:
            for row in self._batch_indices(len(self.train_dataset), epoch, shuffle=True):
                if step >= start_step:
                    yield self.collate([self.train_dataset[int(i)] for i in row])
                step += 1
            epoch += 1

    def val_batches(self) -> Iterator[dict[str, np.ndarray]]:
        if self.val_dataset is None:
            return
        for row in self._batch_indices(len(self.val_dataset), 0, shuffle=False):
            yield self.collate([self.val_dataset[int(i)] for i in row])
