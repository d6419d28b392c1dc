"""Base datamodule: set up, then seeded batch streams.

Counterpart of `llm_training_tpu/data/base.py` (numpy, copied): the batch
order is a pure function of (seed, epoch, step), so a stream started at
`start_step` is the same stream from there on. With a skip list
(`resilience.DataSkipList`, which the trainer passes when rollback-and-skip
recovery is on) it is a pure function of (seed, step, windows, reserve).
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

    def train_batches(
        self, start_step: int = 0, skip_list: Any | None = None
    ) -> Iterator[dict[str, np.ndarray]]:
        """Infinite shuffled stream, deterministic in (seed, step).

        With `skip_list` the LAST `skip_list.reserve` batches of every epoch
        permutation are held out as a replacement pool, and a step inside a
        poisoned window serves the next reserved batch instead of its own,
        as JAX's stream does: a resumed run, or a clean run configured with
        the same windows, replays the identical batch sequence. With
        `skip_list=None` the stream is byte-identical to the plain one."""
        step = 0
        epoch = 0
        reserve = int(getattr(skip_list, "reserve", 0)) if skip_list is not None else 0
        while True:
            batches = self._batch_indices(len(self.train_dataset), epoch, shuffle=True)
            if reserve:
                if reserve >= len(batches):
                    raise ValueError(
                        f"recovery reserve ({reserve} batches/epoch) consumes the whole epoch "
                        f"({len(batches)} batches); shrink recovery.reserve_batches or the "
                        "skip budget"
                    )
                served, pool = batches[:-reserve], batches[-reserve:]
            else:
                served, pool = batches, batches[:0]
            epoch_start = step
            for row in served:
                if skip_list is not None and skip_list.is_skipped(step):
                    replacement = skip_list.replacement_row(step, epoch_start, pool)
                    row = replacement if replacement is not None else row
                if step >= start_step:
                    yield self.collate([self.train_dataset[int(i)] for i in row])
                step += 1
            epoch += 1

    def val_batches(self) -> Iterator[dict[str, np.ndarray]]:
        if self.val_dataset is None:
            return
        for row in self._batch_indices(len(self.val_dataset), 0, shuffle=False):
            yield self.collate([self.val_dataset[int(i)] for i in row])
