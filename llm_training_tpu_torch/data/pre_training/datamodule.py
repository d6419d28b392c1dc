"""Pre-training data: tokenize -> stride-truncate -> pack -> sample.

Counterpart of `llm_training_tpu/data/pre_training/datamodule.py`:
- each document becomes BOS + tokens + EOS, empty texts dropped;
- overlong documents split into windows every `stride` tokens;
- naive packing: greedy concatenation per source, rows cut at exactly
  `max_length`, per-row segment ids from 1;
- best-fit-decreasing packing per source (`packing.py`: the host
  packer), no document spanning rows;
- per-source sampling with integer and fractional rates, seed 42;
- per-split, per-source token tables.

The functions of the pipeline need no HF package; `datasets` is imported
only inside `PreTrainingDataModule`'s methods (the card's machine has none).
"""

from __future__ import annotations

import logging
import math
import random
from dataclasses import dataclass, field
from enum import Enum
from typing import Any

from llm_training_tpu_torch.data.hf_based import HFBasedDataModule, HFBasedDataModuleConfig
from llm_training_tpu_torch.data.pre_training.collator import PreTrainingDataCollator
from llm_training_tpu_torch.data.pre_training.packing import (  # noqa: F401 (JAX's names)
    best_fit_bin_packing,
    best_fit_bin_packing_py,
)
from llm_training_tpu_torch.data.pre_training.packing import (
    best_fit_decreasing as _best_fit_decreasing,
)
from llm_training_tpu_torch.data.tokenizer import resolve_tokenizer

logger = logging.getLogger(__name__)


class PackingMethod(str, Enum):
    NO_PACKING = "no_packing"
    NAIVE_PACKING = "naive_packing"
    BEST_FIT_BIN_PACKING = "best_fit_bin_packing"


@dataclass(kw_only=True)
class PreTrainingDataModuleConfig(HFBasedDataModuleConfig):
    tokenizer: Any  # a path, a {path, pad_token, ...} mapping or a tokenizer
    max_length: int | None = None
    stride: int | None = None
    packing_method: PackingMethod = PackingMethod.NAIVE_PACKING
    sample_rate: dict[str, float] = field(default_factory=dict)
    pre_processing_batch_size: int = 1000
    pad_to_multiple_of: int | None = None

    def __post_init__(self):
        self.tokenizer = resolve_tokenizer(self.tokenizer)
        self.packing_method = PackingMethod(self.packing_method)  # values only, as JAX's
        if self.packing_method != PackingMethod.NO_PACKING and self.max_length is None:
            raise ValueError("max_length is required when packing")
        if self.stride is None:
            self.stride = self.max_length
        elif self.max_length is None:
            raise ValueError("stride requires max_length")
        elif self.stride > self.max_length:
            raise ValueError("stride must be <= max_length")


def _tokenize_batch(batch: dict[str, list], tokenizer: Any) -> dict[str, list]:
    """Each document becomes BOS + tokens + EOS; empty texts are dropped."""
    keep = [i for i, text in enumerate(batch["text"]) if text]
    texts = [batch["text"][i] for i in keep]
    sources = [(batch["source"][i] if "source" in batch else "default") for i in keep]
    encoded = tokenizer(texts, add_special_tokens=False, return_attention_mask=False)["input_ids"]
    # BOS-less (Qwen/GPT-2-style) and EOS-less tokenizers get no sentinel
    prefix = [tokenizer.bos_token_id] if tokenizer.bos_token_id is not None else []
    suffix = [tokenizer.eos_token_id] if tokenizer.eos_token_id is not None else []
    input_ids = [[*prefix, *ids, *suffix] for ids in encoded]
    return {
        "source": sources,
        "input_ids": input_ids,
        "length": [len(ids) for ids in input_ids],
    }


def _truncate_batch(batch: dict[str, list], max_length: int, stride: int) -> dict[str, list]:
    """Split overlong documents into windows starting every `stride` tokens."""
    out = {"source": [], "input_ids": [], "length": []}
    for source, ids in zip(batch["source"], batch["input_ids"]):
        for start in range(0, len(ids), stride):
            window = ids[start : start + max_length]
            out["source"].append(source)
            out["input_ids"].append(window)
            out["length"].append(len(window))
    return out


def _flush(out: dict, source: str, ids: list[int], segs: list[int]) -> None:
    out["source"].append(source)
    out["input_ids"].append(ids)
    out["segment_ids"].append(segs)
    out["length"].append(len(ids))


def _naive_packing(batch: dict[str, list], max_length: int) -> dict[str, list]:
    """Greedy concatenation in arrival order, never mixing sources; rows are
    cut at exactly max_length, documents may span rows. Segment ids restart
    at 1 per row."""
    out = {"source": [], "input_ids": [], "segment_ids": [], "length": []}
    cur_source = None
    cur_ids: list[int] = []
    cur_segs: list[int] = []

    def renumber(segs: list[int]) -> list[int]:
        offset = segs[0] - 1
        return [s - offset for s in segs] if offset else segs

    for source, ids in zip(batch["source"], batch["input_ids"]):
        if source != cur_source and cur_ids:
            _flush(out, cur_source, cur_ids, renumber(cur_segs))
            cur_ids, cur_segs = [], []
        cur_source = source
        next_seg = cur_segs[-1] + 1 if cur_segs else 1
        cur_ids += ids
        cur_segs += [next_seg] * len(ids)
        while len(cur_ids) >= max_length:
            _flush(out, cur_source, cur_ids[:max_length], renumber(cur_segs[:max_length]))
            cur_ids = cur_ids[max_length:]
            cur_segs = cur_segs[max_length:]
    if cur_ids:
        _flush(out, cur_source, cur_ids, renumber(cur_segs))
    return out


def _pre_process(
    batch: dict[str, list],
    tokenizer: Any,
    max_length: int | None,
    stride: int | None,
    packing_method: str,
) -> dict[str, list]:
    batch = _tokenize_batch(batch, tokenizer)
    if max_length is not None:
        batch = _truncate_batch(batch, max_length, stride)
    if packing_method == PackingMethod.NAIVE_PACKING:
        batch = _naive_packing(batch, max_length)
    elif packing_method == PackingMethod.BEST_FIT_BIN_PACKING:
        batch = _best_fit_decreasing(batch, max_length)
    else:
        batch = {**batch, "segment_ids": [[1] * len(ids) for ids in batch["input_ids"]]}
    return batch


class PreTrainingDataModule(HFBasedDataModule):
    config: PreTrainingDataModuleConfig

    def __init__(self, config: PreTrainingDataModuleConfig):
        super().__init__(config)
        self.collator = PreTrainingDataCollator(config)

    def pre_process_data(self, dataset_dict):
        from datasets import Features, Sequence, Value

        for name, dataset in dataset_dict.items():
            if "source" in dataset.column_names:
                dataset_dict[name] = dataset.sort("source")
        return self.map_dataset_dict(
            dataset_dict,
            _pre_process,
            fn_kwargs=dict(
                tokenizer=self.config.tokenizer,
                max_length=self.config.max_length,
                stride=self.config.stride,
                packing_method=self.config.packing_method.value,
            ),
            batched=True,
            batch_size=self.config.pre_processing_batch_size,
            remove_columns=True,
            features=Features(
                {
                    "source": Value("string"),
                    "input_ids": Sequence(Value("int32")),
                    "segment_ids": Sequence(Value("uint16")),
                    "length": Value("uint32"),
                }
            ),
            desc="Pre-processing data",
        )

    def post_process_data(self, dataset_dict):
        if "train" in dataset_dict and self.config.sample_rate:
            dataset_dict["train"] = self.sample_data(dataset_dict["train"])
        return dataset_dict

    def sample_data(self, dataset):
        """Integer part replicates the source, fractional part samples it
        (seed 42)."""
        sample_rate = self.config.sample_rate
        if all(rate == 1.0 for rate in sample_rate.values()):
            return dataset
        by_source: dict[str, list[int]] = {}
        for i, source in enumerate(dataset["source"]):
            by_source.setdefault(source, []).append(i)
        rng = random.Random(42)
        unused = dict(sample_rate)
        selected: list[int] = []
        for source, indices in by_source.items():
            rate = sample_rate.get(source, 1.0)
            unused.pop(source, None)
            frac, integer = math.modf(rate)
            selected += indices * int(integer)
            if frac > 0:
                selected += rng.sample(indices, k=int(len(indices) * frac))
        if unused:
            logger.warning("sample_rate sources not in dataset: %s", sorted(unused))
        return dataset.select(selected)

    def collate(self, examples: list[dict]) -> dict:
        return self.collator(examples)

    def tokens_table(self) -> str:
        """Per-split, per-source token counts."""
        lines = [f"{'Split':<12} {'Source':<20} {'Tokens':>14}"]
        for name, dataset in self.dataset_dict.items():
            totals: dict[str, int] = {}
            for source, length in zip(dataset["source"], dataset["length"]):
                totals[source] = totals.get(source, 0) + int(length)
            lines.append(f"{name:<12} {'*':<20} {sum(totals.values()):>14,}")
            for source in sorted(totals):
                lines.append(f"{name:<12} {source:<20} {totals[source]:>14,}")
        return "\n".join(lines)
