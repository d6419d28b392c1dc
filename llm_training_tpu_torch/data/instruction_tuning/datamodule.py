"""Instruction-tuning data: chat template -> assistant-mask labels -> pack.

Counterpart of `llm_training_tpu/data/instruction_tuning/datamodule.py`:
- the chat template applied with `{% generation %}` assistant masks, the
  labels -100 outside the assistant's tokens; `tokenizers >= 0.20.1` is
  required (older ones mis-mask Llama-3 prompts);
- a default system prompt injected into an example without one with
  probability `add_default_system_prompt_rate`, drawn per example from
  `(seed, index)`, so it is stable across runs and `num_proc` shards;
- overlong examples dropped or truncated;
- GROUP_BY_LENGTH packing: length-sorted best fit (the host packer) with
  per-example segment ids; no example spans rows.

Examples hold `{"messages": [{"role": ..., "content": ...}, ...]}`. The
overlong handling, the packers and the collator need no HF package: the
card's machine, which has none, runs them on rows tokenized elsewhere.
`datasets`, `tokenizers` and `packaging` are imported only inside
`InstructionTuningDataModule` and its config's `__post_init__`.
"""

from __future__ import annotations

import logging
import random
from dataclasses import dataclass
from enum import Enum
from typing import Any

from llm_training_tpu_torch.data.chat_templates import get_chat_template
from llm_training_tpu_torch.data.hf_based import HFBasedDataModule, HFBasedDataModuleConfig
from llm_training_tpu_torch.data.instruction_tuning.collator import InstructionTuningDataCollator
from llm_training_tpu_torch.data.pre_training.packing import best_fit_bin_packing
from llm_training_tpu_torch.data.tokenizer import resolve_tokenizer

logger = logging.getLogger(__name__)


class OverlongHandlingMethod(str, Enum):
    DROP = "drop"
    TRUNCATE = "truncate"


class PackingMethod(str, Enum):
    NO_PACKING = "no_packing"
    GROUP_BY_LENGTH = "group_by_length"


@dataclass(kw_only=True)
class InstructionTuningDataModuleConfig(HFBasedDataModuleConfig):
    tokenizer: Any
    chat_template: str | None = None
    max_length: int | None = None
    overlong_handling_method: OverlongHandlingMethod = OverlongHandlingMethod.DROP
    packing_method: PackingMethod = PackingMethod.NO_PACKING
    pad_to_multiple_of: int | None = None
    add_default_system_prompt_rate: float | None = None
    default_system_prompt: str | None = None

    def __post_init__(self):
        import tokenizers
        from packaging.version import Version

        self.tokenizer = resolve_tokenizer(self.tokenizer)
        if self.chat_template is not None:
            self.chat_template = get_chat_template(self.chat_template)
        # values only, as JAX's pydantic enums
        self.overlong_handling_method = OverlongHandlingMethod(self.overlong_handling_method)
        self.packing_method = PackingMethod(self.packing_method)
        if Version(tokenizers.__version__) < Version("0.20.1"):
            raise RuntimeError("tokenizers >= 0.20.1 required for assistant masks")
        if self.default_system_prompt and self.add_default_system_prompt_rate is None:
            raise ValueError(
                "add_default_system_prompt_rate is required with default_system_prompt"
            )
        if self.packing_method == PackingMethod.GROUP_BY_LENGTH and self.max_length is None:
            raise ValueError("max_length is required for group_by_length packing")


def _apply_template_and_tokenize(
    batch: dict[str, list],
    indices: list[int],
    tokenizer: Any,
    chat_template: str | None,
    default_system_prompt: str | None,
    add_rate: float | None,
    seed: int,
) -> dict[str, list]:
    conversations = []
    for idx, messages in zip(indices, batch["messages"]):
        messages = list(messages)
        has_system = any(m["role"] == "system" for m in messages)
        if default_system_prompt and not has_system:
            # per-example seeded draw: stable across runs and num_proc shards
            if random.Random(f"{seed}-{idx}").random() < add_rate:
                messages.insert(0, {"role": "system", "content": default_system_prompt})
        conversations.append(messages)

    encoded = tokenizer.apply_chat_template(
        conversations,
        chat_template=chat_template,
        return_dict=True,
        return_assistant_tokens_mask=True,
        tokenizer_kwargs=dict(return_attention_mask=False, verbose=False),
    )
    out = {"input_ids": [], "labels": [], "length": []}
    for input_ids, mask in zip(encoded["input_ids"], encoded["assistant_masks"]):
        out["input_ids"].append(input_ids)
        out["labels"].append([t if m == 1 else -100 for t, m in zip(input_ids, mask)])
        out["length"].append(len(input_ids))
    return out


def _handle_overlong(batch: dict[str, list], max_length: int, method: str) -> dict[str, list]:
    """DROP keeps the examples of at most `max_length` tokens; TRUNCATE cuts
    every example (tokens and labels) to `max_length`."""
    if method == OverlongHandlingMethod.DROP:
        keep = [i for i, n in enumerate(batch["length"]) if n <= max_length]
        return {k: [v[i] for i in keep] for k, v in batch.items()}
    return {
        "input_ids": [ids[:max_length] for ids in batch["input_ids"]],
        "labels": [l[:max_length] for l in batch["labels"]],  # noqa: E741
        "length": [min(n, max_length) for n in batch["length"]],
    }


def _group_by_length_packing(batch: dict[str, list], max_length: int) -> dict[str, list]:
    """Examples sorted by length, longest first, best-fit into rows of
    `max_length`; each example's tokens and labels whole in one row under
    its own segment id (1..N in the row)."""
    indices = sorted(range(len(batch["length"])), key=batch["length"].__getitem__, reverse=True)
    lengths = [batch["length"][i] for i in indices]
    out = {"input_ids": [], "labels": [], "segment_ids": [], "length": []}
    for group in best_fit_bin_packing(max_length, lengths):
        ids: list[int] = []
        labels: list[int] = []
        segs: list[int] = []
        for doc_num, local in enumerate(group, start=1):
            example = indices[local]
            ids += batch["input_ids"][example]
            labels += batch["labels"][example]
            segs += [doc_num] * batch["length"][example]
        out["input_ids"].append(ids)
        out["labels"].append(labels)
        out["segment_ids"].append(segs)
        out["length"].append(len(ids))
    return out


def _add_trivial_segments(batch: dict[str, list]) -> dict[str, list]:
    return {**batch, "segment_ids": [[1] * n for n in batch["length"]]}


class InstructionTuningDataModule(HFBasedDataModule):
    config: InstructionTuningDataModuleConfig

    def __init__(self, config: InstructionTuningDataModuleConfig):
        super().__init__(config)
        self.collator = InstructionTuningDataCollator(config)

    def pre_process_data(self, dataset_dict):
        from datasets import Features, Sequence, Value

        cfg = self.config
        dataset_dict = self.map_dataset_dict(
            dataset_dict,
            _apply_template_and_tokenize,
            fn_kwargs=dict(
                tokenizer=cfg.tokenizer,
                chat_template=cfg.chat_template,
                default_system_prompt=cfg.default_system_prompt,
                add_rate=cfg.add_default_system_prompt_rate,
                seed=cfg.seed,
            ),
            batched=True,
            with_indices=True,
            remove_columns=True,
            desc="Applying chat template",
        )
        if cfg.max_length is not None:
            dataset_dict = self.map_dataset_dict(
                dataset_dict,
                _handle_overlong,
                fn_kwargs=dict(max_length=cfg.max_length, method=cfg.overlong_handling_method.value),
                batched=True,
                desc="Handling overlong examples",
            )
        grouped = cfg.packing_method == PackingMethod.GROUP_BY_LENGTH
        return self.map_dataset_dict(
            dataset_dict,
            _group_by_length_packing if grouped else _add_trivial_segments,
            fn_kwargs=dict(max_length=cfg.max_length) if grouped else {},
            batched=True,
            batch_size=10000,
            remove_columns=True,
            features=Features(
                {
                    "input_ids": Sequence(Value("int32")),
                    "labels": Sequence(Value("int32")),
                    "segment_ids": Sequence(Value("uint16")),
                    "length": Value("uint32"),
                }
            ),
            desc="Packing",
        )

    def collate(self, examples: list[dict]) -> dict:
        return self.collator(examples)
