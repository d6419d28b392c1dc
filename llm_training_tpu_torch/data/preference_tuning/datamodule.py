"""Preference-pair data (DPO, ORPO).

Counterpart of `llm_training_tpu/data/preference_tuning/datamodule.py`:
`{prompt, chosen, rejected}` rows become two tokenized streams, each the
chat template over a user turn and an assistant turn with the assistant
mask as labels (-100 elsewhere); a pair whose longer side exceeds
`max_length` is dropped. `datasets` is imported only inside
`PreferenceTuningDataModule`'s methods.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from llm_training_tpu_torch.data.chat_templates import get_chat_template
from llm_training_tpu_torch.data.hf_based import HFBasedDataModule, HFBasedDataModuleConfig
from llm_training_tpu_torch.data.preference_tuning.collator import PreferenceTuningDataCollator
from llm_training_tpu_torch.data.tokenizer import resolve_tokenizer


@dataclass(kw_only=True)
class PreferenceTuningDataModuleConfig(HFBasedDataModuleConfig):
    tokenizer: Any
    chat_template: str | None = None
    max_length: int | None = None
    pad_to_multiple_of: int | None = None

    def __post_init__(self):
        self.tokenizer = resolve_tokenizer(self.tokenizer)
        if self.chat_template is not None:
            self.chat_template = get_chat_template(self.chat_template)


def _tokenize_pairs(
    batch: dict[str, list], tokenizer: Any, chat_template: str | None
) -> dict[str, list]:
    out: dict[str, list] = {}
    for side in ("chosen", "rejected"):
        conversations = [
            [{"role": "user", "content": prompt}, {"role": "assistant", "content": answer}]
            for prompt, answer in zip(batch["prompt"], batch[side])
        ]
        encoded = tokenizer.apply_chat_template(
            conversations,
            chat_template=chat_template,
            return_dict=True,
            return_assistant_tokens_mask=True,
            tokenizer_kwargs=dict(return_attention_mask=False, verbose=False),
        )
        out[f"{side}_input_ids"] = encoded["input_ids"]
        out[f"{side}_labels"] = [
            [t if m == 1 else -100 for t, m in zip(ids, mask)]
            for ids, mask in zip(encoded["input_ids"], encoded["assistant_masks"])
        ]
        out[f"{side}_length"] = [len(ids) for ids in encoded["input_ids"]]
    return out


def _drop_overlong(batch: dict[str, list], max_length: int) -> dict[str, list]:
    keep = [
        i
        for i in range(len(batch["chosen_length"]))
        if max(batch["chosen_length"][i], batch["rejected_length"][i]) <= max_length
    ]
    return {k: [v[i] for i in keep] for k, v in batch.items()}


class PreferenceTuningDataModule(HFBasedDataModule):
    config: PreferenceTuningDataModuleConfig

    def __init__(self, config: PreferenceTuningDataModuleConfig):
        super().__init__(config)
        self.collator = PreferenceTuningDataCollator(config)

    def pre_process_data(self, dataset_dict):
        from datasets import Features, Sequence, Value

        cfg = self.config
        features = Features(
            {
                f"{side}_{name}": (
                    Sequence(Value("int32")) if name != "length" else Value("uint32")
                )
                for side in ("chosen", "rejected")
                for name in ("input_ids", "labels", "length")
            }
        )
        dataset_dict = self.map_dataset_dict(
            dataset_dict,
            _tokenize_pairs,
            fn_kwargs=dict(tokenizer=cfg.tokenizer, chat_template=cfg.chat_template),
            batched=True,
            remove_columns=True,
            features=features,
            desc="Tokenizing preference pairs",
        )
        if cfg.max_length is not None:
            dataset_dict = self.map_dataset_dict(
                dataset_dict,
                _drop_overlong,
                fn_kwargs=dict(max_length=cfg.max_length),
                batched=True,
                desc="Dropping overlong pairs",
            )
        return dataset_dict

    def collate(self, examples: list[dict]) -> dict:
        return self.collator(examples)
