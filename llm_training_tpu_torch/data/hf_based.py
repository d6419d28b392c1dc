"""HF-datasets-backed data module with fingerprint-stable caching.

Counterpart of `llm_training_tpu/data/hf_based.py`: `datasets.load_dataset`
over `dataset_kwargs`, the seed-42 train/validation split, saving and
loading the pre-processed data, and `.map` under a deterministic
fingerprint (the map function's module source, its kwargs, tokenizers
hashed by content: `hash_tokenizer`), so the cache hits across processes.

The fingerprint hashes this package's module source, so the port's cache
entries are its own and never JAX's (ROADMAP C.32). `datasets` is imported
only inside the methods: the card's machine has no HF packages, and
importing this module needs none.
"""

from __future__ import annotations

import hashlib
import inspect
import logging
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable

from llm_training_tpu_torch.data.base import BaseDataModule, BaseDataModuleConfig

logger = logging.getLogger(__name__)


def hash_tokenizer(tokenizer: Any) -> str:
    """Content hash of a tokenizer (its type, serialized state or vocabulary,
    and special tokens), stable across processes; JAX's hash."""
    h = hashlib.sha256()
    h.update(str(type(tokenizer)).encode())
    if hasattr(tokenizer, "_tokenizer"):  # fast tokenizer: serialized state
        h.update(tokenizer._tokenizer.to_str().encode())
    else:
        h.update(repr(sorted(tokenizer.get_vocab().items())).encode())
    h.update(repr(sorted((tokenizer.special_tokens_map or {}).items())).encode())
    return h.hexdigest()


@dataclass(kw_only=True)
class HFBasedDataModuleConfig(BaseDataModuleConfig):
    dataset_kwargs: dict | None = None
    num_proc: int | None = None
    enable_cache: bool = True
    cleanup_cache_files: bool = False
    pre_processed_data_path: str | None = None


class HFBasedDataModule(BaseDataModule):
    config: HFBasedDataModuleConfig

    def load_data(self):
        import datasets

        dataset = datasets.load_dataset(**(self.config.dataset_kwargs or {}))
        if isinstance(dataset, datasets.Dataset):
            dataset = datasets.DatasetDict(train=dataset)
        return dataset

    def pre_process_data(self, dataset_dict):
        return dataset_dict

    def post_process_data(self, dataset_dict):
        return dataset_dict

    def split_data(self, dataset_dict):
        """The seed-42 train/validation split: `validation_split` rows when
        >= 1, else that fraction (at least one row)."""
        from datasets import DatasetDict

        split = self.config.validation_split
        if split and "validation" not in dataset_dict:
            train = dataset_dict["train"]
            n_val = int(split) if split >= 1 else max(1, int(len(train) * split))
            parts = train.train_test_split(test_size=n_val, seed=42)
            dataset_dict = DatasetDict(
                {**dataset_dict, "train": parts["train"], "validation": parts["test"]}
            )
        return dataset_dict

    def setup(self) -> None:
        path = self.config.pre_processed_data_path
        if path and Path(path).exists():
            import datasets

            logger.info("loading pre-processed data from %s", path)
            dataset_dict = datasets.load_from_disk(path)
        else:
            dataset_dict = self.load_data()
            if self.config.cleanup_cache_files:
                # before any processing, so no cache file backing the
                # datasets about to be made is deleted
                dataset_dict.cleanup_cache_files()
            dataset_dict = self.pre_process_data(dataset_dict)
        self.pre_processed_dataset_dict = dataset_dict
        dataset_dict = self.split_data(dataset_dict)
        dataset_dict = self.post_process_data(dataset_dict)
        self.dataset_dict = dataset_dict
        self.train_dataset = dataset_dict.get("train")
        self.val_dataset = dataset_dict.get("validation")

    def save_pre_processed_data(self, path: str | None = None) -> None:
        path = path or self.config.pre_processed_data_path
        if path is None:
            raise ValueError("pre_processed_data_path is required")
        self.pre_processed_dataset_dict.save_to_disk(path)
        logger.info("saved pre-processed data to %s", path)

    def map_dataset_dict(
        self,
        dataset_dict,
        function: Callable,
        fn_kwargs: dict[str, Any] | None = None,
        remove_columns: bool | list[str] = False,
        **map_kwargs: Any,
    ):
        """`.map` over every split with a deterministic fingerprint: the
        function's name and its WHOLE module's source (an edit to a helper
        beside it invalidates the cache), each kwarg (tokenizers by
        `hash_tokenizer`), the split's own fingerprint and the map's
        kwargs."""
        from datasets import DatasetDict
        from datasets.fingerprint import Hasher

        fn_kwargs = fn_kwargs or {}
        hash_parts = [function.__qualname__, inspect.getsource(inspect.getmodule(function))]
        for key in sorted(fn_kwargs):
            value = fn_kwargs[key]
            if hasattr(value, "get_vocab"):
                hash_parts.append(f"{key}=tokenizer:{hash_tokenizer(value)}")
            else:
                hash_parts.append(f"{key}={Hasher.hash(value)}")

        out = {}
        for name, dataset in dataset_dict.items():
            if remove_columns is True:
                map_kwargs["remove_columns"] = dataset.column_names
            elif remove_columns:
                map_kwargs["remove_columns"] = remove_columns
            # per split: the resolved remove_columns list is part of it
            kwargs_hash = Hasher.hash(
                {k: v for k, v in sorted(map_kwargs.items()) if k != "desc"}
            )
            fingerprint = Hasher.hash([dataset._fingerprint, kwargs_hash] + hash_parts)
            if not self.config.enable_cache:
                fingerprint = None
            out[name] = dataset.map(
                function,
                fn_kwargs=fn_kwargs,
                num_proc=self.config.num_proc if len(dataset) > 1 else None,
                new_fingerprint=fingerprint,
                load_from_cache_file=self.config.enable_cache,
                **map_kwargs,
            )
        return DatasetDict(out)
