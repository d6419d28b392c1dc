"""Tokenizer resolution.

Counterpart of `llm_training_tpu/data/tokenizer.py`: a config names the
tokenizer by a local path, by a `{path, pad_token, ...}` mapping (the other
keys go to `AutoTokenizer.from_pretrained`), or hands in a tokenizer
object. `transformers` is imported only here, inside the function: the
card's machine has no HF packages, and importing this module needs none.
"""

from __future__ import annotations

from typing import Any


def resolve_tokenizer(value: Any) -> Any:
    if hasattr(value, "get_vocab"):
        return value
    from transformers import AutoTokenizer

    if isinstance(value, str):
        return AutoTokenizer.from_pretrained(value)
    if isinstance(value, dict):
        kwargs = dict(value)
        path = kwargs.pop("path")
        pad_token = kwargs.pop("pad_token", None)
        tokenizer = AutoTokenizer.from_pretrained(path, **kwargs)
        if pad_token is not None:
            tokenizer.pad_token = pad_token
        return tokenizer
    raise TypeError(f"cannot resolve tokenizer from {type(value)}")
