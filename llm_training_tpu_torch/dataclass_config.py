"""Config dataclasses built from plain mappings (the JSON config files).

The JAX package validates its configs with pydantic (`extra="forbid"`);
the card's machine has no pydantic, so the port's configs are dataclasses
and this builder gives them the same contract: unknown keys raise, nested
dataclass fields are built from nested mappings.
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Any, Mapping


def build_dataclass(cls: type, data: Mapping[str, Any] | None, where: str = "") -> Any:
    """`cls(**data)`, recursing into fields whose type is a dataclass (or
    an optional one). Raises ValueError naming unknown keys."""
    if data is None:
        data = {}
    where = where or cls.__name__
    hints = typing.get_type_hints(cls)
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(data) - names)
    if unknown:
        raise ValueError(f"{where}: unknown field(s) {unknown} (known: {sorted(names)})")
    kwargs = {}
    for key, value in data.items():
        nested = _dataclass_in(hints.get(key))
        if nested is not None and isinstance(value, Mapping):
            value = build_dataclass(nested, value, f"{where}.{key}")
        kwargs[key] = value
    return cls(**kwargs)


def _dataclass_in(hint: Any) -> type | None:
    if dataclasses.is_dataclass(hint):
        return hint
    for arg in typing.get_args(hint):
        if dataclasses.is_dataclass(arg):
            return arg
    return None
