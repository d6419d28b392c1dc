"""HuggingFace checkpoint I/O: streamed safetensors loading and export.

Counterpart of `llm_training_tpu/models/hf_io.py`, with the port's own
safetensors reader and writer (the format is an 8-byte little-endian
header length, a JSON header of `{name: {dtype, shape, data_offsets}}` and
`__metadata__`, then the raw little-endian bytes), so the package needs no
`safetensors`:

- `LazyStateDict` maps a single file, an index with shards, or every
  `*.safetensors` of a directory; it memory-maps each file and copies one
  tensor out per access (bf16 as raw 16-bit words viewed as bf16);
- `load_pretrained_params` converts each tensor through the family's
  `params_from_hf` and, given a target state dict, places it there before
  the next is read: a narrowing cast on the host (the copy to the card
  ships the small tensor), a widening one on the card (a host-side cast
  would hold the checkpoint's and the widened copy at once);
- `save_hf_checkpoint` writes JAX's layout: greedy shards of at most
  5 GiB in key order, `model-0000i-of-0000n.safetensors`, the index,
  `{"format": "pt"}` metadata, `config.json` and `generation_config.json`;
- `model_class_for_hf` routes an HF `model_type` over JAX's whole table;
  a type whose family the port lacks raises naming ROADMAP A.8.

The pipeline layout (JAX's `_pp_*` adapters) waits for ROADMAP A.9b:
`LlamaConfig` refuses `pipeline_stages > 1` naming it, so no staged model
reaches this module.
"""

from __future__ import annotations

import importlib
import json
import logging
import mmap
import struct
from collections.abc import Mapping
from pathlib import Path
from typing import Any

import torch

logger = logging.getLogger(__name__)

_SAFE_INDEX = "model.safetensors.index.json"
_SAFE_SINGLE = "model.safetensors"

# safetensors dtype names <-> torch dtypes
_DTYPES: dict[str, torch.dtype] = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}
_NAMES = {dtype: name for name, dtype in _DTYPES.items()}
# the integer type whose raw words a floating type is read as and written from
_WORDS = {torch.bfloat16: torch.int16, torch.float16: torch.int16}

# config class name -> conversion module (params_from_hf, params_to_hf,
# config_from_hf, config_to_hf): the families the port has
_FAMILIES: dict[str, str] = {
    "LlamaConfig": "llm_training_tpu_torch.models.llama.hf_conversion",
    "Phi3Config": "llm_training_tpu_torch.models.phi3.hf_conversion",
    "GemmaConfig": "llm_training_tpu_torch.models.gemma.hf_conversion",
    "DeepseekConfig": "llm_training_tpu_torch.models.deepseek.hf_conversion",
    "Glm4MoeConfig": "llm_training_tpu_torch.models.glm4_moe.hf_conversion",
    "GptOssConfig": "llm_training_tpu_torch.models.gpt_oss.hf_conversion",
    "Ernie45MoeConfig": "llm_training_tpu_torch.models.ernie45_moe.hf_conversion",
    "HunYuanMoeConfig": "llm_training_tpu_torch.models.hunyuan_moe.hf_conversion",
    "Qwen3NextConfig": "llm_training_tpu_torch.models.qwen3_next.hf_conversion",
    "MiniMaxConfig": "llm_training_tpu_torch.models.minimax.hf_conversion",
    "BambaConfig": "llm_training_tpu_torch.models.bamba.hf_conversion",
}


def conversion_module(config: Any):
    name = type(config).__name__
    if name not in _FAMILIES:
        raise ValueError(f"no HF conversion registered for {name}; known: {sorted(_FAMILIES)}")
    return importlib.import_module(_FAMILIES[name])


class SafetensorsFile:
    """One safetensors file: its header parsed, its bytes memory-mapped
    (copy-on-write, so the file is never written)."""

    def __init__(self, path: Path):
        self.path = path
        with open(path, "rb") as f:
            (size,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(size))
            self._map = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        self.metadata = header.pop("__metadata__", None)
        self.entries: dict[str, dict] = header
        self._data_start = 8 + size

    def keys(self) -> list[str]:
        return list(self.entries)

    def get_tensor(self, key: str) -> torch.Tensor:
        """A copy of tensor `key` on the host."""
        entry = self.entries[key]
        dtype = _DTYPES.get(entry["dtype"])
        if dtype is None:
            raise ValueError(f"{self.path}: {key} has dtype {entry['dtype']}, which the port "
                             f"does not read (known: {sorted(_DTYPES)})")
        begin, end = entry["data_offsets"]
        shape = entry["shape"]
        word = _WORDS.get(dtype, dtype)
        count = (end - begin) // torch.empty((), dtype=word).element_size()
        if count == 0:
            return torch.empty(shape, dtype=dtype)
        raw = torch.frombuffer(self._map, dtype=word, count=count,
                               offset=self._data_start + begin)
        return raw.view(dtype).reshape(shape).clone()


class LazyStateDict(Mapping):
    """Mapping over one or more safetensors files that reads each tensor on
    access (and holds no more than the caller keeps alive)."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._key_to_file: dict[str, SafetensorsFile] = {}
        for file in self._discover():
            opened = SafetensorsFile(file)
            for key in opened.keys():
                self._key_to_file[key] = opened

    def _discover(self) -> list[Path]:
        if self.path.is_file():
            files = [self.path]
        elif (self.path / _SAFE_INDEX).exists():
            index = json.loads((self.path / _SAFE_INDEX).read_text())
            files = sorted({self.path / f for f in index["weight_map"].values()})
        elif (self.path / _SAFE_SINGLE).exists():
            files = [self.path / _SAFE_SINGLE]
        else:
            files = sorted(self.path.glob("*.safetensors"))
        if not files:
            raise FileNotFoundError(
                f"no safetensors found under {self.path} "
                f"(expected {_SAFE_SINGLE} or {_SAFE_INDEX})"
            )
        return files

    def __getitem__(self, key: str) -> torch.Tensor:
        return self._key_to_file[key].get_tensor(key)

    def __iter__(self):
        return iter(self._key_to_file)

    def __len__(self) -> int:
        return len(self._key_to_file)


def load_hf_config(path: str | Path) -> dict:
    config_file = Path(path) / "config.json" if Path(path).is_dir() else Path(path)
    return json.loads(config_file.read_text())


def load_pretrained_params(
    config: Any,
    hf_path: str | Path | Mapping,
    into: Mapping[str, torch.Tensor] | None = None,
) -> dict[str, torch.Tensor]:
    """HF checkpoint dir (or an in-memory mapping of HF keys) -> the port's
    state dict for `config`. Without `into`, host tensors in the
    checkpoint's dtype. With `into` (a module's `state_dict()`), each
    tensor is copied into its target, on the target's device and in its
    dtype, before the next is read; the targets are returned."""
    conv = conversion_module(config)
    state_dict = hf_path if isinstance(hf_path, Mapping) else LazyStateDict(hf_path)
    if into is None:
        return conv.params_from_hf(state_dict, config)
    missing = set(into)

    def place(name: str, value: torch.Tensor) -> torch.Tensor:
        target = into[name]
        if tuple(value.shape) != tuple(target.shape):
            raise ValueError(f"{name}: checkpoint shape {tuple(value.shape)} does not match "
                             f"the model's {tuple(target.shape)}")
        if target.dtype.itemsize < value.dtype.itemsize:
            value = value.to(target.dtype)  # narrowing: on the host
        with torch.no_grad():
            # widening happens on the target's device
            target.copy_(value.to(target.device))
        missing.discard(name)
        return target

    out = conv.params_from_hf(state_dict, config, leaf_fn=place)
    if missing:
        raise ValueError(f"the checkpoint left {sorted(missing)[:4]} of the model unset")
    return out


def save_hf_checkpoint(
    params: Mapping[str, torch.Tensor],
    config: Any,
    output_dir: str | Path,
    dtype: str = "bfloat16",
    max_shard_bytes: int = 5 * 1024**3,
    generation_config: dict | None = None,
) -> Path:
    """The port's state dict (on any device) + config -> an HF directory:
    safetensors shards (cast to `dtype` on the tensors' device, copied to
    the host one at a time), the index, `config.json`."""
    conv = conversion_module(config)
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    target = getattr(torch, dtype)
    state_dict = conv.params_to_hf(params, config)

    # shard greedily in key order, HF-style file naming
    shards: list[list[str]] = [[]]
    sizes = [0]
    for key, tensor in state_dict.items():
        nbytes = tensor.numel() * target.itemsize
        if sizes[-1] + nbytes > max_shard_bytes and shards[-1]:
            shards.append([])
            sizes.append(0)
        shards[-1].append(key)
        sizes[-1] += nbytes

    def write(path: Path, keys: list[str]) -> None:
        header: dict[str, Any] = {"__metadata__": {"format": "pt"}}
        offset = 0
        for key in keys:
            tensor = state_dict[key]
            nbytes = tensor.numel() * target.itemsize
            header[key] = {"dtype": _NAMES[target], "shape": list(tensor.shape),
                           "data_offsets": [offset, offset + nbytes]}
            offset += nbytes
        blob = json.dumps(header, separators=(",", ":")).encode()
        blob += b" " * (-len(blob) % 8)  # the data starts 8-byte aligned
        with open(path, "wb") as f:
            f.write(struct.pack("<Q", len(blob)))
            f.write(blob)
            for key in keys:
                host = state_dict[key].detach().to(target).contiguous().cpu()
                f.write(host.view(_WORDS.get(target, target)).numpy().data)

    if len(shards) == 1:
        write(output_dir / _SAFE_SINGLE, shards[0])
    else:
        weight_map = {}
        for i, keys in enumerate(shards):
            name = f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
            write(output_dir / name, keys)
            weight_map.update({key: name for key in keys})
        index = {"metadata": {"total_size": sum(sizes)}, "weight_map": weight_map}
        (output_dir / _SAFE_INDEX).write_text(json.dumps(index, indent=2))

    hf_config = conv.config_to_hf(config, torch_dtype=dtype)
    (output_dir / "config.json").write_text(json.dumps(hf_config, indent=2) + "\n")
    if generation_config:
        (output_dir / "generation_config.json").write_text(
            json.dumps(generation_config, indent=2) + "\n"
        )
    return output_dir


_LLAMA = "llm_training_tpu.models.Llama"
_ARCH_TO_FAMILY = {
    # HF model_type -> the JAX package's model class path (JAX's table)
    "llama": _LLAMA, "mistral": _LLAMA, "ministral": _LLAMA, "helium": _LLAMA,
    "arcee": _LLAMA, "seed_oss": _LLAMA, "qwen2": _LLAMA, "qwen3": _LLAMA, "olmo": _LLAMA,
    "olmo2": _LLAMA, "olmo3": _LLAMA, "granite": _LLAMA, "starcoder2": _LLAMA,
    "stablelm": _LLAMA, "cohere": _LLAMA, "cohere2": _LLAMA, "code_llama": _LLAMA,
    "phi": _LLAMA, "nemotron": _LLAMA, "ernie4_5": _LLAMA,
    "ernie4_5_moe": "llm_training_tpu.models.Ernie45Moe",
    "hunyuan_v1_dense": _LLAMA,
    "hunyuan_v1_moe": "llm_training_tpu.models.HunYuanMoe",
    "gpt2": _LLAMA, "gpt_neox": _LLAMA, "smollm3": _LLAMA, "exaone4": _LLAMA,
    "apertus": _LLAMA, "glm": _LLAMA, "glm4": _LLAMA,
    "glm4_moe": "llm_training_tpu.models.Glm4Moe",
    "dots1": "llm_training_tpu.models.Glm4Moe",
    "deepseek_v2": "llm_training_tpu.models.Deepseek",
    "deepseek_v3": "llm_training_tpu.models.Deepseek",
    "kimi_k2": "llm_training_tpu.models.Deepseek",
    "gpt_oss": "llm_training_tpu.models.GptOss",
    "qwen3_next": "llm_training_tpu.models.Qwen3Next",
    "minimax": "llm_training_tpu.models.MiniMax",
    "bamba": "llm_training_tpu.models.Bamba",
    "mixtral": _LLAMA, "phimoe": _LLAMA, "granitemoe": _LLAMA, "granitemoeshared": _LLAMA,
    "qwen2_moe": _LLAMA, "qwen3_moe": _LLAMA, "olmoe": _LLAMA, "flex_olmo": _LLAMA,
    "phi3": "llm_training_tpu.models.Phi3",
    "gemma": "llm_training_tpu.models.Gemma",
    "gemma2": "llm_training_tpu.models.Gemma",
    "gemma3_text": "llm_training_tpu.models.Gemma",
}
# the families of that table the port has: all of them
PORTED_FAMILIES = (_LLAMA, "llm_training_tpu.models.Phi3", "llm_training_tpu.models.Gemma",
                   "llm_training_tpu.models.Deepseek", "llm_training_tpu.models.Glm4Moe",
                   "llm_training_tpu.models.GptOss", "llm_training_tpu.models.Ernie45Moe",
                   "llm_training_tpu.models.HunYuanMoe", "llm_training_tpu.models.Qwen3Next",
                   "llm_training_tpu.models.MiniMax", "llm_training_tpu.models.Bamba")


def model_class_for_hf(hf_config: dict, assume_llama_layout: bool = False) -> str:
    """HF `config.json` -> the model class path JAX routes it to (the port
    maps the path onto its own class). `assume_llama_layout=True` routes an
    unknown model_type to the Llama family, whose conversion fails loudly
    on any key it does not know. A type whose family the port lacks raises
    naming that family and ROADMAP A.8."""
    model_type = hf_config.get("model_type")
    if model_type not in _ARCH_TO_FAMILY:
        if assume_llama_layout:
            logger.warning(
                "unknown HF model_type %r routed to the Llama family "
                "(assume_llama_layout=True): correctness depends on the "
                "checkpoint really using the llama graph/key layout",
                model_type,
            )
            return _LLAMA
        raise ValueError(
            f"unsupported HF model_type {model_type!r}; supported: "
            f"{sorted(_ARCH_TO_FAMILY)}. If the architecture is a renamed "
            "llama-layout fork, set assume_llama_layout=true on HFCausalLM"
        )
    family = _ARCH_TO_FAMILY[model_type]
    if family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"HF model_type {model_type!r} routes to {family.rsplit('.', 1)[1]}, which is "
            "not ported (ROADMAP A.8)"
        )
    return family
