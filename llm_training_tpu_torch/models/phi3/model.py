"""Phi-3 / Phi-3.5 decoder.

Counterpart of `llm_training_tpu/models/phi3/model.py`: the Llama decoder
over a `Phi3Config`. The sliding window, the `attention_compute_dtype`
upcast and longrope live in the shared stack (`llama/model.py`); HF's
fused `qkv_proj` / `gate_up_proj` are split on the way in and merged on
the way out by `phi3/hf_conversion.py`, so the parameters carry the
Llama names.
"""

from __future__ import annotations

from llm_training_tpu_torch.models.llama.model import Llama
from llm_training_tpu_torch.models.phi3.config import Phi3Config


class Phi3(Llama):
    config: Phi3Config
