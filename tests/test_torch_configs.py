"""The port's config surface against JAX's configs (ROADMAP C.24, C.25):
every objective config takes every field of JAX's, `load_weights` raising
only beside a pre-trained source; `LlamaConfig` takes every field of JAX's
`LlamaConfig`, the plain ones as JAX handles them and the ones selecting
another architecture or a mesh only at JAX's defaults."""

import dataclasses

import pytest
import torch

from llm_training_tpu.lms import CLMConfig as JaxCLMConfig
from llm_training_tpu.lms import DPOConfig as JaxDPOConfig
from llm_training_tpu.lms import ORPOConfig as JaxORPOConfig
from llm_training_tpu.lms.grpo import GRPOConfig as JaxGRPOConfig
from llm_training_tpu.models import LlamaConfig as JaxLlamaConfig
from llm_training_tpu_torch.dataclass_config import build_dataclass
from llm_training_tpu_torch.lms.base import ModelProvider
from llm_training_tpu_torch.lms.clm import CLM, CLMConfig
from llm_training_tpu_torch.lms.dpo import DPO, DPOConfig
from llm_training_tpu_torch.lms.grpo import GRPO, GRPOConfig
from llm_training_tpu_torch.lms.orpo import ORPO, ORPOConfig
from llm_training_tpu_torch.models.llama.config import LlamaConfig

SMALL = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=1,
             num_attention_heads=4, num_key_value_heads=2, head_dim=8,
             compute_dtype="float32", param_dtype="float32")
NODE = {"model_class": "Llama", "model_kwargs": SMALL}
OBJECTIVES = {
    "CLM": (JaxCLMConfig, CLMConfig, CLM),
    "DPO": (JaxDPOConfig, DPOConfig, DPO),
    "ORPO": (JaxORPOConfig, ORPOConfig, ORPO),
    "GRPO": (JaxGRPOConfig, GRPOConfig, GRPO),
}


@pytest.mark.parametrize("name", sorted(OBJECTIVES))
def test_objective_configs_take_every_jax_field(name):
    """C.24: JAX's dump of each objective's config, `log_grad_norm` and
    `load_weights` off, builds the port's config with the same values."""
    jax_cls, port_cls, _ = OBJECTIVES[name]
    dump = jax_cls(model=NODE, log_grad_norm=False, load_weights=False).model_dump()
    ours = build_dataclass(port_cls, dump)
    assert {f.name for f in dataclasses.fields(port_cls)} == set(dump)
    for key, value in dump.items():
        got = getattr(ours, key)
        if dataclasses.is_dataclass(got):
            got = dataclasses.asdict(got)
        assert got == value, key
    defaults = jax_cls().model_dump()
    assert (port_cls().log_grad_norm, port_cls().load_weights) == (
        defaults["log_grad_norm"], defaults["load_weights"]) == (True, True)


@pytest.mark.parametrize("name", sorted(OBJECTIVES))
@pytest.mark.parametrize("where", ["objective", "model"])
def test_load_weights_raises_only_beside_a_pretrained_source(name, where):
    """C.24: a pre-trained source (the objective's `pre_trained_weights` or
    the model config's) with `load_weights` is read (HF I/O:
    a missing directory raises naming it); with `load_weights: false` the
    model starts from the seed, as in JAX."""
    _, port_cls, objective_cls = OBJECTIVES[name]
    node = NODE if where == "objective" else {
        "model_class": "Llama", "model_kwargs": {**SMALL, "pre_trained_weights": "hf/dir"}}
    source = {"pre_trained_weights": "hf/dir"} if where == "objective" else {}
    cpu = torch.device("cpu")
    with pytest.raises(FileNotFoundError, match="hf/dir"):
        objective_cls(build_dataclass(port_cls, {"model": node, **source})).configure_model(
            cpu, torch.Generator().manual_seed(0))
    model = objective_cls(build_dataclass(port_cls, {"model": node, "load_weights": False,
                                                     **source})).configure_model(
        cpu, torch.Generator().manual_seed(0))
    assert all(torch.isfinite(p).all() for p in model.parameters())
    # without a source, load_weights changes nothing
    objective_cls(build_dataclass(port_cls, {"model": NODE})).configure_model(
        cpu, torch.Generator().manual_seed(0))


def test_llama_config_round_trips_every_jax_field():
    """C.25: JAX's `LlamaConfig(...).model_dump()` builds the port's
    `LlamaConfig` field for field, `bos_token_id` of Llama-3.1 included."""
    dump = JaxLlamaConfig(**SMALL, bos_token_id=128000, pre_trained_weights="hf/dir",
                          rope_theta=500000.0).model_dump()
    ours = dataclasses.asdict(LlamaConfig.from_dict(dump))
    assert ours == dump
    config = ModelProvider("Llama", {**SMALL, "bos_token_id": 128000}).get_config()
    assert config.bos_token_id == 128000 and config.attention_out_bias is False
    with pytest.raises(ValueError, match="unknown LlamaConfig fields"):
        LlamaConfig.from_dict({**SMALL, "not_a_field": 1})


@pytest.mark.parametrize("field,value,error,match", [
    ("num_experts_per_tok", 4, None, None),
    ("lm_head_bias", True, None, None),
    ("attention_out_bias", True, None, None),
    ("moe_style", "granite", None, None),
    ("num_experts", 4, ValueError, "num_experts requires moe_intermediate_size"),
    ("ring_attention", True, None, None),
    ("pipeline_stages", 2, NotImplementedError, "A.9b"),
    ("attention_dropout", 0.1, ValueError, "attention_dropout is not supported"),
])
def test_llama_fields_beyond_the_plain_decoder_raise(field, value, error, match):
    """C.25: pipeline stages raise at any value but JAX's default, naming
    the queue that brings them; `attention_dropout` raises unless 0.0, as
    JAX's config does; `ring_attention` is accepted (the model rings over
    an active mesh's `sequence` ranks, `parallel/ring_attention.py`), and
    since the Llama graph's variants and the MoE stack are ported so are
    the head's and o_proj's biases and the MoE fields (validated as JAX
    validates them: experts need their width)."""
    if error is None:
        assert getattr(LlamaConfig(**SMALL, **{field: value}), field) == value
        return
    with pytest.raises(error, match=match):
        LlamaConfig(**SMALL, **{field: value})
    if field in ("attention_dropout", "num_experts"):
        with pytest.raises(ValueError, match=match):
            JaxLlamaConfig(**SMALL, **{field: value})
