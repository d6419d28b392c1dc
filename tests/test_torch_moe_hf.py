"""Port parity of the 8 MoE HF `model_type`s on the Llama graph at the HF
boundary (fp32, CPU; `tests/torch_moe_cases.py`):

- `config_to_hf` writes JAX's dict (its MoE overlay for the type);
- `params_to_hf` gives JAX's keys in JAX's order and JAX's values (the
  per-expert matrices of the qwen and mixtral layouts, granite's stacked
  and fused ones, the shared experts); the port's writer gives JAX's files
  and `config.json`; a JAX export loads into the port equal to JAX's own
  load, and the port's into JAX;
- `transformers` loads the port's export to logits within 1e-4 of the
  port's, and `HFCausalLM` builds the port's `Llama` for each type;
- every MoE parameter has JAX's path and logical axes in both layouts;
- JAX's refusals: a mixed dense/sparse schedule, sparsemixer outside
  Phimoe, an ungated shared expert outside granite;
- the Qwen3-30B-A3B preset: its published `config.json` through
  `config_from_hf`, the `qwen3_moe` overlay, and a layer's parameters.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from safetensors.torch import load_file
from torch_moe_cases import FP32, TYPES, configs, hf_config, random_params
from torch_threads import one_torch_thread  # noqa: F401

from llm_training_tpu.models import Llama as JaxLlama
from llm_training_tpu.models import LlamaConfig as JaxLlamaConfig
from llm_training_tpu.models import hf_io as jax_hf_io
from llm_training_tpu.models.llama import hf_conversion as jax_conv
from llm_training_tpu_torch.models import hf_io
from llm_training_tpu_torch.models.hf_causal_lm import HFCausalLM, HFCausalLMConfig
from llm_training_tpu_torch.models.llama import hf_conversion as conv
from llm_training_tpu_torch.models.llama.config import LlamaConfig, preset
from llm_training_tpu_torch.models.llama.from_jax import state_dict_from_jax
from llm_training_tpu_torch.models.llama.model import Llama


@pytest.mark.parametrize("model_type", TYPES)
def test_config_to_hf_matches_jax(model_type):
    jax_config, config = configs(model_type)
    ours = conv.config_to_hf(config)
    assert ours == jax_conv.config_to_hf(jax_config)
    assert ours["model_type"] == model_type
    assert hf_io.model_class_for_hf(ours) == "llm_training_tpu.models.Llama"


def _files(path):
    return sorted(p.name for p in path.iterdir())


@pytest.mark.parametrize("model_type", TYPES)
def test_export_and_load_match_jax(tmp_path, model_type):
    jax_config, config = configs(model_type)
    params = random_params(JaxLlama(jax_config))
    state = state_dict_from_jax(params, config)
    theirs = jax_conv.params_to_hf(params, jax_config)
    ours = conv.params_to_hf(state, config)
    assert list(ours) == list(theirs)
    for key, value in theirs.items():
        np.testing.assert_array_equal(ours[key].float().numpy(), np.asarray(value, np.float32),
                                      err_msg=key)
    jax_dir = jax_hf_io.save_hf_checkpoint(params, jax_config, tmp_path / "jax", dtype="float32")
    port_dir = hf_io.save_hf_checkpoint(state, config, tmp_path / "port", dtype="float32")
    assert _files(jax_dir) == _files(port_dir)
    assert json.loads((port_dir / "config.json").read_text()) == json.loads(
        (jax_dir / "config.json").read_text())
    expected, written = load_file(jax_dir / "model.safetensors"), load_file(
        port_dir / "model.safetensors")
    assert set(written) == set(expected)
    for key, tensor in expected.items():
        assert torch.equal(written[key], tensor), key
    loaded = hf_io.load_pretrained_params(config, jax_dir)
    assert set(loaded) == set(state)
    for key, value in state_dict_from_jax(
            jax_hf_io.load_pretrained_params(jax_config, jax_dir), config).items():
        assert torch.equal(loaded[key], value), key
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)),
                 jax_hf_io.load_pretrained_params(jax_config, port_dir),
                 jax_hf_io.load_pretrained_params(jax_config, jax_dir))


@pytest.mark.parametrize("model_type", TYPES)
def test_transformers_loads_the_ports_export(tmp_path, model_type):
    """`transformers`' class for the type (eval mode: phimoe's SparseMixer
    without jitter) loads the port's export to the port's logits within
    1e-4, and `HFCausalLM` over the directory builds the port's `Llama`
    with JAX's config for it."""
    transformers = pytest.importorskip("transformers")
    jax_config, config = configs(model_type)
    state = state_dict_from_jax(random_params(JaxLlama(jax_config)), config)
    model = Llama(config, device="cpu")
    model.load_state_dict(state)
    out = hf_io.save_hf_checkpoint(model.state_dict(), config, tmp_path / "export",
                                   dtype="float32")
    hf_model = transformers.AutoModelForCausalLM.from_pretrained(
        out, torch_dtype=torch.float32, attn_implementation="eager").eval()
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 128, (2, 12)))
    with torch.no_grad():
        theirs = hf_model(ids).logits
        ours = model.eval()(ids).logits
    np.testing.assert_allclose(ours.numpy(), theirs.numpy(), rtol=1e-4, atol=1e-4)
    built = HFCausalLM(HFCausalLMConfig.from_dict({"hf_path": str(out), **FP32}), device="meta")
    assert type(built) is Llama
    want = jax_conv.config_from_hf(jax_hf_io.load_hf_config(out), pre_trained_weights=str(out),
                                   **FP32)
    assert built.config.__dict__ == want.model_dump()


@pytest.mark.parametrize("model_type", ["qwen2_moe", "granitemoeshared", "mixtral"])
def test_parameter_paths_and_logical_axes_match_jax(model_type):
    """Every MoE parameter has JAX's path in both layouts and JAX's logical
    axes (`expert`, `embed`, `mlp` on the stacks: FSDP2 shards their dim 0)."""
    from flax import linen as nn
    from jax.sharding import PartitionSpec

    from llm_training_tpu_torch.models.llama.from_jax import jax_path, parameter_names
    from llm_training_tpu_torch.parallel.sharding import param_logical_axes

    for scan in (True, False):
        jax_config, config = configs(model_type, scan_layers=scan)
        abstract = jax.eval_shape(lambda: JaxLlama(jax_config).init(
            jax.random.key(0), np.zeros((1, 4), np.int32)))
        leaves = jax.tree_util.tree_flatten_with_path(
            nn.get_partition_spec(abstract), is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
        specs = {"/".join(str(getattr(k, "key", k)) for k in path): tuple(spec)
                 for path, spec in leaves}
        shapes = {n: p.shape for n, p in Llama(config, device="meta").named_parameters()}
        seen = set()
        for name in parameter_names(config):
            path = jax_path(name, scan)
            want = specs[path]
            if scan and name.startswith("model.layers."):
                assert want[0] == "layers", (name, want)
                want = want[1:]
            assert param_logical_axes(name, ndim=len(shapes[name])) == want, (name, scan)
            seen.add(path)
        assert seen == set(specs), set(specs) - seen
        assert param_logical_axes("model.layers.0.mlp.experts_gate_proj")[0] == "expert"


@pytest.mark.parametrize("change,match", [
    (dict(model_type="qwen3_moe", decoder_sparse_step=2), "mixed dense/sparse"),
    (dict(model_type="qwen2_moe", mlp_only_layers=[1]), "mixed dense/sparse"),
])
def test_config_from_hf_refusals_match_jax(change, match):
    hf = {**hf_config(change["model_type"]), **change}
    with pytest.raises(ValueError, match=match):
        jax_conv.config_from_hf(hf)
    with pytest.raises(ValueError, match=match):
        conv.config_from_hf(hf)


@pytest.mark.parametrize("fields,match", [
    (dict(moe_router_impl="sparsemixer", moe_style="mixtral"), "sparsemixer routing only"),
    (dict(shared_expert_intermediate_size=24, shared_expert_gated=False), "UNGATED"),
    (dict(moe_style="granite", norm_topk_prob=False), "unrenormalized"),
])
def test_export_refusals_match_jax(fields, match):
    base = dict(vocab_size=64, hidden_size=32, intermediate_size=48, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, num_experts=4,
                moe_intermediate_size=16, **FP32, **fields)
    for build, export in ((JaxLlamaConfig, jax_conv.config_to_hf),
                          (LlamaConfig, conv.config_to_hf)):
        with pytest.raises(ValueError, match=match):
            export(build(**base))
    with pytest.raises(ValueError, match="granite.*always-on"):
        LlamaConfig(**{**base, "moe_style": "granite", "shared_expert_intermediate_size": 8,
                       "shared_expert_gated": True})
    with pytest.raises(ValueError, match="num_experts_per_tok"):
        LlamaConfig(**{**base, "num_experts_per_tok": 5})


# the config.json of huggingface.co/Qwen/Qwen3-30B-A3B
QWEN3_30B_A3B = {
    "architectures": ["Qwen3MoeForCausalLM"], "attention_bias": False, "attention_dropout": 0.0,
    "bos_token_id": 151643, "decoder_sparse_step": 1, "eos_token_id": 151645, "head_dim": 128,
    "hidden_act": "silu", "hidden_size": 2048, "initializer_range": 0.02,
    "intermediate_size": 6144, "max_position_embeddings": 40960, "max_window_layers": 48,
    "mlp_only_layers": [], "model_type": "qwen3_moe", "moe_intermediate_size": 768,
    "norm_topk_prob": True, "num_attention_heads": 32, "num_experts": 128,
    "num_experts_per_tok": 8, "num_hidden_layers": 48, "num_key_value_heads": 4,
    "output_router_logits": False, "rms_norm_eps": 1e-06, "rope_scaling": None,
    "rope_theta": 1000000.0, "router_aux_loss_coef": 0.001, "sliding_window": None,
    "tie_word_embeddings": False, "torch_dtype": "bfloat16", "use_cache": True,
    "use_sliding_window": False, "vocab_size": 151936,
}


def test_qwen3_30b_a3b_preset():
    config = preset("qwen3-30b-a3b")
    bf16 = dict(compute_dtype="bfloat16", param_dtype="bfloat16")
    assert dataclasses.asdict(conv.config_from_hf(QWEN3_30B_A3B, **bf16)) == \
        dataclasses.asdict(config)
    jax_config = JaxLlamaConfig(**{k: v for k, v in dataclasses.asdict(config).items()
                                   if k in JaxLlamaConfig.model_fields})
    hf = conv.config_to_hf(config)
    assert hf == jax_conv.config_to_hf(jax_config)
    assert (hf["model_type"], hf["num_experts"], hf["num_experts_per_tok"],
            hf["moe_intermediate_size"], hf["head_dim"]) == ("qwen3_moe", 128, 8, 768, 128)
    model = Llama(preset("qwen3-30b-a3b", num_hidden_layers=1), device="meta")
    layer = model.model.layers[0]
    experts = sum(p.numel() for n, p in layer.named_parameters() if "experts_" in n)
    assert experts == 3 * 128 * 2048 * 768  # 604 M
    attention = 2 * 2048 * 4096 + 2 * 2048 * 512 + 2 * 128
    assert sum(p.numel() for p in layer.parameters()) == experts + attention + 2048 * 128 + 2 * 2048
