"""Port parity of the Llama graph's variants at the HF boundary (fp32,
CPU), for each dense HF `model_type` that JAX routes to its `Llama`:

- `config_to_hf` writes JAX's dict (its overlay for the type; a windowed
  `qwen2` / `qwen3` export also names its window in HF's keys, ROADMAP
  C.42); over a seeded sweep of field combinations both packages refuse
  the same configs with the same message (JAX's `_check_exportable`) or
  write the same dict;
- `params_to_hf` gives JAX's keys in JAX's order and JAX's values (JAX's
  default layout: scanned unless the type forces the looped one); the
  port's writer gives JAX's files and `config.json`; a JAX export loads
  into the port equal to JAX's own load, and the port's into JAX;
- the Qwen3-8B preset's widths, its `qwen3` overlay and one layer's
  parameter count.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from safetensors.torch import load_file
from torch_llama_variant_cases import TYPES, configs, jax_config_to_hf, random_params

from llm_training_tpu.models import Llama as JaxLlama
from llm_training_tpu.models import LlamaConfig as JaxLlamaConfig
from llm_training_tpu.models import hf_io as jax_hf_io
from llm_training_tpu.models.llama import hf_conversion as jax_conv
from llm_training_tpu_torch.models import hf_io
from llm_training_tpu_torch.models.llama import hf_conversion as conv
from llm_training_tpu_torch.models.llama.config import LlamaConfig, preset
from llm_training_tpu_torch.models.llama.from_jax import state_dict_from_jax
from llm_training_tpu_torch.models.llama.model import Llama


@pytest.mark.parametrize("model_type", TYPES)
def test_config_to_hf_matches_jax(model_type):
    jax_config, config = configs(model_type)
    ours = conv.config_to_hf(config)
    assert ours == jax_config_to_hf(jax_config)
    # the overlay names the type's own architecture (or its exporting twin)
    assert ours["model_type"] == {"code_llama": "llama", "helium": "ernie4_5",
                                  "seed_oss": "qwen2"}.get(model_type, model_type)


# field -> the values the sweep draws from
SWEEP = {
    "norm_scheme": ["pre", "post", "parallel", "parallel2", "sandwich"],
    "norm_type": ["rmsnorm", "layernorm", "layernorm_nobias", "layernorm1p",
                  "layernorm_nonparam"],
    "mlp_type": ["swiglu", "gelu", "relu2", "xielu"],
    "qk_norm": [False, True],
    "qk_norm_scope": ["head", "full"],
    "qk_norm_position": ["pre_rope", "post_rope"],
    "attention_bias": [False, True],
    "attention_out_bias": [None, False, True],
    "mlp_bias": [False, True],
    "rope_interleaved": [False, True],
    "fused_gate_up": [False, True],
    "partial_rotary_factor": [1.0, 0.5],
    "position_embedding_type": ["rope", "learned"],
    "tie_word_embeddings": [False, True],
    "lm_head_bias": [False, True],
    "layer_types": [None, ["sliding_attention", "full_attention"]],
    "sliding_window": [None, 4],
    "no_rope_layers": [None, [1, 0]],
    "logit_scale": [None, 0.5],
    "clip_qkv": [None, 3.0],
    "embedding_multiplier": [1.0, 2.0],
    "attention_multiplier": [None, 0.2],
    "gelu_approximate": [True, False],
    "neox_naming": [False, True],
    "rope_scaling": [None, {"rope_type": "linear", "factor": 2.0}],
    "rms_norm_eps": [1e-5, 1e-6],
}
WIDTHS = dict(vocab_size=64, hidden_size=32, intermediate_size=48, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=4, max_position_embeddings=32,
              compute_dtype="float32", param_dtype="float32")


def _outcome(build, export):
    try:
        config = build()
    except ValueError as e:
        return ("config", str(e))
    try:
        return ("ok", export(config))
    except ValueError as e:
        return ("export", str(e))


def test_export_refusals_match_jax():
    """Seeded combinations of the variant fields: 300 drawn freely (each
    field at its default with probability 3/4), and 300 that change one or
    two fields of one of the 28 types' configs. JAX's and the port's
    configs refuse the same ones with the same message, and their exports
    refuse the same ones with the same message or write the same dict."""
    rng = np.random.default_rng(16)
    bases = [{k: v for k, v in dataclasses.asdict(configs(t)[1]).items()
              if k in JaxLlamaConfig.model_fields} for t in TYPES]
    kinds = {"config": 0, "export": 0, "ok": 0}
    for n in range(600):
        if n < 300:
            fields = {**WIDTHS, **{k: v[int(rng.integers(1, len(v)))] for k, v in SWEEP.items()
                                   if rng.random() < 0.25}}
        else:
            fields = dict(bases[int(rng.integers(len(bases)))])
            for key in rng.choice(sorted(SWEEP), size=int(rng.integers(1, 3)), replace=False):
                fields[key] = SWEEP[key][int(rng.integers(len(SWEEP[key])))]
            fields.pop("scan_layers")
        theirs = _outcome(lambda: JaxLlamaConfig(**fields), jax_config_to_hf)
        ours = _outcome(lambda: LlamaConfig(**fields), conv.config_to_hf)
        if ours[0] == "config":
            # pydantic wraps JAX's message
            assert theirs[0] == "config" and ours[1] in theirs[1], (fields, ours, theirs)
        else:
            assert ours == theirs, fields
        kinds[ours[0]] += 1
    assert min(kinds.values()) >= 50, kinds  # the sweep reaches all three outcomes


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
    # the files on disk: JAX's writer and the port's
    jax_dir = jax_hf_io.save_hf_checkpoint(params, jax_config, tmp_path / "jax", dtype="float32")
    port_dir = hf_io.save_hf_checkpoint(state, config, tmp_path / "port", dtype="float32")
    assert _files(jax_dir) == _files(port_dir)
    assert json.loads((port_dir / "config.json").read_text()) == json.loads(
        (jax_dir / "config.json").read_text()) | jax_config_to_hf(jax_config) | {
        "torch_dtype": "float32"}
    expected, written = load_file(jax_dir / "model.safetensors"), load_file(
        port_dir / "model.safetensors")
    assert list(written) == list(expected) or set(written) == set(expected)
    for key, tensor in expected.items():
        assert torch.equal(written[key], tensor), key
    # each package's directory loads into the other equal to its own load
    loaded = hf_io.load_pretrained_params(config, jax_dir)
    assert set(loaded) == set(state)
    for key, value in state_dict_from_jax(
            jax_hf_io.load_pretrained_params(jax_config, jax_dir), config).items():
        assert torch.equal(loaded[key], value), key
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)),
                 jax_hf_io.load_pretrained_params(jax_config, port_dir),
                 jax_hf_io.load_pretrained_params(jax_config, jax_dir))


def test_qwen3_8b_preset():
    """Qwen3-8B's published widths: JAX's `qwen3` export overlay, and one
    decoder layer's parameters (qk-norms included) on the meta device."""
    config = preset("qwen3-8b")
    assert (config.hidden_size, config.intermediate_size, config.num_hidden_layers,
            config.num_attention_heads, config.num_key_value_heads, config.resolved_head_dim,
            config.vocab_size) == (4096, 12288, 36, 32, 8, 128, 151936)
    jax_config = JaxLlamaConfig(**{k: v for k, v in dataclasses.asdict(config).items()
                                   if k in JaxLlamaConfig.model_fields})
    hf = conv.config_to_hf(config)
    assert hf == jax_conv.config_to_hf(jax_config)
    assert (hf["model_type"], hf["rope_theta"], hf["max_position_embeddings"],
            hf["rms_norm_eps"], hf["eos_token_id"]) == ("qwen3", 1e6, 40960, 1e-6, 151645)
    assert dataclasses.asdict(conv.config_from_hf(hf, compute_dtype="bfloat16",
                                                  param_dtype="bfloat16")) == \
        dataclasses.asdict(config)
    model = Llama(preset("qwen3-8b", num_hidden_layers=1), device="meta")
    per_layer = sum(p.numel() for p in model.model.layers.parameters())
    assert per_layer == 2 * 4096 * 4096 + 2 * 4096 * 1024 + 3 * 4096 * 12288 + 2 * 4096 + 2 * 128


@pytest.mark.parametrize("model_type", TYPES)
def test_parameter_paths_and_logical_axes_match_jax(model_type):
    """Every parameter of the type's model has a JAX path (`jax_path`, which
    `frozen_modules` patterns match) in each layout JAX allows it, and the
    logical axes JAX's abstract state carries there (`param_logical_axes`,
    the table the mesh's plans come from); every JAX leaf is reached."""
    from flax import linen as nn
    from jax.sharding import PartitionSpec

    from llm_training_tpu_torch.models.llama.from_jax import jax_path, parameter_names
    from llm_training_tpu_torch.parallel.sharding import param_logical_axes

    forced = not configs(model_type)[1].scan_layers  # JAX's looped layout only
    for scan in [False] if forced else [True, False]:
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
