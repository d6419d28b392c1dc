"""Port parity of the Gemma family at the HF boundary (fp32, CPU):

- `config_to_hf` writes JAX's dict for each version (JAX's refusal of a
  version-3 config without qk-norm included) and `config_from_hf` builds
  JAX's config, field for field;
- `params_to_hf` gives JAX's keys in JAX's order (which follows the tree's
  layout: Gemma-2's pairs export the even layers first) and JAX's values;
- HF directories both ways: JAX's export and the port's have the same
  files, tensors and `config.json`, and each package reads the other's;
- `transformers` loads the port's export of each version to the port's
  logits; an `HFCausalLM` node routes gemma, gemma2 and gemma3_text to
  the port's `Gemma`."""

import json

import jax
import numpy as np
import pytest
import torch
from safetensors.torch import load_file
from torch_gemma_cases import VARIANTS, configs, random_params

from llm_training_tpu.models import Gemma as JaxGemma
from llm_training_tpu.models import GemmaConfig as JaxGemmaConfig
from llm_training_tpu.models import hf_io as jax_hf_io
from llm_training_tpu.models.gemma import hf_conversion as jax_conv
from llm_training_tpu_torch.models import hf_io
from llm_training_tpu_torch.models.gemma import Gemma, GemmaConfig
from llm_training_tpu_torch.models.gemma import hf_conversion as conv
from llm_training_tpu_torch.models.hf_causal_lm import HFCausalLM, HFCausalLMConfig
from llm_training_tpu_torch.models.llama.from_jax import state_dict_from_jax

FP32 = dict(compute_dtype="float32", param_dtype="float32")


def _carried(name, **fields):
    jax_config, config = configs(name, **fields)
    variables = random_params(JaxGemma(jax_config))
    return jax_config, config, variables, state_dict_from_jax(variables, config)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_config_to_hf_and_back_match_jax(name):
    """JAX's dict out; from that dict (and from the presets' own), JAX's
    config back, field for field."""
    jax_config, config = configs(name)
    written = conv.config_to_hf(config)
    assert written == jax_conv.config_to_hf(jax_config)
    assert written["model_type"] == {1: "gemma", 2: "gemma2", 3: "gemma3_text"}[config.version]
    ours = conv.config_from_hf(written, **FP32)
    theirs = jax_conv.config_from_hf(written, **FP32)
    assert json.loads(json.dumps(ours.__dict__)) == json.loads(json.dumps(theirs.model_dump()))


def test_config_to_hf_refuses_a_gemma3_without_qk_norm_as_jax():
    fields = dict(VARIANTS["v3"], use_qk_norm=False)
    with pytest.raises(ValueError, match="use_qk_norm") as theirs:
        jax_conv.config_to_hf(JaxGemmaConfig(**fields))
    with pytest.raises(ValueError) as ours:
        conv.config_to_hf(GemmaConfig(**fields))
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_params_to_hf_matches_jax_keys_order_and_values(name):
    jax_config, config, variables, state = _carried(name)
    theirs = jax_conv.params_to_hf(variables, jax_config)
    ours = conv.params_to_hf(state, config)
    assert list(ours) == list(theirs)
    for key, value in theirs.items():
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(value), err_msg=key)
    back = conv.params_from_hf({k: torch.as_tensor(np.asarray(v)) for k, v in theirs.items()},
                               config)
    assert back.keys() == state.keys()
    assert all(torch.equal(back[k], state[k]) for k in state)


@pytest.mark.parametrize("name", ["v1", "v2_pairs", "v3"])
def test_hf_directories_both_ways_match_jax(tmp_path, name):
    """The same files, tensors (bf16) and `config.json` from both writers;
    JAX reads the port's export as its own, the port reads JAX's into its
    parameters as its own."""
    jax_config, config, variables, state = _carried(name)
    theirs = jax_hf_io.save_hf_checkpoint(variables, jax_config, tmp_path / "jax",
                                          dtype="bfloat16")
    ours = hf_io.save_hf_checkpoint(state, config, tmp_path / "port", dtype="bfloat16")
    files = sorted(p.name for p in theirs.iterdir())
    assert files == sorted(p.name for p in ours.iterdir())
    for file in files:
        if file.endswith(".json"):
            assert json.loads((ours / file).read_text()) == json.loads((theirs / file).read_text())
            continue
        expected, written = load_file(theirs / file), load_file(ours / file)
        assert set(written) == set(expected)
        assert all(torch.equal(written[k], expected[k]) for k in expected)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a, np.float32),
                                                            np.asarray(b, np.float32)),
                 jax_hf_io.load_pretrained_params(jax_config, ours),
                 jax_hf_io.load_pretrained_params(jax_config, theirs))
    model = Gemma(config, device="cpu")
    hf_io.load_pretrained_params(config, theirs, into=model.state_dict())
    from_ours = hf_io.load_pretrained_params(config, ours)
    for key, value in model.state_dict().items():
        assert torch.equal(value, from_ours[key]), key


@pytest.mark.parametrize("name", ["v1", "v2_looped", "v3"])
def test_transformers_loads_the_ports_export(tmp_path, name):
    """`transformers`' Gemma, Gemma2 and Gemma3 classes load the port's
    export to logits within 1e-4 of the port's (eager attention: the soft
    cap and the windows)."""
    transformers = pytest.importorskip("transformers")
    _, config, _, state = _carried(name)
    model = Gemma(config, device="cpu")
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


@pytest.mark.parametrize("name", ["v1", "v2_looped", "v3"])
def test_hf_causal_lm_routes_each_gemma_type(tmp_path, name):
    """`HFCausalLM` over the port's export builds the port's `Gemma` with
    JAX's config for the directory and the weights' source set."""
    jax_config, config, _, state = _carried(name)
    out = hf_io.save_hf_checkpoint(state, config, tmp_path / "export", dtype="float32")
    model = HFCausalLM(HFCausalLMConfig.from_dict({"hf_path": str(out), **FP32}), device="meta")
    assert type(model) is Gemma
    want = jax_conv.config_from_hf(jax_hf_io.load_hf_config(out), pre_trained_weights=str(out),
                                   **FP32)
    assert model.config.__dict__ == want.model_dump()
