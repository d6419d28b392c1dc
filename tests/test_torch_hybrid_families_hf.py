"""Port parity of the hybrid families (Qwen3-Next, MiniMax, Bamba) at the
HF and JAX-tree boundaries (fp32, CPU), on `tests/torch_hybrid_cases.py`:

- `config_to_hf` writes JAX's dict, and `config_from_hf` of that dict
  builds JAX's config, field for field; JAX's refusals (Qwen3-Next's mixed
  dense/sparse schedules, MiniMax's router jitter) with JAX's messages;
- `params_to_hf` gives JAX's keys in JAX's order (the periodic layout's
  slot by slot, the looped one's layer by layer; MiniMax's decay buffers
  included) and JAX's values; `params_from_hf` reads them back;
- `from_jax` reads JAX's periodic and looped trees to the same state and
  optimizer entries, Adafactor's per-leaf entries following each tree;
- HF directories both ways: the same files, tensors and `config.json`,
  each package reading the other's;
- `HFCausalLM` builds the port's family model for each type;
- `transformers` loads the port's export of each type to the port's
  logits;
- `generate` and `serve` (and so `rl-fit`, which serves its rollouts)
  refuse each family as JAX's engines do, and `parallelize` refuses them
  naming ROADMAP A.9b.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from safetensors.torch import load_file
from torch_hybrid_cases import FP32, TYPES, conversions, hf_config, models
from torch_moe_cases import random_params
from torch_threads import one_torch_thread  # noqa: F401

from llm_training_tpu.models import hf_io as jax_hf_io
from llm_training_tpu_torch.models import hf_io
from llm_training_tpu_torch.models.hf_causal_lm import HFCausalLM, HFCausalLMConfig
from llm_training_tpu_torch.models.llama.from_jax import (
    jax_layout,
    optimizer_state_from_jax,
    state_dict_from_jax,
)

LAYOUTS = [(t, scan) for t in TYPES for scan in (True, False)]
LAYOUT_IDS = [f"{t}-{'periodic' if s else 'looped'}" for t, s in LAYOUTS]


def _carried(model_type, **fields):
    """(JAX config, the port's, a random JAX tree in the config's layout,
    the port's state from it)."""
    jax_model, _, jax_config, config = models(model_type, **fields)
    variables = random_params(jax_model, seed=3)
    return jax_config, config, variables, state_dict_from_jax(variables, config)


@pytest.mark.parametrize("model_type", TYPES)
def test_config_to_hf_and_back_match_jax(model_type):
    jax_conv, conv = conversions(model_type)
    jax_config, config = models(model_type)[2:]
    written = conv.config_to_hf(config)
    assert written == jax_conv.config_to_hf(jax_config)
    assert written["model_type"] == model_type
    ours = conv.config_from_hf(written, **FP32)
    theirs = jax_conv.config_from_hf(written, **FP32)
    assert json.loads(json.dumps(dataclasses.asdict(ours))) == json.loads(
        json.dumps(theirs.model_dump()))


@pytest.mark.parametrize("model_type,fields", [
    ("qwen3_next", dict(decoder_sparse_step=2)), ("qwen3_next", dict(mlp_only_layers=[1])),
    ("minimax", dict(router_jitter_noise=0.1))])
def test_config_from_hf_refusals_match_jax(model_type, fields):
    jax_conv, conv = conversions(model_type)
    hf = {**hf_config(model_type), **fields}
    with pytest.raises(ValueError) as theirs:
        jax_conv.config_from_hf(hf)
    with pytest.raises(ValueError) as ours:
        conv.config_from_hf(hf)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("model_type,scan", LAYOUTS, ids=LAYOUT_IDS)
def test_params_to_hf_matches_jax_keys_order_and_values(model_type, scan):
    jax_conv, conv = conversions(model_type)
    jax_config, config, variables, state = _carried(model_type, scan_layers=scan)
    theirs = jax_conv.params_to_hf(variables, jax_config)
    ours = conv.params_to_hf(state, config)
    assert list(ours) == list(theirs)
    for key, value in theirs.items():
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(value), err_msg=key)
    back = conv.params_from_hf({k: torch.as_tensor(np.asarray(v)) for k, v in theirs.items()},
                               config)
    assert back.keys() == state.keys()
    assert all(torch.equal(back[k], state[k]) for k in state)


@pytest.mark.parametrize("model_type", TYPES)
def test_from_jax_reads_every_layout(model_type):
    """JAX's own HF import in its periodic layout and in its looped one
    gives trees the port reads to the same state and optimizer entries;
    Adafactor's per-leaf entries follow each tree's leaves."""
    jax_conv, _ = conversions(model_type)
    jax_config, config, variables, state = _carried(model_type)
    assert str(config.jax_layout) == "period2"
    hf = jax_conv.params_to_hf(variables, jax_config)
    for scan in (True, False):
        jax_cfg = dataclasses.replace(config, scan_layers=scan)
        tree = jax_conv.params_from_hf(hf, jax_conv.config_from_hf(
            hf_config(model_type), **FP32, scan_layers=scan))
        got = state_dict_from_jax(tree, jax_cfg)
        assert got.keys() == state.keys()
        assert all(torch.equal(got[k], state[k]) for k in state), scan
        mu = optimizer_state_from_jax(tree, jax_cfg, "mu")
        assert all(torch.equal(mu[f"mu.{k}"], state[k].to(mu[f"mu.{k}"].dtype)) for k in state)
        leaves = optimizer_state_from_jax(tree, jax_cfg, "v", per_leaf=True)
        assert set(leaves) == {f"v.{jax_layout(k, jax_cfg.jax_layout)[0]}" for k in state}
        assert len(leaves) == len(jax.tree.leaves(tree))


@pytest.mark.parametrize("model_type", TYPES)
def test_hf_directories_both_ways_match_jax(tmp_path, model_type):
    jax_config, config, variables, state = _carried(model_type)
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
    model = models(model_type)[1](config, device="cpu")
    hf_io.load_pretrained_params(config, theirs, into=model.state_dict())
    from_ours = hf_io.load_pretrained_params(config, ours)
    for key, value in model.state_dict().items():
        assert torch.equal(value, from_ours[key]), key


@pytest.mark.parametrize("model_type", TYPES)
def test_hf_causal_lm_builds_each_type(tmp_path, model_type):
    """`HFCausalLM` over an HF directory of the type builds the port's
    family model with JAX's config for it and the weights' source set."""
    jax_conv, _ = conversions(model_type)
    (tmp_path / "config.json").write_text(json.dumps(hf_config(model_type)))
    model = HFCausalLM(HFCausalLMConfig.from_dict({"hf_path": str(tmp_path), **FP32}),
                       device="meta")
    assert type(model).__name__ == models(model_type)[0].__class__.__name__
    want = jax_conv.config_from_hf(hf_config(model_type), pre_trained_weights=str(tmp_path),
                                   **FP32)
    assert dataclasses.asdict(model.config) == want.model_dump()
    assert hf_io.model_class_for_hf({"model_type": model_type}) == (
        jax_hf_io.model_class_for_hf({"model_type": model_type}))


@pytest.mark.parametrize("model_type", TYPES)
def test_transformers_loads_the_ports_export(tmp_path, model_type):
    """`transformers` loads the port's fp32 export of each type (random
    weights, the decay rates and the conv biases included) to logits equal
    to the port's."""
    transformers = pytest.importorskip("transformers")
    _, config, _, state = _carried(model_type)
    model = models(model_type)[1](config, device="cpu")
    model.load_state_dict(state)
    out = hf_io.save_hf_checkpoint(model.state_dict(), config, tmp_path / "export",
                                   dtype="float32")
    hf_model = transformers.AutoModelForCausalLM.from_pretrained(
        out, torch_dtype=torch.float32, attn_implementation="eager").eval()
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 128, (2, 20)))
    with torch.no_grad():
        theirs = hf_model(ids).logits
        ours = model.eval()(ids).logits
    np.testing.assert_allclose(ours.numpy(), theirs.numpy(), atol=2e-4, rtol=2e-3)


@pytest.mark.parametrize("model_type", TYPES)
def test_generate_serve_and_the_mesh_refuse_each_family_as_jax(model_type):
    """JAX's `InferenceEngine` and `ServingEngine` refuse a model whose
    `__call__` takes no `decode_state`; the port's engines refuse the same
    families with the same messages (`rl-fit` serves its rollouts through
    the `ServingEngine`), and `parallelize` refuses them naming A.9b."""
    from llm_training_tpu.infer import InferenceEngine as JaxInferenceEngine
    from llm_training_tpu.infer.engine import supports_decoding as jax_supports_decoding
    from llm_training_tpu.serve import ServingEngine as JaxServingEngine
    from llm_training_tpu_torch.infer.engine import InferenceEngine, supports_decoding
    from llm_training_tpu_torch.parallel.sharding import parallelize
    from llm_training_tpu_torch.serve.engine import ServingEngine

    jax_model, port_cls, _, config = models(model_type)
    port = port_cls(config, device="cpu")
    assert not supports_decoding(port) and not jax_supports_decoding(jax_model)
    for jax_engine, engine in ((JaxInferenceEngine, InferenceEngine),
                               (JaxServingEngine, ServingEngine)):
        with pytest.raises(NotImplementedError) as theirs:
            jax_engine(jax_model, {})
        with pytest.raises(NotImplementedError) as ours:
            engine(port, device="cpu")
        assert str(ours.value) == str(theirs.value)
    with pytest.raises(NotImplementedError, match="A.9b"):
        parallelize(port_cls(config, device="meta"), mesh=None)
