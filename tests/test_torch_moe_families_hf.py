"""Port parity of the non-Llama MoE families at the HF and JAX-tree
boundaries, and their routers' and activation's edge cases (fp32, CPU):

- `config_to_hf` writes JAX's dict for each HF type, and `config_from_hf`
  of that dict builds JAX's config, field for field;
- `params_to_hf` gives JAX's keys in JAX's order (which follows the JAX
  tree's layout) and JAX's values, from a tree in the config's scanned
  layout; `params_from_hf` reads them back;
- `from_jax` reads every JAX layout a family has (a looped dense prefix with
  a scanned MoE suffix, a scanned sliding/full period, every layer scanned,
  and the looped fallbacks) to the same state and optimizer entries;
- HF directories both ways, for each family: the same files, tensors and
  `config.json`, each package reading the other's;
- `HFCausalLM` builds the port's family model for each of the eight types;
- the routers take JAX's order among tied scores (ROADMAP C.46): upcycled
  duplicated router columns (`MoEMLP` and each family) and a v3 router
  whose masked zeros win, element for element against `lax.top_k`;
- gpt-oss's clamp takes JAX's gradient (0.5) at exactly +-7;
- `generate` and `serve` refuse each family as JAX's engines do.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import load_file
from torch_moe_cases import random_params
from torch_moe_family_cases import FP32, TYPES, conversions, hf_config, models
from torch_threads import one_torch_thread  # noqa: F401

from llm_training_tpu.models import hf_io as jax_hf_io
from llm_training_tpu_torch.models import hf_io, moe
from llm_training_tpu_torch.models.hf_causal_lm import HFCausalLM, HFCausalLMConfig
from llm_training_tpu_torch.models.llama.from_jax import (
    jax_layout,
    optimizer_state_from_jax,
    state_dict_from_jax,
)

# one type a family, for the costlier checks
FAMILIES = ["deepseek_v3", "glm4_moe", "gpt_oss", "ernie4_5_moe", "hunyuan_v1_moe"]


def _carried(model_type, **fields):
    """(JAX config, the port's, a random JAX tree in the config's layout,
    the port's state from it)."""
    jax_model, port_cls, jax_config, config = models(model_type, **fields)
    variables = random_params(jax_model, seed=3)
    return jax_config, config, variables, state_dict_from_jax(variables, config)


@pytest.mark.parametrize("model_type", TYPES)
def test_config_to_hf_and_back_match_jax(model_type):
    jax_conv, conv = conversions(model_type)
    jax_config, config = models(model_type)[2:]
    written = conv.config_to_hf(config)
    assert written == jax_conv.config_to_hf(jax_config)
    expected_type = "deepseek_v3" if model_type == "kimi_k2" else model_type
    assert written["model_type"] == expected_type
    ours = conv.config_from_hf(written, **FP32)
    theirs = jax_conv.config_from_hf(written, **FP32)
    assert json.loads(json.dumps(dataclasses.asdict(ours))) == json.loads(
        json.dumps(theirs.model_dump()))


def test_config_to_hf_refusals_match_jax():
    """A windowed or o-biased GLM-4.5 config exports only as dots1; a dots1
    config with half rotary refuses, with JAX's messages."""
    jax_conv, conv = conversions("glm4_moe")
    for fields in (dict(sliding_window=4), dict(attention_out_bias=True),
                   dict(hf_flavor="dots1")):
        with pytest.raises(ValueError) as theirs:
            jax_conv.config_to_hf(jax_conv.config_from_hf(hf_config("glm4_moe"), **fields))
        with pytest.raises(ValueError) as ours:
            conv.config_to_hf(conv.config_from_hf(hf_config("glm4_moe"), **fields))
        assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("model_type", TYPES)
def test_params_to_hf_matches_jax_keys_order_and_values(model_type):
    jax_conv, conv = conversions(model_type)
    jax_config, config, variables, state = _carried(model_type)
    theirs = jax_conv.params_to_hf(variables, jax_config)
    ours = conv.params_to_hf(state, config)
    assert list(ours) == list(theirs)
    for key, value in theirs.items():
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(value), err_msg=key)
    back = conv.params_from_hf({k: torch.as_tensor(np.asarray(v)) for k, v in theirs.items()},
                               config)
    assert back.keys() == state.keys()
    assert all(torch.equal(back[k], state[k]) for k in state)


# each family's scanned layout and its looped one
LAYOUTS = {"deepseek_v3": "suffix1", "glm4_moe": "suffix1", "ernie4_5_moe": "suffix1",
           "gpt_oss": "period2", "hunyuan_v1_moe": "scanned", "dots1": "looped"}


@pytest.mark.parametrize("model_type", sorted(LAYOUTS))
def test_from_jax_reads_every_layout(model_type):
    """JAX's own HF import in its scanned layout and in its looped one
    gives trees the port reads to the same state and optimizer entries;
    Adafactor's per-leaf entries follow each tree's leaves."""
    jax_conv, conv = conversions(model_type)
    jax_config, config, variables, state = _carried(model_type)
    assert str(config.jax_layout) == LAYOUTS[model_type]
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
        n_leaves = len(jax.tree.leaves(tree))
        assert len(leaves) == n_leaves


@pytest.mark.parametrize("model_type", FAMILIES)
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
    jax_conv, conv = conversions(model_type)
    (tmp_path / "config.json").write_text(json.dumps(hf_config(model_type)))
    model = HFCausalLM(HFCausalLMConfig.from_dict({"hf_path": str(tmp_path), **FP32}),
                       device="meta")
    assert type(model).__name__ == models(model_type)[0].__class__.__name__
    want = jax_conv.config_from_hf(hf_config(model_type), pre_trained_weights=str(tmp_path),
                                   **FP32)
    assert dataclasses.asdict(model.config) == want.model_dump()


# ---------------------------------------------------------------- C.46: ties


class _JaxTopK:
    """Record every `lax.top_k` index array of a JAX forward traced inside
    the block (through an ordered host callback, so under `jit` too)."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        self.real = jax.lax.top_k

        def top_k(x, k):
            values, idx = self.real(x, k)
            jax.debug.callback(lambda i: self.calls.append(np.asarray(i)), idx, ordered=True)
            return values, idx

        jax.lax.top_k = top_k
        return self.calls

    def __exit__(self, *exc):
        jax.lax.top_k = self.real


class _PortTopK(_JaxTopK):
    def __enter__(self):
        self.real = moe.top_k

        def top_k(x, k):
            values, idx = self.real(x, k)
            self.calls.append(idx.numpy())
            return values, idx

        moe.top_k = top_k
        return self.calls

    def __exit__(self, *exc):
        moe.top_k = self.real


def _routes(jax_model, port, params, ids):
    with _JaxTopK() as theirs:
        jax.block_until_ready(jax.jit(lambda p, i: jax_model.apply(p, input_ids=i).logits)(
            params, jnp.asarray(ids)))
        jax.effects_barrier()
    with _PortTopK() as ours, torch.no_grad():
        port(torch.from_numpy(ids).long())
    return ours, theirs


def _assert_same_routes(ours, theirs):
    assert len(ours) == len(theirs) > 0
    for got, want in zip(ours, theirs):
        np.testing.assert_array_equal(got, want)


def test_moe_mlp_takes_jax_s_order_among_tied_router_columns():
    """The Llama graph's `MoEMLP` (qwen3_moe's routing, 64 experts, top 6)
    with four identical router columns: 256 tokens route to JAX's experts
    in JAX's order."""
    from torch_moe_cases import configs

    from llm_training_tpu.models import Llama as JaxLlama
    from llm_training_tpu_torch.models.llama.model import Llama

    jax_config, config = configs("qwen3_moe", num_experts=64, num_experts_per_tok=6,
                                 num_hidden_layers=1, scan_layers=False)
    jax_model = JaxLlama(jax_config)
    params = random_params(jax_model, seed=0)
    router = params["params"]["layers_0"]["mlp"]["gate"]
    router["kernel"] = np.array(router["kernel"])
    router["kernel"][:, [5, 9, 40, 41]] = router["kernel"][:, [5]]
    port = Llama(config, device="cpu")
    port.load_state_dict(state_dict_from_jax(params, config))
    ids = np.random.default_rng(0).integers(0, 128, (2, 128)).astype(np.int32)
    _assert_same_routes(*_routes(jax_model, port, params, ids))


# each family's router kernel below a layer, and the columns duplicated
ROUTERS = {"deepseek_v2": ("mlp", "gate_kernel"), "deepseek_v3": ("mlp", "gate_kernel"),
           "glm4_moe": ("mlp", "gate_kernel"), "gpt_oss": ("mlp", "router", "kernel"),
           "ernie4_5_moe": ("mlp", "gate_kernel"), "hunyuan_v1_moe": ("mlp", "gate_kernel")}


@pytest.mark.parametrize("model_type", sorted(ROUTERS))
def test_family_routers_take_jax_s_order_among_ties(model_type):
    """Each family's router with duplicated columns (experts 1, 2 and 3
    equal), and a v3 router whose selection bias pushes every score below
    0 so that the masked groups' zeros tie: the port's top-k calls (groups
    included) equal JAX's element for element."""
    jax_model, port_cls, jax_config, config = models(model_type, scan_layers=False)
    params = random_params(jax_model, seed=0)
    tree = params["params"]
    for name in [k for k in tree if k.startswith("layers_")]:
        layer = tree[name]
        node = layer
        for key in ROUTERS[model_type][:-1]:
            node = node.get(key, {})
        leaf = ROUTERS[model_type][-1]
        if leaf not in node:
            continue  # a dense layer
        kernel = np.array(node[leaf])
        kernel[..., [1, 2, 3]] = kernel[..., [1]]
        node[leaf] = kernel
        if model_type == "deepseek_v3":
            node["e_score_correction_bias"] = np.full_like(node["e_score_correction_bias"], -5.0)
    port = port_cls(config, device="cpu")
    port.load_state_dict(state_dict_from_jax(params, config))
    ids = np.random.default_rng(1).integers(0, 128, (2, 64)).astype(np.int32)
    ours, theirs = _routes(jax_model, port, params, ids)
    _assert_same_routes(ours, theirs)
    if model_type == "deepseek_v3":
        # the masked zeros won: every token's experts are the lowest of
        # groups it did not select
        assert (ours[-1] < config.n_routed_experts).all()


# ---------------------------------------------------------------- gpt-oss's clamp


def test_gpt_oss_clamp_gradient_at_the_limits_is_jax_s():
    """Gate and up values exactly at +-7 (bf16 holds 7.0): the activation's
    gradients equal `jax.grad` of JAX's `_expert_act` (0.5 at a limit,
    where `torch.clamp` would give 1)."""
    from llm_training_tpu.models.gpt_oss.model import _expert_act
    from llm_training_tpu_torch.models.gpt_oss.model import expert_act

    gate = np.asarray([7.0, -7.0, 3.0, 8.0, 7.0, -9.0], np.float32)
    up = np.asarray([7.0, -7.0, -7.0, 7.0, 2.0, 8.0], np.float32)
    jax_dg, jax_du = jax.grad(lambda g, u: _expert_act(g, u).sum(), argnums=(0, 1))(
        jnp.asarray(gate), jnp.asarray(up))
    g = torch.tensor(gate, requires_grad=True)
    u = torch.tensor(up, requires_grad=True)
    expert_act(g, u).sum().backward()
    np.testing.assert_allclose(g.grad.numpy(), np.asarray(jax_dg), rtol=1e-6)
    np.testing.assert_allclose(u.grad.numpy(), np.asarray(jax_du), rtol=1e-6)
    # in bf16 too, at the limits (the last element, off them, rounds apart)
    bf = torch.tensor(gate, dtype=torch.bfloat16, requires_grad=True)
    expert_act(bf, torch.tensor(up, dtype=torch.bfloat16)).float().sum().backward()
    jax_bf = jax.grad(lambda g: _expert_act(g, jnp.asarray(up, jnp.bfloat16)).astype(
        jnp.float32).sum())(jnp.asarray(gate, jnp.bfloat16))
    np.testing.assert_array_equal(bf.grad.float().numpy()[:5], np.asarray(jax_bf, np.float32)[:5])


# ---------------------------------------------------------------- decoding


@pytest.mark.parametrize("model_type", FAMILIES)
def test_generate_and_serve_refuse_each_family_as_jax(model_type):
    """JAX's `InferenceEngine` and `ServingEngine` refuse a model whose
    `__call__` takes no `decode_state`; the port's engines refuse the same
    families with the same messages."""
    from llm_training_tpu.infer import InferenceEngine as JaxInferenceEngine
    from llm_training_tpu.serve import ServingEngine as JaxServingEngine
    from llm_training_tpu_torch.infer.engine import InferenceEngine, supports_decoding
    from llm_training_tpu_torch.serve.engine import ServingEngine

    jax_model, port_cls, _, config = models(model_type)
    port = port_cls(config, device="cpu")
    assert not supports_decoding(port)
    for jax_engine, engine in ((JaxInferenceEngine, InferenceEngine),
                               (JaxServingEngine, ServingEngine)):
        with pytest.raises(NotImplementedError) as theirs:
            jax_engine(jax_model, {})
        with pytest.raises(NotImplementedError) as ours:
            engine(port, device="cpu")
        assert str(ours.value) == str(theirs.value)
