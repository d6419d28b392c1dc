"""Port parity of the Gemma family (versions 1, 2 and 3) against the JAX
package's `Gemma` (fp32, CPU; JAX through its XLA attention):

- `GemmaConfig` field for field (the tiny variants and the three presets)
  and JAX's refusals with JAX's messages;
- logits within 1e-4, and the CLM loss (fused CE under the final soft
  cap) and every parameter's gradient within 1e-4 in relative norm, for
  each JAX tree layout carried across by `from_jax` (scanned, scanned
  (sliding, full) pairs, looped);
- a whole JAX `TrainState` (AdamW moments in the pairs layout) carried
  across; Gemma-2's paired scan refusing a cache in both packages;
- greedy tokens of the port's `ServingEngine` (the paged pool) equal to
  JAX's `ServingEngine`, and of `generate` (the dense cache) equal to
  JAX's `InferenceEngine`;
- the fused cross-entropy with Gemma-2's final soft cap against JAX's
  (`tests/test_gemma.py::test_clm_fused_loss_applies_final_softcap`)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_gemma_cases import VARIANTS, batch, configs, random_params

from llm_training_tpu.infer import GenerateConfig as JaxGenerateConfig
from llm_training_tpu.infer import InferenceEngine as JaxEngine
from llm_training_tpu.lms import CLM as JaxCLM
from llm_training_tpu.lms import CLMConfig as JaxCLMConfig
from llm_training_tpu.models import Gemma as JaxGemma
from llm_training_tpu.models import GemmaConfig as JaxGemmaConfig
from llm_training_tpu.models.base import PagedDecodeState as JaxPagedState
from llm_training_tpu.serve import ServeConfig as JaxServeConfig
from llm_training_tpu.serve import ServingEngine as JaxServingEngine
from llm_training_tpu_torch.infer.engine import GenerateConfig, InferenceEngine
from llm_training_tpu_torch.lms.clm import CLM, CLMConfig
from llm_training_tpu_torch.models.base import PagedDecodeState
from llm_training_tpu_torch.models.gemma import Gemma, GemmaConfig
from llm_training_tpu_torch.models.gemma import config as gemma_config
from llm_training_tpu_torch.models.llama.from_jax import (
    state_dict_from_jax,
    train_state_dict_from_jax,
)
from llm_training_tpu_torch.ops import cross_entropy as ce
from llm_training_tpu_torch.serve.engine import ServeConfig, ServingEngine
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-4


def _jax_ce():
    import importlib

    return importlib.import_module("llm_training_tpu.ops.cross_entropy")


@pytest.mark.parametrize("name", [*VARIANTS, *gemma_config.PRESETS])
def test_config_matches_jax_field_for_field(name):
    """The port's config equals JAX's after validation (v3 turns qk-norm
    on and loops its layers in both), and both derive the same scale,
    windows and rope configs."""
    if name in VARIANTS:
        jax_config, config = configs(name)
    else:
        jax_config = JaxGemmaConfig(**gemma_config.PRESETS[name])
        config = gemma_config.preset(name)
    assert dataclasses.asdict(config) == jax_config.model_dump()
    assert config.attention_scale == jax_config.attention_scale
    layers = range(config.num_hidden_layers)
    assert [config.layer_sliding_window(i) for i in layers] == [
        jax_config.layer_sliding_window(i) for i in layers]
    for ours, theirs in ((config.rope_config, jax_config.rope_config),
                         (config.local_rope_config, jax_config.local_rope_config)):
        assert (ours.type, ours.base, ours.dim, ours.max_position_embeddings, ours.scaling) == (
            theirs.type, theirs.base, theirs.dim, theirs.max_position_embeddings, theirs.scaling)


def test_presets_are_the_published_shapes():
    """Gemma-2-9B: 16 q heads over 8 kv heads of 256, windows of 4096 on even
    layers, caps 50 and 30; Gemma-3-4B: a 5:1 pattern over 34 layers;
    gemma-2b: MQA."""
    g2 = gemma_config.preset("gemma-2-9b")
    assert (g2.hidden_size, g2.num_hidden_layers, g2.num_attention_heads,
            g2.num_key_value_heads, g2.head_dim) == (3584, 42, 16, 8, 256)
    assert [g2.layer_sliding_window(i) for i in range(4)] == [4096, None, 4096, None]
    assert (g2.attn_logit_softcapping, g2.final_logit_softcapping) == (50.0, 30.0)
    g3 = gemma_config.preset("gemma-3-4b")
    assert g3.layer_types.count("full_attention") == 5 and g3.scan_layers is False
    assert [i for i, t in enumerate(g3.layer_types) if t == "full_attention"] == [
        5, 11, 17, 23, 29]
    assert gemma_config.preset("gemma-2b").num_key_value_heads == 1


@pytest.mark.parametrize("fields", [
    dict(version=1, attn_logit_softcapping=5.0),
    dict(version=1, sliding_window=4),
    dict(version=2, num_hidden_layers=3),
    dict(version=3, sliding_window=4),
    dict(version=3, layer_types=["full_attention"] * 3),
    dict(version=2, layer_types=["full_attention"] * 4),
    dict(num_attention_heads=3),
], ids=["v1_cap", "v1_window", "v2_odd_scan", "v3_window_no_types", "v3_types_length",
        "v2_types", "heads"])
def test_config_errors_match_jax(fields):
    kw = dict(VARIANTS["v1"], num_key_value_heads=2, **fields)
    with pytest.raises(ValueError) as theirs:
        JaxGemmaConfig(**kw)
    with pytest.raises(ValueError) as ours:
        GemmaConfig(**kw)
    assert str(ours.value) in str(theirs.value)


def _jax_model(name, **fields):
    jax_config, config = configs(name, **fields)
    model = JaxGemma(jax_config)
    return model, config, random_params(model)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_logits_loss_and_gradients_match_jax(name):
    """Each layout's tree carried across by `from_jax`: logits within 1e-4;
    the CLM loss (the fused CE, Gemma-2's final soft cap in it) and each
    parameter's gradient within 1e-4 in relative norm."""
    model, config, variables = _jax_model(name)
    ids, seg = batch()
    jax_batch = {"input_ids": jnp.asarray(ids), "segment_ids": jnp.asarray(seg)}
    objective = JaxCLM(JaxCLMConfig(), model=model)

    def loss_fn(v):
        logits = model.apply(v, **jax_batch).logits
        return objective.loss_and_metrics(v, jax_batch, train=False)[0], logits

    # one jitted program: XLA's compile costs less than these graphs' eager
    # dispatch
    (jax_loss, jax_logits), jax_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables)
    port = Gemma(config, device="cpu")
    port.load_state_dict(state_dict_from_jax(variables, config))
    torch_batch = {"input_ids": torch.from_numpy(ids).long(),
                   "segment_ids": torch.from_numpy(seg)}
    with torch.no_grad():
        logits = port(**torch_batch).logits
    np.testing.assert_allclose(logits.numpy(), np.asarray(jax_logits), rtol=TOL, atol=TOL)
    loss = CLM(CLMConfig(), model=port).loss_and_metrics(torch_batch, train=False)[0]
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jax_loss), rtol=TOL)
    want = state_dict_from_jax(jax_grads, config)
    assert set(want) == {n for n, _ in port.named_parameters()}
    errors = {n: float((p.grad - want[n]).norm() / want[n].norm())
              for n, p in port.named_parameters()}
    worst = max(errors, key=errors.get)
    assert errors[worst] <= TOL, (worst, errors[worst])


def test_a_train_state_in_the_pairs_layout_carries_across():
    """A JAX `TrainState`'s arrays in Gemma-2's pairs layout (AdamW's `mu`
    and `nu`, the count, the key, the step) map onto the port's names: an
    odd layer's tensors come from the `full` branch at index layer // 2,
    transposed where JAX stores a Dense kernel."""
    model, config, variables = _jax_model("v2_pairs")
    params = variables["params"]
    mu = jax.tree.map(lambda a: a + 1.0, params)
    nu = jax.tree.map(lambda a: a * a, params)
    state = train_state_dict_from_jax(config, params={"params": params}, step=7,
                                      rng=np.asarray([3, 9], np.uint32), count=7,
                                      mu={"params": mu}, nu={"params": nu})
    kernel = params["layers"]["full"]["self_attn"]["q_proj"]["kernel"][1]  # layer 3
    assert torch.equal(state["model.model.layers.3.self_attn.q_proj.weight"],
                       torch.from_numpy(np.ascontiguousarray(kernel.T)))
    norm = mu["layers"]["sliding"]["pre_feedforward_layernorm"]["weight"][1]  # layer 2
    assert torch.equal(state["optimizer.mu.model.layers.2.pre_feedforward_layernorm.weight"],
                       torch.from_numpy(norm))
    names = {n for n, _ in Gemma(config, device="meta").named_parameters()}
    assert {k.removeprefix("optimizer.nu.") for k in state if k.startswith("optimizer.nu.")} == (
        names)
    assert int(state["step"]) == 7 and state["rng"].tolist() == [3, 9]


def test_paired_scan_refuses_a_cache_as_jax_does():
    """JAX cannot KV-decode Gemma-2's paired scan body; neither does the
    port (a serving config loops the layers)."""
    model, config, variables = _jax_model("v2_pairs")
    shape = (4, 3, 4, 2, 16)
    jax_state = JaxPagedState(k=jnp.zeros(shape), v=jnp.zeros(shape),
                              block_tables=jnp.ones((1, 1), jnp.int32),
                              lengths=jnp.zeros(1, jnp.int32))
    with pytest.raises(NotImplementedError, match="paired") as theirs:
        model.apply(variables, jnp.zeros((1, 1), jnp.int32), decode_state=jax_state)
    port = Gemma(config, device="cpu")
    state = PagedDecodeState(k=torch.zeros(shape), v=torch.zeros(shape),
                             block_tables=torch.ones((1, 1), dtype=torch.int32),
                             lengths=torch.zeros(1, dtype=torch.int32))
    with pytest.raises(NotImplementedError) as ours:
        port(torch.zeros((1, 1), dtype=torch.long), decode_state=state)
    assert str(ours.value) == str(theirs.value)


PROMPTS = [[3, 17, 42, 7, 11, 9, 8, 2], [5, 9], [1, 2, 3, 4, 60, 61]]


@pytest.mark.parametrize("name", ["v1", "v2_looped", "v3"])
def test_greedy_serve_and_generate_tokens_match_jax(name):
    """Greedy tokens of the paged `ServingEngine` (rows past the window,
    chunked prefill) equal JAX's `ServingEngine`; `generate` over the dense
    cache (ragged left-padded prompts) equals JAX's `InferenceEngine`, its
    logprobs within 1e-5."""
    model, config, variables = _jax_model(name)
    port = Gemma(config, device="cpu")
    port.load_state_dict(state_dict_from_jax(variables, config))
    port.eval()
    serve = dict(max_batch=2, max_model_len=32, block_size=8, prefill_chunk=4,
                 eos_token_id=None)
    requests = [{"id": str(i), "prompt": p, "max_new_tokens": 10} for i, p in enumerate(PROMPTS)]
    expected = JaxServingEngine(model, variables, JaxServeConfig(**serve)).run(requests)
    got = ServingEngine(port, ServeConfig(**serve), device="cpu").run(requests)

    def tokens(events):
        return {e["id"]: e["tokens"] for e in events if e["type"] == "done"}

    assert tokens(got) == tokens(expected) and len(tokens(got)) == 3
    want = JaxEngine(model, variables).generate(PROMPTS, JaxGenerateConfig(max_new_tokens=8))
    result = InferenceEngine(port, device="cpu").generate(PROMPTS, GenerateConfig(max_new_tokens=8))
    for key in ("tokens", "sequences", "lengths", "stop_reasons"):
        assert result[key] == want[key], key
    for ours, theirs in zip(result["logprobs"], want["logprobs"]):
        np.testing.assert_allclose(ours, theirs, atol=1e-5)


@pytest.mark.parametrize("cap", [None, 3.0, 30.0])
def test_fused_cross_entropy_with_the_final_soft_cap_matches_jax(cap):
    """The fused CE caps each chunk's logits (cap tanh(z / cap)) before the
    log-softmax: the sum, the count and both gradients equal JAX's."""
    rng = np.random.default_rng(21)
    hidden = (rng.standard_normal((40, 32)) * 2).astype(np.float32)
    weight = rng.standard_normal((32, 96)).astype(np.float32)
    labels = rng.integers(0, 96, 40)
    labels[::7] = -100
    jax_ce = _jax_ce()

    def jax_total(h, w):
        return jax_ce.fused_linear_cross_entropy(h, w, jnp.asarray(labels), chunk_size=16,
                                                 logits_soft_cap=cap)[0]

    total_j, (dh_j, dw_j) = jax.value_and_grad(jax_total, argnums=(0, 1))(
        jnp.asarray(hidden), jnp.asarray(weight))
    h = torch.from_numpy(hidden).requires_grad_()
    w = torch.from_numpy(weight).requires_grad_()
    total, count = ce.fused_linear_cross_entropy(h, w, torch.from_numpy(labels), chunk_size=16,
                                                 logits_soft_cap=cap)
    total.backward()
    assert int(count) == int((labels != -100).sum())
    np.testing.assert_allclose(float(total.detach()), float(total_j), rtol=1e-5)
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(dh_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(dw_j), rtol=1e-5, atol=1e-5)


def test_a_length_dependent_rope_on_gemma3_matches_jax():
    """Gemma-3's global tables under a `dynamic` rope_scaling (the NTK base
    chosen from the forward's length, past 8 positions here) and the local
    ones unscaled: logits within 1e-4 of JAX's."""
    model, config, variables = _jax_model(
        "v3", max_position_embeddings=8, rope_scaling={"rope_type": "dynamic", "factor": 2.0})
    ids, seg = batch()
    expected = jax.jit(model.apply)(variables, input_ids=jnp.asarray(ids),
                                    segment_ids=jnp.asarray(seg)).logits
    port = Gemma(config, device="cpu")
    port.load_state_dict(state_dict_from_jax(variables, config))
    with torch.no_grad():
        logits = port(torch.from_numpy(ids).long(), segment_ids=torch.from_numpy(seg)).logits
    np.testing.assert_allclose(logits.numpy(), np.asarray(expected), rtol=TOL, atol=TOL)
