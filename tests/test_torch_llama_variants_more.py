"""The second half of the 28 Llama-graph types of
`test_torch_llama_variants.py`: logits, loss and gradients against JAX's
(fp32, CPU; the same checks, split for the suite's per-file time). Then,
within the port, the variants' cache paths (the dense cache and the
paged pool) and activation checkpointing against the training forward."""

import dataclasses

import numpy as np
import pytest
import torch
from test_torch_llama_variants import check_forward_and_gradients
from torch_llama_variant_cases import FP32, SECOND_HALF, hf_config

from llm_training_tpu_torch.infer.cache import init_decode_state
from llm_training_tpu_torch.models.base import PagedDecodeState
from llm_training_tpu_torch.models.llama import hf_conversion as conv
from llm_training_tpu_torch.models.llama.model import Llama


@pytest.mark.parametrize("model_type", SECOND_HALF)
def test_logits_loss_and_gradients_match_jax(model_type):
    check_forward_and_gradients(model_type)


CACHE_TYPES = ["cohere2", "exaone4", "gpt2", "granite", "ministral", "olmo3", "phi", "smollm3"]


def _random_model(model_type):
    model = Llama(conv.config_from_hf(hf_config(model_type), **FP32), device="cpu")
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for param in model.parameters():
            param.copy_(0.1 * torch.randn(param.shape, generator=gen))
    return model.eval()


@pytest.mark.parametrize("model_type", CACHE_TYPES)
def test_cache_paths_match_the_training_forward(model_type):
    """A 7-token prefill then 5 single-token steps through the dense cache
    (`generate`'s) and through the paged pool (`serve`'s, blocks of 4, rows
    in other blocks) give the training forward's logits within 1e-5: each
    layer's window (past it from step 6 on), rope tables (none on NoPE
    layers, OLMo-3's unscaled ones on its sliding layers) and learned
    positions reach both cache paths (fp32, CPU)."""
    model = _random_model(model_type)
    config = model.config
    ids = torch.from_numpy(np.random.default_rng(5).integers(0, 128, (2, 12)))
    positions = torch.arange(12)[None].expand(2, 12)
    with torch.no_grad():
        full = model(ids).logits
        shape = (config.num_hidden_layers, 9, 4, config.num_key_value_heads,
                 config.resolved_head_dim)
        states = {"dense": init_decode_state(config, 2, 16),
                  "paged": PagedDecodeState(
                      k=torch.zeros(shape), v=torch.zeros(shape),
                      block_tables=torch.tensor([[1, 3, 5, 7], [2, 4, 6, 8]], dtype=torch.int32),
                      lengths=torch.zeros(2, dtype=torch.int32))}
        for name, state in states.items():
            got = []
            for start, end in [(0, 7)] + [(t, t + 1) for t in range(7, 12)]:
                out = model(ids[:, start:end], position_ids=positions[:, start:end],
                            decode_state=state)
                state = out.decode_state
                got.append(out.logits)
            np.testing.assert_allclose(torch.cat(got, 1).numpy(), full.numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=name)


@pytest.mark.parametrize("granularity", ["full", "selective"])
def test_activation_checkpointing_of_a_variant_gives_the_same_gradients(granularity):
    """Each layer's window and rope tables pass through the checkpoint
    wrapper (`remat.run_layer`): a sliding/NoPE-full Cohere2 model's
    gradients with checkpointing equal those without."""
    model = _random_model("cohere2")
    ids = torch.from_numpy(np.random.default_rng(6).integers(0, 128, (2, 12)))
    grads = []
    for remat in (False, True):
        model.config = dataclasses.replace(model.config, enable_gradient_checkpointing=remat,
                                           recompute_granularity=granularity)
        for layer in model.model.layers:
            layer.config = layer.self_attn.config = layer.mlp.config = model.config
        model.zero_grad(set_to_none=True)
        model(ids).logits.square().mean().backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    for name, grad in grads[0].items():
        torch.testing.assert_close(grads[1][name], grad, rtol=1e-6, atol=1e-7, msg=name)
