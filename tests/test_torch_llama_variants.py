"""Port parity of the Llama graph's variants, forward and gradients: for
each dense HF `model_type` that JAX routes to its `Llama` (this file the
first half of the 28, `test_torch_llama_variants_more.py` the second),
a tiny config built by both packages' `config_from_hf` (equal field for
field), random parameters (biases, norms and xIELU's scalars included)
carried across by `state_dict_from_jax`, and one packed, padded batch:
logits within 1e-4 of JAX's, and the next-token cross-entropy and each
parameter's gradient within 1e-4 (relative norm) of `jax.value_and_grad`.
JAX runs its looped layout (the one it forces for `layer_types` and
`no_rope_layers`), eagerly, on the CPU through its XLA attention (fp32)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_llama_variant_cases import FIRST_HALF, configs, random_params

from llm_training_tpu.models import Llama as JaxLlama
from llm_training_tpu_torch.models.llama.from_jax import state_dict_from_jax
from llm_training_tpu_torch.models.llama.model import Llama

TOL = 1e-4


def _batch():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 128, (2, 12)).astype(np.int32)
    seg = np.asarray([[1] * 5 + [2] * 7, [1] * 10 + [0] * 2], np.int32)  # packed + padded
    labels = rng.integers(0, 128, (2, 12))
    return ids, seg, labels


def check_forward_and_gradients(model_type: str) -> None:
    jax_config, config = configs(model_type, scan_layers=False)
    theirs = {k: v for k, v in jax_config.model_dump().items()}
    assert dataclasses.asdict(config) == theirs
    model = JaxLlama(jax_config)
    params = random_params(model)
    ids, seg, labels = _batch()

    def loss_fn(p):
        logits = model.apply(p, input_ids=jnp.asarray(ids), segment_ids=jnp.asarray(seg)).logits
        logp = jax.nn.log_softmax(logits, -1)
        return -jnp.take_along_axis(logp, jnp.asarray(labels)[..., None], -1).mean(), logits

    (jax_loss, jax_logits), jax_grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    port = Llama(config, device="cpu")
    port.load_state_dict(state_dict_from_jax(params, config))
    logits = port(torch.from_numpy(ids).long(), segment_ids=torch.from_numpy(seg)).logits
    loss = -torch.log_softmax(logits, -1).gather(-1, torch.from_numpy(labels)[..., None]).mean()
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jax_logits), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(loss), float(jax_loss), rtol=TOL)
    want = state_dict_from_jax(jax_grads, config)
    assert set(want) == {n for n, _ in port.named_parameters()}
    # a tensor whose true gradient is ~0 (a key bias without rotary: the
    # softmax ignores a shift shared by all keys) is held against a floor
    floor = 1e-3 * max(float(g.norm()) for g in want.values())
    errors = {n: float((p.grad - want[n]).norm()) / max(float(want[n].norm()), floor)
              for n, p in port.named_parameters()}
    worst = max(errors, key=errors.get)
    assert errors[worst] <= TOL, (worst, errors[worst])


@pytest.mark.parametrize("model_type", FIRST_HALF)
def test_logits_loss_and_gradients_match_jax(model_type):
    check_forward_and_gradients(model_type)
