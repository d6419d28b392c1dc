"""Port parity of the non-Llama MoE families (fp32, CPU), for each HF
`model_type` JAX routes to them (`tests/torch_moe_family_cases.py`):
DeepSeek's v2 and v3 routers and MLA (deepseek_v2, deepseek_v3, kimi_k2),
GLM-4.5 and dots1, gpt-oss, ERNIE-4.5-MoE and HunYuan-MoE.

`config_from_hf` builds configs equal field for field; with random
parameters carried by `state_dict_from_jax`, the port's logits are within
1e-4 of JAX's on one packed, padded batch, and the cross-entropy, the aux
loss (gpt-oss) and every parameter's gradient within 1e-4 in relative norm
(the port through the ragged impl, G1's plain version; JAX through its
exact dense one); the router statistics within 1e-5, in the same layers.
Each type against JAX's looped tree, each family against its scanned one
too. JAX's reference runs jitted, one model per type and layout.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_moe_cases import random_params
from torch_moe_family_cases import TYPES, models
from torch_threads import one_torch_thread  # noqa: F401

from llm_training_tpu_torch.models.llama.from_jax import state_dict_from_jax

TOL = 1e-4


def _batch():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 128, (2, 12)).astype(np.int32)
    seg = np.asarray([[1] * 5 + [2] * 7, [1] * 10 + [0] * 2], np.int32)  # packed + padded
    labels = rng.integers(0, 128, (2, 12))
    return ids, seg, labels


# every type against JAX's looped tree, and each family against its scanned
# one (a scanned MoE suffix, a scanned sliding/full period, every layer)
CASES = [(t, False) for t in TYPES] + [
    (t, True) for t in ("deepseek_v3", "ernie4_5_moe", "glm4_moe", "gpt_oss", "hunyuan_v1_moe")]


@pytest.mark.parametrize("model_type,scan", CASES,
                         ids=[f"{t}-{'scanned' if s else 'looped'}" for t, s in CASES])
def test_logits_loss_and_gradients_match_jax(model_type, scan):
    jax_model, port_cls, jax_config, config = models(model_type, scan_layers=scan)
    assert dataclasses.asdict(config) == jax_config.model_dump()
    config = dataclasses.replace(config, moe_impl="ragged")
    params = random_params(jax_model)
    ids, seg, labels = _batch()

    def loss_fn(p):
        out = jax_model.apply(p, input_ids=jnp.asarray(ids), segment_ids=jnp.asarray(seg))
        logp = jax.nn.log_softmax(out.logits, -1)
        ce = -jnp.take_along_axis(logp, jnp.asarray(labels)[..., None], -1).mean()
        return ce + (0.0 if out.aux_loss is None else out.aux_loss), (ce, out)

    (_, (jax_ce, jax_out)), jax_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    port = port_cls(config, device="cpu")
    port.load_state_dict(state_dict_from_jax(params, config))
    out = port(torch.from_numpy(ids).long(), segment_ids=torch.from_numpy(seg))
    ce = -torch.log_softmax(out.logits, -1).gather(-1, torch.from_numpy(labels)[..., None]).mean()
    (ce + (0.0 if out.aux_loss is None else out.aux_loss)).backward()
    np.testing.assert_allclose(out.logits.detach().numpy(), np.asarray(jax_out.logits),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(ce.detach()), float(jax_ce), rtol=TOL)
    assert (out.aux_loss is None) == (jax_out.aux_loss is None) == (model_type != "gpt_oss")
    if out.aux_loss is not None:
        np.testing.assert_allclose(float(out.aux_loss.detach()), float(jax_out.aux_loss),
                                   rtol=TOL)
    assert float(out.ep_dropped_rows) == float(jax_out.ep_dropped_rows) == 0.0
    stats, jax_stats = out.router_stats, jax_out.router_stats
    assert stats.layer_ids == jax_stats.layer_ids
    for got, want in ((stats.sel_frac, jax_stats.sel_frac),
                      (stats.mean_prob, jax_stats.mean_prob)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    want = state_dict_from_jax(jax_grads, config)
    assert set(want) == {n for n, _ in port.named_parameters()}
    floor = 1e-3 * max(float(g.norm()) for g in want.values())
    # the selection-correction bias takes no gradient in either (JAX's
    # stop_gradient; the port detaches it)
    errors = {n: float(((torch.zeros_like(p) if p.grad is None else p.grad) - want[n]).norm())
              / max(float(want[n].norm()), floor) for n, p in port.named_parameters()}
    worst = max(errors, key=errors.get)
    assert errors[worst] <= TOL, (worst, errors[worst])
