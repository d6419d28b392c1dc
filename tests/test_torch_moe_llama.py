"""Port parity of the MoE stack on the Llama graph (fp32, CPU), for each of
the 8 MoE HF `model_type`s that JAX routes to its `Llama`
(`tests/torch_moe_cases.py`):

- `config_from_hf` builds configs equal field for field; with random
  parameters carried by `state_dict_from_jax`, the port's logits are
  within 1e-4 of JAX's on one packed, padded batch, and the cross-entropy,
  `aux_loss` and every parameter's gradient within 1e-4 (relative norm;
  the port through the ragged impl, G1's plain version, JAX through its
  exact dense one). The router statistics equal JAX's within 1e-5;
- `from_jax` reads JAX's scanned and looped layouts (parameters and an
  optimizer-state tree) to the same state, the expert stacks in JAX's
  layout and the router transposed;
- the cache paths (dense and paged) give the training forward's logits;
- a 5-step CLM fit of qwen2_moe (gated shared expert, no renormalisation)
  with health on every step, from one HF directory JAX exported: the
  port's losses and `aux_loss` within rtol 1e-4 of JAX's `Trainer`, and
  the last step's `health/moe/*` within 1e-5 of JAX's.
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_moe_cases import TYPES, configs, random_params
from torch_threads import one_torch_thread  # noqa: F401

from llm_training_tpu.data.dummy import DummyDataModule as JaxDummy
from llm_training_tpu.data.dummy import DummyDataModuleConfig as JaxDummyConfig
from llm_training_tpu.lms import CLM as JaxCLM
from llm_training_tpu.lms import CLMConfig as JaxCLMConfig
from llm_training_tpu.lms import ModelProvider as JaxProvider
from llm_training_tpu.models import Llama as JaxLlama
from llm_training_tpu.models import hf_io as jax_hf_io
from llm_training_tpu.optim import OptimConfig as JaxOptimConfig
from llm_training_tpu.telemetry.health import HealthConfig as JaxHealthConfig
from llm_training_tpu.trainer import Trainer as JaxTrainer
from llm_training_tpu.trainer import TrainerConfig as JaxTrainerConfig
from llm_training_tpu_torch.cli.config import load_config
from llm_training_tpu_torch.cli.main import build_fit
from llm_training_tpu_torch.infer.engine import init_decode_state
from llm_training_tpu_torch.models.base import PagedDecodeState
from llm_training_tpu_torch.models.llama.from_jax import (
    optimizer_state_from_jax,
    state_dict_from_jax,
)
from llm_training_tpu_torch.models.llama.model import Llama

TOL = 1e-4


def _batch():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 128, (2, 12)).astype(np.int32)
    seg = np.asarray([[1] * 5 + [2] * 7, [1] * 10 + [0] * 2], np.int32)  # packed + padded
    labels = rng.integers(0, 128, (2, 12))
    return ids, seg, labels


@pytest.mark.parametrize("model_type", TYPES)
def test_logits_loss_and_gradients_match_jax(model_type):
    jax_config, config = configs(model_type, scan_layers=False, moe_impl="dense")
    assert dataclasses.asdict(config) == jax_config.model_dump()
    config = dataclasses.replace(config, moe_impl="ragged")
    model = JaxLlama(jax_config)
    params = random_params(model)
    ids, seg, labels = _batch()

    def loss_fn(p):
        out = model.apply(p, input_ids=jnp.asarray(ids), segment_ids=jnp.asarray(seg))
        logp = jax.nn.log_softmax(out.logits, -1)
        ce = -jnp.take_along_axis(logp, jnp.asarray(labels)[..., None], -1).mean()
        return ce + out.aux_loss, (ce, out)

    (_, (jax_ce, jax_out)), jax_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    port = Llama(config, device="cpu")
    port.load_state_dict(state_dict_from_jax(params, config))
    out = port(torch.from_numpy(ids).long(), segment_ids=torch.from_numpy(seg))
    ce = -torch.log_softmax(out.logits, -1).gather(-1, torch.from_numpy(labels)[..., None]).mean()
    (ce + out.aux_loss).backward()
    np.testing.assert_allclose(out.logits.detach().numpy(), np.asarray(jax_out.logits),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(ce.detach()), float(jax_ce), rtol=TOL)
    np.testing.assert_allclose(float(out.aux_loss.detach()), float(jax_out.aux_loss), rtol=TOL)
    assert float(out.ep_dropped_rows) == float(jax_out.ep_dropped_rows) == 0.0
    stats, jax_stats = out.router_stats, jax_out.router_stats
    assert stats.layer_ids == jax_stats.layer_ids == (0, 1)
    for got, want in ((stats.sel_frac, jax_stats.sel_frac),
                      (stats.mean_prob, jax_stats.mean_prob)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    want = state_dict_from_jax(jax_grads, config)
    assert set(want) == {n for n, _ in port.named_parameters()}
    floor = 1e-3 * max(float(g.norm()) for g in want.values())
    errors = {n: float((p.grad - want[n]).norm()) / max(float(want[n].norm()), floor)
              for n, p in port.named_parameters()}
    worst = max(errors, key=errors.get)
    assert errors[worst] <= TOL, (worst, errors[worst])


@pytest.mark.parametrize("model_type", ["qwen2_moe", "granitemoeshared"])
def test_from_jax_reads_both_layouts(model_type):
    """The scanned tree (`layers/layer/mlp/experts_*` of `[L, E, ...]`) and
    the looped one (`layers_{i}/...`) give the same port state; an
    optimizer-state tree in either layout gives the same entries; the
    router is transposed, the stacks are not."""
    jax_config, config = configs(model_type, scan_layers=True)
    scanned = random_params(JaxLlama(jax_config), seed=7)
    looped = {"params": {k: v for k, v in scanned["params"].items() if k != "layers"}}
    for i in range(config.num_hidden_layers):
        looped["params"][f"layers_{i}"] = jax.tree.map(
            lambda a, i=i: a[i], scanned["params"]["layers"]["layer"])
    states, moments = [], []
    for params, scan in ((scanned, True), (looped, False)):
        config = configs(model_type, scan_layers=scan)[1]
        states.append(state_dict_from_jax(params, config))
        moments.append(optimizer_state_from_jax(params, config, "mu"))
    assert states[0].keys() == states[1].keys()
    for name, value in states[0].items():
        assert torch.equal(value, states[1][name]), name
    for name, value in moments[0].items():
        assert torch.equal(value, moments[1][name]), name
    layer = scanned["params"]["layers"]["layer"]["mlp"]
    np.testing.assert_array_equal(states[0]["model.layers.1.mlp.experts_down_proj"].numpy(),
                                  layer["experts_down_proj"][1])
    np.testing.assert_array_equal(states[0]["model.layers.0.mlp.gate.weight"].numpy(),
                                  layer["gate"]["kernel"][0].T)
    np.testing.assert_array_equal(states[1]["model.layers.0.mlp.shared_down_proj"].numpy(),
                                  looped["params"]["layers_0"]["mlp"]["shared_down_proj"])


@pytest.mark.parametrize("model_type", ["qwen3_moe", "phimoe"])
def test_cache_paths_match_the_training_forward(model_type):
    """A 7-token prefill then 5 single-token steps through the dense cache
    and the paged pool give the training forward's logits within 1e-5
    (each token routes on its own, through the ragged impl on every path)."""
    jax_config, config = configs(model_type, moe_impl="ragged")
    model = Llama(config, device="cpu")
    model.load_state_dict(state_dict_from_jax(random_params(JaxLlama(jax_config)), config))
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
                assert out.aux_loss is not None and out.router_stats is not None
                state = out.decode_state
                got.append(out.logits)
            np.testing.assert_allclose(torch.cat(got, 1).numpy(), full.numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=name)


FIT_TYPE = "qwen2_moe"
DATA = dict(batch_size=4, max_length=16, num_samples=40, validation_split=0, vocab_size=128)
OPTIM = dict(learning_rate=2e-3, warmup_steps=2)
STEPS = 5


class _Track:
    def __init__(self):
        self.losses, self.aux = {}, {}

    def on_step_end(self, trainer, step, metrics):
        self.losses[step] = float(metrics["loss"])
        self.aux[step] = float(metrics["aux_loss"])


@pytest.fixture(scope="module")
def fits(tmp_path_factory, devices):
    root = tmp_path_factory.mktemp("moe-fit")
    jax_config, config = configs(FIT_TYPE)
    hf_dir = root / "hf"
    jax_hf_io.save_hf_checkpoint(random_params(JaxLlama(jax_config)), jax_config, hf_dir,
                                 dtype="float32")
    kwargs = {k: v for k, v in jax_config.model_dump().items()
              if k in jax_config.model_fields_set or k in ("compute_dtype", "param_dtype")}
    theirs = _Track()
    jax_trainer = JaxTrainer(JaxTrainerConfig(max_steps=STEPS, log_every_n_steps=1, seed=42,
                                              health=JaxHealthConfig(every_n_steps=1)),
                             callbacks=[theirs], devices=devices[:1])
    jax_trainer.fit(JaxCLM(JaxCLMConfig(
        model=JaxProvider(model_class="llm_training_tpu.models.Llama", model_kwargs=kwargs),
        pre_trained_weights=str(hf_dir), optim=JaxOptimConfig(**OPTIM))),
        JaxDummy(JaxDummyConfig(**DATA)))
    # the port through the ragged impl (G1's plain version), JAX its dense one
    model = {**dataclasses.asdict(config), "moe_impl": "ragged"}
    run = {"seed_everything": 42,
           "trainer": {"max_steps": STEPS, "log_every_n_steps": 1, "limit_val_batches": 0,
                       "health": {"every_n_steps": 1}},
           "model": {"class_path": "llm_training_tpu.lms.CLM", "init_args": {
               "model": {"model_class": "Llama", "model_kwargs": model},
               "pre_trained_weights": str(hf_dir), "optim": OPTIM}},
           "data": {"class_path": "llm_training_tpu.data.DummyDataModule", "init_args": DATA}}
    path = Path(root / "port.json")
    path.write_text(json.dumps(run))
    trainer, objective, datamodule = build_fit(load_config(path), "cpu")
    ours = _Track()
    trainer.callbacks.append(ours)
    trainer.fit(objective, datamodule)
    return dict(ours=ours, theirs=theirs, health=trainer.last_health,
                jax_health=jax_trainer.last_health)


def test_moe_fit_with_aux_loss_matches_jax(fits):
    ours, theirs = fits["ours"], fits["theirs"]
    assert sorted(ours.losses) == sorted(theirs.losses) == list(range(1, STEPS + 1))
    np.testing.assert_allclose([ours.losses[s] for s in sorted(ours.losses)],
                               [theirs.losses[s] for s in sorted(theirs.losses)], rtol=1e-4)
    np.testing.assert_allclose([ours.aux[s] for s in sorted(ours.aux)],
                               [theirs.aux[s] for s in sorted(theirs.aux)], rtol=1e-4)
    assert all(a > 1.0 for a in ours.aux.values())  # ~top_k (2) when balanced


def test_moe_router_health_matches_jax(fits):
    ours = {k: v for k, v in fits["health"].items() if k.startswith("health/moe/")}
    theirs = {k: v for k, v in fits["jax_health"].items() if k.startswith("health/moe/")}
    assert set(ours) == set(theirs)
    assert {"health/moe/router_entropy/layer_00", "health/moe/load_frac/expert_03",
            "health/moe/dropped_frac"} <= set(ours)
    for key, value in theirs.items():
        assert abs(ours[key] - value) <= 1e-5, (key, ours[key], value)
    # the layer norms sit beside them, as in JAX's record
    assert {k for k in fits["health"] if not k.startswith("health/moe/")} == {
        k for k in fits["jax_health"] if not k.startswith("health/moe/")}
