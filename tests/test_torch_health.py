"""Port parity of the model-health layer on the CPU: the per-layer
grad/param/update norms of `telemetry/health.py` against JAX's
`layer_health_metrics` on the same numpy parameters (carried across by
`models/llama/from_jax.py`, from both JAX layouts) and batches -- plain,
under accumulation 2 (the boundary micro-batch's gradients, the whole
accumulated update) and with int8-offloaded optimizer state -- fp32 norms
within rtol 1e-5; the key set at Llama-3.1-8B widths (8 layers) that
`chip_smoke.py` holds the card's run to; and a fit with health on every
step equal, bit for bit, to one with health off.
"""

import json
from dataclasses import asdict
from pathlib import Path

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from llm_training_tpu.lms.clm import CLM as JaxCLM
from llm_training_tpu.lms.clm import CLMConfig as JaxCLMConfig
from llm_training_tpu.models import Llama as JaxLlama
from llm_training_tpu.models import LlamaConfig as JaxLlamaConfig
from llm_training_tpu.optim.builder import OptimConfig as JaxOptimConfig
from llm_training_tpu.optim.builder import build_optimizer as jax_optimizer
from llm_training_tpu.optim.quantized_state import decode_state, encode_state
from llm_training_tpu.telemetry.health import build_param_groups as jax_groups
from llm_training_tpu.telemetry.health import layer_health_metrics as jax_health
from llm_training_tpu_torch.data.base import BaseDataModule, BaseDataModuleConfig
from llm_training_tpu_torch.lms.clm import CLM, CLMConfig
from llm_training_tpu_torch.models.llama.config import PRESETS, LlamaConfig, preset
from llm_training_tpu_torch.models.llama.from_jax import state_dict_from_jax
from llm_training_tpu_torch.models.llama.model import Llama
from llm_training_tpu_torch.optim.builder import OptimConfig
from llm_training_tpu_torch.telemetry.health import (
    HealthConfig,
    build_param_groups,
    group_of,
    layer_health_metrics,
)
from llm_training_tpu_torch.trainer.trainer import Trainer, TrainerConfig

KEYS_FILE = (Path(__file__).resolve().parent.parent
             / "llm_training_tpu_torch" / "telemetry" / "health_keys.json")
TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
            compute_dtype="float32", param_dtype="float32")
# b2 0.95 as tests/test_torch_train.py's fits: optax bias-corrects nu in
# float32, where 0.999 rounds by 1.3e-8, which moves 1 - b2^2 by 1.3e-5 of
# itself in step 2's update; the port corrects in float64. That difference
# is the optimizer's (held at rtol 1e-4 by the fit tests), not health's
OPTIM = dict(learning_rate=1e-3, lr_scheduler="constant", grad_clip_norm=1.0,
             optimizer_kwargs={"b2": 0.95})
NORMS = dict(rtol=1e-5)  # fp32 norms, summation order only


def _batches(n, seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(1, TINY["vocab_size"], size=(2, 32)).astype(np.int32)
        out.append({"input_ids": ids, "labels": ids.copy(),
                    "segment_ids": np.ones_like(ids),
                    "position_ids": np.broadcast_to(np.arange(32, dtype=np.int32), ids.shape).copy()})
    return out


def _jax_model(scan):
    model = JaxLlama(JaxLlamaConfig(**TINY, scan_layers=scan, attention_impl="xla"))
    boxed = model.init(jax.random.key(0), np.zeros((1, 4), np.int32))
    return model, boxed, jax.device_get(nn.meta.unbox(boxed))


def _jax_health(scan, accumulate=1, steps=1, int8_block=None):
    """The JAX CLM under the JAX optimizer chain (MultiSteps for
    accumulation; the int8 codec between updates as the offloaded state
    stores it), with `layer_health_metrics` on each boundary micro-step, as
    the JAX trainer's health step computes it: the parameters before the
    update, that micro-batch's gradients, the chain's update."""
    model, boxed, params = _jax_model(scan)
    groups = jax_groups(boxed)
    objective = JaxCLM(JaxCLMConfig(), model=model)
    tx, _ = jax_optimizer(JaxOptimConfig(**OPTIM), 10)
    if accumulate > 1:
        tx = optax.MultiSteps(tx, accumulate)
    opt = tx.init(params)
    if int8_block:
        opt = encode_state(opt, block=int8_block)

    @jax.jit
    def step(params, opt, batch):
        inner = decode_state(opt) if int8_block else opt
        grads = jax.grad(lambda p: objective.loss_and_metrics(p, batch, train=True)[0])(params)
        updates, inner = tx.update(grads, inner, params)
        health = jax_health(groups, params, grads, updates)
        opt = encode_state(inner, block=int8_block) if int8_block else inner
        return optax.apply_updates(params, updates), opt, health

    out = []
    for micro, batch in enumerate(_batches(steps * accumulate)):
        params, opt, health = step(params, opt, {k: jnp.asarray(v) for k, v in batch.items()})
        if (micro + 1) % accumulate == 0:
            out.append({k: float(v) for k, v in jax.device_get(health).items()})
    return out


def _port_health(scan, accumulate=1, steps=1, int8_block=None):
    """The same micro-steps through the port's `Trainer.train_micro_step`,
    health on each boundary micro-step."""
    _, _, params = _jax_model(scan)
    config = LlamaConfig(**TINY)
    model = Llama(config, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, config))
    offload = dict(offload_optimizer_state=True, offload_state_dtype="int8",
                   offload_quant_block=int8_block) if int8_block else {}
    trainer = Trainer(TrainerConfig(max_steps=10, accumulate_grad_batches=accumulate,
                                    health=HealthConfig(every_n_steps=1), **offload),
                      device="cpu")
    objective = CLM(CLMConfig(optim=OptimConfig(**OPTIM)), model=model)
    state, _ = trainer.init_state(objective)
    out = []
    for micro, batch in enumerate(_batches(steps * accumulate)):
        boundary = (micro + 1) % accumulate == 0
        metrics = trainer.train_micro_step(objective, state, batch, health=boundary)
        if boundary:
            out.append(layer_health_metrics(trainer._param_groups, metrics["health"].tolist()))
        else:
            assert "health" not in metrics
    return out


def _assert_health_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        keys = sorted(w)
        np.testing.assert_allclose([g[k] for k in keys], [w[k] for k in keys], **NORMS)
        assert all(np.isfinite(list(g.values())))


@pytest.mark.parametrize("scan", [True, False], ids=["scanned", "looped"])
def test_health_matches_jax(scan):
    """Two optimizer steps from the same weights and batches: every key of
    JAX's set, every norm within rtol 1e-5 (AdamW with clip 1.0)."""
    _assert_health_close(_port_health(scan, steps=2), _jax_health(scan, steps=2))


def test_health_under_accumulation_matches_jax():
    """Accumulation 2: the boundary micro-batch's own gradient norms and the
    whole accumulated update, as JAX's MultiSteps health step."""
    _assert_health_close(_port_health(True, accumulate=2, steps=2),
                         _jax_health(True, accumulate=2, steps=2))


def test_health_with_int8_offload_matches_jax():
    """Int8 blocks of 32 between updates (the second update reads the
    decoded state): the update norms follow JAX's codec within rtol 1e-5."""
    _assert_health_close(_port_health(True, steps=2, int8_block=32),
                         _jax_health(True, steps=2, int8_block=32))


def test_health_keys_at_8b_widths_match_jax_and_the_fixture():
    """The key set of Llama-3.1-8B widths at 8 layers, from JAX's
    `layer_health_metrics` under eval_shape in both layouts, equals the
    committed fixture `chip_smoke.py` checks the card's run against, and
    the port's group plan of the same model."""
    kw = dict(PRESETS["llama-3.1-8b"], num_hidden_layers=8)
    keys = []
    for scan in (True, False):
        model = JaxLlama(JaxLlamaConfig(**kw, scan_layers=scan, attention_impl="xla"))
        boxed = jax.eval_shape(lambda k: model.init(k, np.zeros((1, 8), np.int32)),
                               jax.random.key(0))
        groups = jax_groups(boxed)
        abstract = nn.meta.unbox(boxed)
        keys.append(sorted(jax.eval_shape(lambda p: jax_health(groups, p, p, p), abstract)))
    fixture = json.loads(KEYS_FILE.read_text())["llama-3.1-8b, 8 layers"]
    assert keys[0] == keys[1] == fixture
    port = Llama(preset("llama-3.1-8b", num_hidden_layers=8), device="meta")
    plan = build_param_groups(port.named_parameters())
    values = np.zeros((4, len(plan.names)))
    assert sorted(layer_health_metrics(plan, values)) == fixture


def test_group_names_follow_jax_rules():
    assert group_of("model.layers.3.mlp.up_proj.weight") == "layers_03"
    assert group_of("model.embed_tokens.weight") == "embed_tokens"
    assert group_of("lm_head.weight") == "lm_head"
    assert group_of("policy.model.layers.11.input_layernorm.weight") == "policy/layers_11"
    assert group_of("ref.model.norm.weight") == "ref/norm"
    # not a Llama parameter: JAX's rule on the dotted path
    assert group_of("encoder.blocks.2.attn.weight") == "encoder/blocks_02"
    assert group_of("head.proj.weight") == "head/proj"


class _Rows(BaseDataModule):
    def __init__(self, batches):
        super().__init__(BaseDataModuleConfig())
        self.batches = batches

    def setup(self):
        pass

    def train_batches(self, start_step=0):
        for i in range(start_step, 10**6):
            yield self.batches[i % len(self.batches)]


class _Losses:
    def __init__(self):
        self.losses, self.health = [], []

    def on_step_end(self, trainer, step, metrics):
        self.losses.append(metrics["loss"])
        self.health.append(trainer.last_health)


@pytest.fixture
def deterministic():
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before)


@pytest.mark.parametrize("kind", ["plain", "accumulate", "int8"])
def test_health_does_not_change_the_math(kind, deterministic):
    """Health on every optimizer step against health off: the losses and the
    final parameters and optimizer state bit-equal; health published to the
    registry as gauges and to `trainer.last_health`."""
    extra = {"plain": {}, "accumulate": {"accumulate_grad_batches": 2},
             "int8": dict(offload_optimizer_state=True, offload_state_dtype="int8",
                          offload_quant_block=32)}[kind]
    runs = []
    for every in (1, None):
        torch.manual_seed(0)
        recorder = _Losses()
        trainer = Trainer(TrainerConfig(max_steps=3, log_every_n_steps=1, seed=3,
                                        health=HealthConfig(every_n_steps=every), **extra),
                          callbacks=[recorder], device="cpu")
        objective = CLM(CLMConfig(model=None, optim=OptimConfig(**OPTIM)),
                        model=Llama(LlamaConfig(**TINY), device="cpu"))
        objective.model.init_weights(torch.Generator().manual_seed(1))
        state = trainer.fit(objective, _Rows(_batches(4)))
        runs.append((recorder, state.state_dict(), trainer.telemetry.snapshot()))
    (with_h, state_h, snap_h), (without, state_0, snap_0) = runs
    assert with_h.losses == without.losses
    assert state_h.keys() == state_0.keys()
    for name in state_h:
        assert torch.equal(state_h[name], state_0[name]), name
    assert all(h is not None for h in with_h.health) and without.health == [None] * 3
    assert {k for k in snap_h if k.startswith("health/")} == set(with_h.health[-1])
    assert not any(k.startswith("health/") for k in snap_0)


def test_objective_with_router_stats_raises():
    """An objective that reports MoE router statistics (the `with_health`
    flag) waits for the MoE stack."""

    class RouterCLM(CLM):
        def loss_and_metrics(self, batch, rng=None, train=True, with_health=False):
            return super().loss_and_metrics(batch, rng=rng, train=train)

    trainer = Trainer(TrainerConfig(max_steps=1, health=HealthConfig(every_n_steps=1)),
                      device="cpu")
    objective = RouterCLM(CLMConfig(optim=OptimConfig(**OPTIM)),
                          model=Llama(LlamaConfig(**TINY), device="cpu"))
    with pytest.raises(NotImplementedError, match="A.8"):
        trainer.fit(objective, _Rows(_batches(1)))
    with pytest.raises(ValueError):
        HealthConfig(every_n_steps=0)
    assert asdict(HealthConfig()) == {"every_n_steps": None}
