"""The non-Llama MoE families' fits against JAX's `Trainer` (fp32, CPU):

- gpt-oss (sinks, windows, the clamped experts, the aux loss on) and
  GLM-4.5 (DeepSeek-V3's router with its correction bias, a dense layer
  first): 5-step CLM fits from one HF directory JAX exported, with health
  on every step; the port's losses (and gpt-oss's `aux_loss`) within rtol
  1e-4 of JAX's, the last step's `health/moe/*` within 1e-5;
- frozen `frozen_modules` patterns and Adafactor's per-leaf state follow
  the JAX tree's layout (a scanned MoE suffix, a scanned period);
- the mesh refuses these families, naming ROADMAP A.9b.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_moe_cases import random_params
from torch_moe_family_cases import models
from torch_threads import one_torch_thread  # noqa: F401

from llm_training_tpu.data.dummy import DummyDataModule as JaxDummy
from llm_training_tpu.data.dummy import DummyDataModuleConfig as JaxDummyConfig
from llm_training_tpu.lms import CLM as JaxCLM
from llm_training_tpu.lms import CLMConfig as JaxCLMConfig
from llm_training_tpu.lms import ModelProvider as JaxProvider
from llm_training_tpu.models import hf_io as jax_hf_io
from llm_training_tpu.optim import OptimConfig as JaxOptimConfig
from llm_training_tpu.telemetry.health import HealthConfig as JaxHealthConfig
from llm_training_tpu.trainer import Trainer as JaxTrainer
from llm_training_tpu.trainer import TrainerConfig as JaxTrainerConfig
from llm_training_tpu_torch.cli.config import load_config
from llm_training_tpu_torch.cli.main import build_fit
from llm_training_tpu_torch.optim.builder import Optimizer, OptimConfig, _frozen

DATA = dict(batch_size=4, max_length=16, num_samples=40, validation_split=0, vocab_size=128)
OPTIM = dict(learning_rate=2e-3, warmup_steps=2)
STEPS = 5
FIT_TYPES = ["gpt_oss", "glm4_moe"]


class _Track:
    def __init__(self):
        self.losses, self.aux = {}, {}

    def on_step_end(self, trainer, step, metrics):
        self.losses[step] = float(metrics["loss"])
        if "aux_loss" in metrics:
            self.aux[step] = float(metrics["aux_loss"])


@pytest.fixture(scope="module", params=FIT_TYPES)
def fits(request, tmp_path_factory, devices):
    model_type = request.param
    root = tmp_path_factory.mktemp(f"fit-{model_type}")
    jax_model, _, jax_config, config = models(model_type)
    hf_dir = root / "hf"
    jax_hf_io.save_hf_checkpoint(random_params(jax_model), jax_config, hf_dir, dtype="float32")
    kwargs = {k: v for k, v in jax_config.model_dump().items()
              if k in jax_config.model_fields_set or k in ("compute_dtype", "param_dtype")}
    theirs = _Track()
    jax_trainer = JaxTrainer(JaxTrainerConfig(max_steps=STEPS, log_every_n_steps=1, seed=42,
                                              health=JaxHealthConfig(every_n_steps=1)),
                             callbacks=[theirs], devices=devices[:1])
    jax_trainer.fit(JaxCLM(JaxCLMConfig(
        model=JaxProvider(model_class=f"llm_training_tpu.models.{type(jax_model).__name__}",
                          model_kwargs=kwargs),
        pre_trained_weights=str(hf_dir), optim=JaxOptimConfig(**OPTIM))),
        JaxDummy(JaxDummyConfig(**DATA)))
    # the port through the ragged impl (G1's plain version), JAX its dense one
    model = {**dataclasses.asdict(config), "moe_impl": "ragged"}
    run = {"seed_everything": 42,
           "trainer": {"max_steps": STEPS, "log_every_n_steps": 1, "limit_val_batches": 0,
                       "health": {"every_n_steps": 1}},
           "model": {"class_path": "llm_training_tpu.lms.CLM", "init_args": {
               "model": {"model_class": type(jax_model).__name__, "model_kwargs": model},
               "pre_trained_weights": str(hf_dir), "optim": OPTIM}},
           "data": {"class_path": "llm_training_tpu.data.DummyDataModule", "init_args": DATA}}
    path = Path(root / "port.json")
    path.write_text(json.dumps(run))
    trainer, objective, datamodule = build_fit(load_config(path), "cpu")
    ours = _Track()
    trainer.callbacks.append(ours)
    trainer.fit(objective, datamodule)
    return dict(type=model_type, ours=ours, theirs=theirs, health=trainer.last_health,
                jax_health=jax_trainer.last_health)


def test_fit_matches_jax(fits):
    """Losses within rtol 1e-4 of JAX's `Trainer`, gpt-oss's aux loss too
    (near top_k, 2, when balanced), and no aux loss where JAX has none; the
    last step's router health within 1e-5."""
    ours, theirs = fits["ours"], fits["theirs"]
    assert sorted(ours.losses) == sorted(theirs.losses) == list(range(1, STEPS + 1))
    np.testing.assert_allclose([ours.losses[s] for s in sorted(ours.losses)],
                               [theirs.losses[s] for s in sorted(theirs.losses)], rtol=1e-4)
    assert sorted(ours.aux) == sorted(theirs.aux)
    assert bool(ours.aux) == (fits["type"] == "gpt_oss")
    np.testing.assert_allclose([ours.aux[s] for s in sorted(ours.aux)],
                               [theirs.aux[s] for s in sorted(theirs.aux)], rtol=1e-4)
    assert all(a > 1.0 for a in ours.aux.values())
    health = {k: v for k, v in fits["health"].items() if k.startswith("health/moe/")}
    jax_health = {k: v for k, v in fits["jax_health"].items() if k.startswith("health/moe/")}
    assert set(health) == set(jax_health) and health
    for key, value in jax_health.items():
        assert abs(health[key] - value) <= 1e-5, (key, health[key], value)


@pytest.mark.parametrize("model_type", ["glm4_moe", "gpt_oss"])
def test_frozen_patterns_and_adafactor_follow_the_jax_layout(model_type):
    """A `frozen_modules` pattern matches the JAX tree's path of the
    config's layout (`params/moe_layers/layer/...`, `params/layers/slot1/
    ...`, the looped prefix's `params/layers_0/...`); Adafactor keeps one
    state a JAX leaf, the stacked layers' parameters sharing theirs."""
    import re

    _, port_cls, _, config = models(model_type)
    model = port_cls(config, device="cpu")
    layout = config.jax_layout
    names = [n for n, _ in model.named_parameters()]
    stack = "moe_layers/layer" if model_type == "glm4_moe" else "layers/slot1"
    frozen = [n for n in names if _frozen(n, [re.compile(stack + "/self_attn")], layout)]
    assert frozen and all(".self_attn." in n for n in frozen)
    opt = Optimizer(list(model.named_parameters()), OptimConfig(optimizer="adafactor"),
                    lambda count: 1e-3, scan_layers=layout)
    assert opt.adafactor_layout == str(layout)
    # the JAX tree's leaves: a stacked leaf groups its layers' parameters
    stacked = [[opt.names[i] for i in g.members] for g in opt.groups if g.stacked]
    assert stacked and all(len(g) == 2 and len({n.split(".")[2] for n in g}) == 2
                           for g in stacked)
    assert len(opt.groups) == len(stacked) + sum(1 for g in opt.groups if not g.stacked)


@pytest.mark.parametrize("model_type", ["deepseek_v3", "gpt_oss"])
def test_the_mesh_refuses_the_families(model_type):
    from llm_training_tpu_torch.parallel.sharding import parallelize

    _, port_cls, _, config = models(model_type)
    with pytest.raises(NotImplementedError, match="A.9b"):
        parallelize(port_cls(config, device="meta"), mesh=None)
