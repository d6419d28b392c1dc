"""The hybrid families' fits against JAX's `Trainer` (fp32, CPU), from one HF
directory JAX exported (`tests/torch_hybrid_cases.py`):

- Qwen3-Next (gated DeltaNet, gated attention, the MoE with its aux loss)
  and Bamba (Mamba-2, attention): 5-step CLM fits with `segment_state_reset`
  on rows packed with two documents (positions restarting) and rows of one;
  the port's losses (and Qwen3-Next's `aux_loss`) within rtol 1e-4 of
  JAX's. The documents start at chunk starts: a start inside a chunk makes
  JAX's gradients NaN (ROADMAP C.50; `test_torch_hybrid_families.py` holds
  the port's gradients there to JAX's forward-mode derivatives);
- DPO over Qwen3-Next (policy and frozen reference, as JAX's
  `test_dpo_on_hybrid_recurrent_family` runs it): 4 steps, the first loss
  ln 2, the losses within rtol 1e-4 of JAX's `Trainer`, the reference
  unchanged;
- `frozen_modules` patterns and Adafactor's per-leaf state follow the JAX
  tree's periodic layout (`layers/slot{j}`).
"""

import dataclasses
import re
import types

import numpy as np
import pytest
import torch
from torch_hybrid_cases import models
from torch_moe_cases import random_params
from torch_threads import one_torch_thread  # noqa: F401

from llm_training_tpu.data.base import BaseDataModule as JaxBaseDataModule
from llm_training_tpu.data.base import BaseDataModuleConfig as JaxBaseDataModuleConfig
from llm_training_tpu.data.preference_tuning.collator import (
    PreferenceTuningDataCollator as JaxCollator,
)
from llm_training_tpu.lms import CLM as JaxCLM
from llm_training_tpu.lms import CLMConfig as JaxCLMConfig
from llm_training_tpu.lms import ModelProvider as JaxProvider
from llm_training_tpu.lms.dpo import DPO as JaxDPO
from llm_training_tpu.lms.dpo import DPOConfig as JaxDPOConfig
from llm_training_tpu.models import hf_io as jax_hf_io
from llm_training_tpu.optim import OptimConfig as JaxOptimConfig
from llm_training_tpu.trainer import Trainer as JaxTrainer
from llm_training_tpu.trainer import TrainerConfig as JaxTrainerConfig
from llm_training_tpu_torch.data.base import BaseDataModule, BaseDataModuleConfig
from llm_training_tpu_torch.data.preference_tuning.collator import PreferenceTuningDataCollator
from llm_training_tpu_torch.lms import DPO, DPOConfig
from llm_training_tpu_torch.lms.base import ModelProvider
from llm_training_tpu_torch.lms.clm import CLM, CLMConfig
from llm_training_tpu_torch.models.llama.from_jax import state_dict_from_jax
from llm_training_tpu_torch.optim.builder import Optimizer, OptimConfig, _frozen
from llm_training_tpu_torch.trainer.trainer import Trainer, TrainerConfig

OPTIM = dict(learning_rate=2e-3, warmup_steps=2)
STEPS = 5
SEQ = 16  # two chunks of 8


def _packed_batches(seed: int, steps: int) -> list[dict]:
    """`steps` batches of two rows: documents of 8 and 8 tokens (each start
    at a chunk's start) and one of 16, positions restarting."""
    rng = np.random.default_rng(seed)
    seg = np.asarray([[1] * 8 + [2] * 8, [1] * SEQ], np.int32)
    pos = np.asarray([list(range(8)) * 2, list(range(SEQ))], np.int32)
    out = []
    for _ in range(steps):
        ids = rng.integers(0, 128, (2, SEQ)).astype(np.int32)
        out.append({"input_ids": ids, "labels": ids.copy(), "segment_ids": seg.copy(),
                    "position_ids": pos.copy()})
    return out


def _batches_module(base, config_cls, batches):
    """A data module of either package streaming `batches` in order."""

    class Batches(base):
        def setup(self):
            pass

        def train_batches(self, start_step=0, skip_list=None):
            yield from batches[start_step:]

        def val_batches(self):
            yield from ()

    return Batches(config_cls())


class _Track:
    def __init__(self):
        self.losses, self.aux = {}, {}

    def on_step_end(self, trainer, step, metrics):
        self.losses[step] = float(metrics["loss"])
        if "aux_loss" in metrics:
            self.aux[step] = float(metrics["aux_loss"])


def _kwargs(jax_config) -> dict:
    return {k: v for k, v in jax_config.model_dump().items()
            if k in jax_config.model_fields_set or k in ("compute_dtype", "param_dtype")}


@pytest.fixture(scope="module", params=["qwen3_next", "bamba"])
def fits(request, tmp_path_factory, devices):
    model_type = request.param
    root = tmp_path_factory.mktemp(f"fit-{model_type}")
    jax_model, _, jax_config, config = models(model_type, segment_state_reset=True)
    hf_dir = root / "hf"
    jax_hf_io.save_hf_checkpoint(random_params(jax_model), jax_config, hf_dir, dtype="float32")
    batches = _packed_batches(5, STEPS)
    theirs = _Track()
    jax_trainer = JaxTrainer(JaxTrainerConfig(max_steps=STEPS, log_every_n_steps=1, seed=42),
                             callbacks=[theirs], devices=devices[:1])
    jax_trainer.fit(JaxCLM(JaxCLMConfig(
        model=JaxProvider(model_class=f"llm_training_tpu.models.{type(jax_model).__name__}",
                          model_kwargs=_kwargs(jax_config)),
        pre_trained_weights=str(hf_dir), optim=JaxOptimConfig(**OPTIM))),
        _batches_module(JaxBaseDataModule, JaxBaseDataModuleConfig, batches))
    # the port through the ragged impl (G1's plain version), JAX its dense one
    kwargs = dataclasses.asdict(config)
    if "moe_impl" in kwargs:
        kwargs["moe_impl"] = "ragged"
    ours = _Track()
    trainer = Trainer(TrainerConfig(max_steps=STEPS, log_every_n_steps=1, seed=42),
                      callbacks=[ours], device="cpu")
    trainer.fit(CLM(CLMConfig(model=ModelProvider(type(jax_model).__name__, kwargs),
                              pre_trained_weights=str(hf_dir), optim=OptimConfig(**OPTIM))),
                _batches_module(BaseDataModule, BaseDataModuleConfig, batches))
    return dict(type=model_type, ours=ours, theirs=theirs)


def test_fit_with_segment_resets_matches_jax(fits):
    """Losses within rtol 1e-4 of JAX's `Trainer`, Qwen3-Next's aux loss
    too, none where JAX has none (Bamba); the losses fall."""
    ours, theirs = fits["ours"], fits["theirs"]
    assert sorted(ours.losses) == sorted(theirs.losses) == list(range(1, STEPS + 1))
    np.testing.assert_allclose([ours.losses[s] for s in sorted(ours.losses)],
                               [theirs.losses[s] for s in sorted(theirs.losses)], rtol=1e-4)
    assert all(np.isfinite(list(ours.losses.values())))
    assert sorted(ours.aux) == sorted(theirs.aux)
    assert bool(ours.aux) == (fits["type"] == "qwen3_next")
    np.testing.assert_allclose([ours.aux[s] for s in sorted(ours.aux)],
                               [theirs.aux[s] for s in sorted(theirs.aux)], rtol=1e-4)


def _pairs(seed: int, steps: int) -> list[list[dict]]:
    """Seeded preference pairs, two a step: a shared prompt (labels -100)
    and two responses."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        step = []
        for _ in range(2):
            prompt = rng.integers(1, 128, int(rng.integers(2, 7)))
            example = {}
            for side in ("chosen", "rejected"):
                ids = np.concatenate([prompt, rng.integers(1, 128, int(rng.integers(2, 9)))])
                labels = ids.copy()
                labels[:len(prompt)] = -100
                example.update({f"{side}_input_ids": ids.tolist(),
                                f"{side}_labels": labels.tolist(), f"{side}_length": len(ids)})
            step.append(example)
        out.append(step)
    return out


def test_dpo_over_qwen3_next_matches_jax(tmp_path, devices):
    """DPO (beta 0.1, constant 1e-3) from one HF directory: the first loss
    ln 2 (policy == reference), 4 losses within rtol 1e-4 of JAX's
    `Trainer`, the reference bit-equal to its initial weights."""
    jax_model, _, jax_config, config = models("qwen3_next")
    params = random_params(jax_model, seed=5)
    jax_hf_io.save_hf_checkpoint(params, jax_config, tmp_path / "hf", dtype="float32")
    collate = types.SimpleNamespace(tokenizer=types.SimpleNamespace(pad_token_id=0),
                                    pad_to_multiple_of=16)
    pairs = _pairs(11, 4)
    jax_batches = [JaxCollator(collate, "right")(step) for step in pairs]
    batches = [PreferenceTuningDataCollator(collate, "right")(step) for step in pairs]
    optim = dict(learning_rate=1e-3, lr_scheduler="constant")
    theirs = _Track()
    JaxTrainer(JaxTrainerConfig(max_steps=4, log_every_n_steps=1, seed=42), callbacks=[theirs],
               devices=devices[:1]).fit(
        JaxDPO(JaxDPOConfig(
            model=JaxProvider(model_class="llm_training_tpu.models.Qwen3Next",
                              model_kwargs=_kwargs(jax_config)),
            pre_trained_weights=str(tmp_path / "hf"), optim=JaxOptimConfig(**optim), beta=0.1)),
        _batches_module(JaxBaseDataModule, JaxBaseDataModuleConfig, jax_batches))
    ours = _Track()
    kwargs = {**dataclasses.asdict(config), "moe_impl": "ragged"}
    state = Trainer(TrainerConfig(max_steps=4, log_every_n_steps=1, seed=42), callbacks=[ours],
                    device="cpu").fit(
        DPO(DPOConfig(model=ModelProvider("Qwen3Next", kwargs),
                      pre_trained_weights=str(tmp_path / "hf"), optim=OptimConfig(**optim),
                      beta=0.1)),
        _batches_module(BaseDataModule, BaseDataModuleConfig, batches))
    steps = sorted(theirs.losses)
    assert sorted(ours.losses) == steps == [1, 2, 3, 4]
    assert ours.losses[1] == pytest.approx(np.log(2.0), rel=1e-6)
    np.testing.assert_allclose([ours.losses[s] for s in steps], [theirs.losses[s] for s in steps],
                               rtol=1e-4)
    initial = state_dict_from_jax(params, config)
    for name, p in state.model.ref.named_parameters():
        assert torch.equal(p, initial[name].to(p.dtype)), name


def test_frozen_patterns_and_adafactor_follow_the_jax_layout():
    """A `frozen_modules` pattern matches the JAX tree's periodic path
    (`params/layers/slot1/self_attn/...`: the softmax layers); Adafactor
    keeps one state a JAX leaf, the two cycles' layers sharing theirs."""
    _, port_cls, _, config = models("qwen3_next")
    model = port_cls(config, device="cpu")
    layout = config.jax_layout
    names = [n for n, _ in model.named_parameters()]
    frozen = [n for n in names if _frozen(n, [re.compile("layers/slot1/self_attn")], layout)]
    assert frozen and all(".self_attn." in n and n.split(".")[2] in ("1", "3") for n in frozen)
    opt = Optimizer(list(model.named_parameters()), OptimConfig(optimizer="adafactor"),
                    lambda count: 1e-3, scan_layers=layout)
    assert opt.adafactor_layout == str(layout) == "period2"
    stacked = [[opt.names[i] for i in g.members] for g in opt.groups if g.stacked]
    assert stacked and all(len(g) == 2 and len({n.split(".")[2] for n in g}) == 2
                           for g in stacked)
    layer_params = [n for n in names if n.startswith("model.layers.")]
    assert sum(len(g) for g in stacked) == len(layer_params)
