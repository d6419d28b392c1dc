"""Fits of the Gemma family against the JAX package (fp32, CPU), from the
same carried weights on the same batches, under JAX's `build_optimizer`
chain (AdamW, warm-up, clipping):

- 5-step CLM fits of Gemma-2 in JAX's pairs layout (the fused CE under the
  final soft cap), one of them freezing the MLPs of the odd layers through
  a JAX path pattern (`layers/full/mlp`: the pairs layout's own paths), and
  of Gemma-3: losses within rtol 1e-4, the frozen tensors unchanged;
- a 5-step DPO fit of Gemma-2 (its log-probs under the final soft cap):
  losses within rtol 1e-4, starting at ln 2;
- the `fit` CLI on a Gemma node with a checkpoint, converted by
  `convert_to_hf` and read back by JAX to the restored model's logits."""

import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_gemma_cases import configs, random_params

from llm_training_tpu.lms import CLM as JaxCLM
from llm_training_tpu.lms import CLMConfig as JaxCLMConfig
from llm_training_tpu.lms.dpo import DPO as JaxDPO
from llm_training_tpu.lms.dpo import DPOConfig as JaxDPOConfig
from llm_training_tpu.models import Gemma as JaxGemma
from llm_training_tpu.models import hf_io as jax_hf_io
from llm_training_tpu.models.gemma import hf_conversion as jax_conv
from llm_training_tpu.optim.builder import OptimConfig as JaxOptimConfig
from llm_training_tpu.optim.builder import build_optimizer as jax_optimizer
from llm_training_tpu_torch.data.base import BaseDataModule, BaseDataModuleConfig
from llm_training_tpu_torch.data.preference_tuning.collator import PreferenceTuningDataCollator
from llm_training_tpu_torch.lms import DPO, DPOConfig
from llm_training_tpu_torch.lms.clm import CLM, CLMConfig
from llm_training_tpu_torch.models.gemma import Gemma
from llm_training_tpu_torch.models.llama.from_jax import optimizer_state_from_jax, state_dict_from_jax
from llm_training_tpu_torch.optim.builder import OptimConfig
from llm_training_tpu_torch.trainer.trainer import Trainer, TrainerConfig
from torch_threads import one_torch_thread  # noqa: F401

STEPS = 5
FIT_RTOL = 1e-4
OPTIM = dict(learning_rate=2e-3, warmup_steps=2, grad_clip_norm=1.0,
             optimizer_kwargs={"weight_decay": 0.1})
# DPO's loss is a small margin around ln 2: at 2e-3 AdamW's unit steps on
# near-zero gradient elements move it by more than fp32's last bits allow
DPO_OPTIM = dict(OPTIM, learning_rate=5e-4)


class _Batches(BaseDataModule):
    def __init__(self, batches):
        super().__init__(BaseDataModuleConfig())
        self.batches = batches

    def setup(self):
        pass

    def train_batches(self, start_step=0):
        yield from self.batches[start_step:]


class _Losses:
    def __init__(self):
        self.losses = []

    def on_step_end(self, trainer, step, metrics):
        self.losses.append(metrics["loss"])


def _jax_fit(objective, params, batches, frozen=None, optim=OPTIM, with_state=False):
    tx, _ = jax_optimizer(JaxOptimConfig(**optim), STEPS, frozen)
    state = tx.init(params)

    @jax.jit
    def step(params, state, batch):
        loss_fn = lambda p: objective.loss_and_metrics(p, batch, train=True)[0]  # noqa: E731
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state, loss

    losses = []
    for batch in batches:
        params, state, loss = step(params, state, {k: jnp.asarray(v) for k, v in batch.items()})
        losses.append(float(loss))
    return (losses, params, jax.device_get(state)) if with_state else (losses, params)


def _clm_batches(seed):
    """Two packed and padded batches, visited in turn (so the loss falls)."""
    rng = np.random.default_rng(seed)
    seg = np.ones((2, 16), np.int32)
    seg[0, 6:] = 2
    seg[1, 13:] = 0
    distinct = [{"input_ids": rng.integers(0, 128, (2, 16)).astype(np.int32), "segment_ids": seg}
                for _ in range(2)]
    return [distinct[i % 2] for i in range(STEPS)]


@pytest.mark.parametrize("name,frozen", [
    ("v2_pairs", None), ("v2_pairs", ["layers/full/mlp"]), ("v3", None),
], ids=["gemma2_pairs", "gemma2_pairs_frozen_full_mlp", "gemma3"])
def test_clm_fit_matches_jax(name, frozen):
    jax_config, config = configs(name)
    model = JaxGemma(jax_config)
    variables = random_params(model, seed=3)
    batches = _clm_batches(4)
    jax_objective = JaxCLM(JaxCLMConfig(frozen_modules=frozen or []), model=model)
    expected, final = _jax_fit(jax_objective, variables, batches, frozen)
    port = Gemma(config, device="cpu")
    port.load_state_dict(state_dict_from_jax(variables, config))
    recorder = _Losses()
    objective = CLM(CLMConfig(optim=OptimConfig(**OPTIM), frozen_modules=frozen or []),
                    model=port)
    state = Trainer(TrainerConfig(max_steps=STEPS, log_every_n_steps=1), callbacks=[recorder],
                    device="cpu").fit(objective, _Batches(batches))
    np.testing.assert_allclose(recorder.losses, expected, rtol=FIT_RTOL)
    assert recorder.losses[-1] < recorder.losses[0]
    if frozen:
        initial = state_dict_from_jax(variables, config)
        after = dict(state.model.named_parameters())
        for layer in range(config.num_hidden_layers):
            name_ = f"model.layers.{layer}.mlp.up_proj.weight"
            assert torch.equal(after[name_], initial[name_]) == (layer % 2 == 1), name_
        want = state_dict_from_jax(jax.device_get(final), config)
        for key in ("model.layers.1.mlp.down_proj.weight", "model.layers.0.mlp.down_proj.weight"):
            np.testing.assert_allclose(after[key].detach().numpy(), want[key].numpy(),
                                       rtol=1e-4, atol=1e-6)


# Adafactor whose stacks factor at the tiny widths (the pairs' [2, in, out])
ADAFACTOR = dict(optimizer="adafactor", learning_rate=1e-2, warmup_steps=2,
                 optimizer_kwargs={"min_dim_size_to_factor": 8})


def test_adafactor_fit_in_the_pairs_layout_matches_optax():
    """Adafactor over Gemma-2's scanned (sliding, full) pairs: optax clips
    each leaf's update by that leaf's RMS, so the port's statistics and
    clipping are per half (`layers/sliding`, `layers/full`). A 5-step fit:
    losses within rtol 1e-4 of JAX's, the final parameters within rtol
    1e-4, and JAX's final factored statistics, read by
    `optimizer_state_from_jax` in the pairs layout, equal to the port's
    within 1e-5."""
    jax_config, config = configs("v2_pairs")
    model = JaxGemma(jax_config)
    variables = random_params(model, seed=3)
    batches = _clm_batches(4)
    expected, final, opt_state = _jax_fit(JaxCLM(JaxCLMConfig(), model=model), variables,
                                          batches, optim=ADAFACTOR, with_state=True)
    port = Gemma(config, device="cpu")
    port.load_state_dict(state_dict_from_jax(variables, config))
    recorder = _Losses()
    objective = CLM(CLMConfig(optim=OptimConfig(**ADAFACTOR)), model=port)
    state = Trainer(TrainerConfig(max_steps=STEPS, log_every_n_steps=1), callbacks=[recorder],
                    device="cpu").fit(objective, _Batches(batches))
    np.testing.assert_allclose(recorder.losses, expected, rtol=FIT_RTOL)
    want = state_dict_from_jax(jax.device_get(final), config)
    for name, value in state.model.named_parameters():
        np.testing.assert_allclose(value.detach().numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    factored = [x for x in jax.tree.leaves(opt_state, is_leaf=lambda x: isinstance(
        x, optax.FactoredState)) if isinstance(x, optax.FactoredState)]
    live = state.optimizer.state_dict()
    assert live["v_row.model.layers.sliding.mlp.up_proj.weight"].shape == (2, 64)
    compared = 0
    for field in ("v_row", "v_col", "v"):
        for key, value in optimizer_state_from_jax(getattr(factored[0], field), config, field,
                                                   per_leaf=True).items():
            value = value.numpy()
            np.testing.assert_allclose(live[key].numpy(), value, rtol=1e-5,
                                       atol=1e-6 * np.abs(value).max(), err_msg=key)
            compared += 1
    assert compared == len([k for k in live if k.split(".")[0] in ("v_row", "v_col", "v")])


def _preference_batches(seed):
    rng = np.random.default_rng(seed)
    examples = []
    for _ in range(2 * STEPS):
        prompt = rng.integers(1, 128, int(rng.integers(2, 7)))
        example = {}
        for side in ("chosen", "rejected"):
            ids = np.concatenate([prompt, rng.integers(1, 128, int(rng.integers(1, 7)))])
            labels = ids.copy()
            labels[:len(prompt)] = -100
            example.update({f"{side}_input_ids": ids.tolist(), f"{side}_labels": labels.tolist(),
                            f"{side}_length": len(ids)})
        examples.append(example)
    # one width (pairs are at most 12 tokens): JAX compiles its step once
    collate = PreferenceTuningDataCollator(types.SimpleNamespace(
        tokenizer=types.SimpleNamespace(pad_token_id=0), pad_to_multiple_of=16), "right")
    return [collate(examples[i:i + 2]) for i in range(0, len(examples), 2)]


def test_dpo_fit_matches_jax():
    jax_config, config = configs("v2_pairs")
    model = JaxGemma(jax_config)
    variables = random_params(model, seed=5)
    batches = [{k: np.asarray(v) for k, v in b.items()} for b in _preference_batches(6)]
    expected, _ = _jax_fit(JaxDPO(JaxDPOConfig(), model=model),
                           {"policy": variables, "ref": variables}, batches, optim=DPO_OPTIM)
    port = Gemma(config, device="cpu")
    port.load_state_dict(state_dict_from_jax(variables, config))
    recorder = _Losses()
    Trainer(TrainerConfig(max_steps=STEPS, log_every_n_steps=1), callbacks=[recorder],
            device="cpu").fit(DPO(DPOConfig(optim=OptimConfig(**DPO_OPTIM)), model=port),
                              _Batches([{k: torch.from_numpy(np.array(v)) for k, v in b.items()}
                                        for b in batches]))
    np.testing.assert_allclose(recorder.losses, expected, rtol=FIT_RTOL)
    assert recorder.losses[0] == pytest.approx(np.log(2.0), rel=1e-6)


def test_fit_cli_on_a_gemma_node_then_convert_to_hf(tmp_path):
    """`fit` builds a Gemma-2 node (`model_class: Gemma`) from a JSON config,
    checkpoints it, and `convert_to_hf` exports the checkpoint as `gemma2`;
    JAX reads the export to the restored model's logits within 1e-4."""
    from llm_training_tpu_torch.cli.config import load_config
    from llm_training_tpu_torch.cli.main import build_fit
    from llm_training_tpu_torch.convert_to_hf import main as convert_main
    from llm_training_tpu_torch.models import hf_io

    _, config = configs("v2_pairs")
    kwargs = {k: v for k, v in config.__dict__.items() if v is not None}
    config_path = tmp_path / "run.json"
    config_path.write_text(importlib.import_module("json").dumps({
        "seed_everything": 7,
        "trainer": {"max_steps": 2, "log_every_n_steps": 1,
                    "checkpoint": {"dirpath": str(tmp_path / "ckpt"), "async_save": False}},
        "model": {"class_path": "llm_training_tpu.lms.CLM", "init_args": {
            "model": {"model_class": "llm_training_tpu.models.Gemma", "model_kwargs": kwargs},
            "optim": {"learning_rate": 1e-3, "warmup_steps": 1}}},
        "data": {"class_path": "llm_training_tpu.data.DummyDataModule", "init_args": {
            "batch_size": 2, "max_length": 16, "num_samples": 8, "validation_split": 0,
            "vocab_size": 128}},
    }))
    trainer, objective, data = build_fit(load_config(config_path), "cpu")
    state = trainer.fit(objective, data)
    assert type(state.model) is Gemma
    assert convert_main([str(tmp_path / "ckpt"), str(tmp_path / "hf"), "--dtype",
                         "float32"]) == 0
    written = hf_io.load_hf_config(tmp_path / "hf")
    assert written["model_type"] == "gemma2"
    jax_config = jax_conv.config_from_hf(written, compute_dtype="float32", param_dtype="float32",
                                         attention_impl="xla")
    params = jax_hf_io.load_pretrained_params(jax_config, tmp_path / "hf")
    ids = np.random.default_rng(1).integers(0, 128, (2, 12)).astype(np.int32)
    expected = JaxGemma(jax_config).apply(params, jnp.asarray(ids)).logits
    with torch.no_grad():
        ours = state.model.eval()(torch.from_numpy(ids).long()).logits
    np.testing.assert_allclose(ours.numpy(), np.asarray(expected), rtol=1e-4, atol=1e-4)
