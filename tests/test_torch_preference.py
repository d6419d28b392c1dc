"""Port parity of preference tuning on the CPU: `fused_linear_log_probs`,
the preference collator, the DPO and ORPO objectives (loss, metrics and
gradients) and 20-step DPO and ORPO fits, against the JAX package on the
same numpy inputs and carried weights (a tiny fp32 Llama: vocab 512,
hidden 32, 2 layers). Also validation from a checkpoint and the CLI's
handling of the preference objectives.
"""

import importlib
import json
import types

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from llm_training_tpu.data.preference_tuning.collator import (
    PreferenceTuningDataCollator as JaxCollator,
)
from llm_training_tpu.lms.dpo import DPO as JaxDPO
from llm_training_tpu.lms.dpo import DPOConfig as JaxDPOConfig
from llm_training_tpu.lms.orpo import ORPO as JaxORPO
from llm_training_tpu.lms.orpo import ORPOConfig as JaxORPOConfig
from llm_training_tpu.models import Llama as JaxLlama
from llm_training_tpu.models import LlamaConfig as JaxLlamaConfig
from llm_training_tpu.optim.builder import OptimConfig as JaxOptimConfig
from llm_training_tpu.optim.builder import build_optimizer as jax_optimizer
from llm_training_tpu_torch.cli.config import instantiate_from_config
from llm_training_tpu_torch.cli.main import main as cli_main
from llm_training_tpu_torch.data.base import BaseDataModule, BaseDataModuleConfig
from llm_training_tpu_torch.data.preference_tuning.collator import PreferenceTuningDataCollator
from llm_training_tpu_torch.lms import DPO, ORPO, DPOConfig, ORPOConfig
from llm_training_tpu_torch.lms.base import ModelProvider
from llm_training_tpu_torch.lms.clm import CLM, CLMConfig, head_and_bias
from llm_training_tpu_torch.models.llama.config import LlamaConfig
from llm_training_tpu_torch.models.llama.from_jax import state_dict_from_jax
from llm_training_tpu_torch.models.llama.model import Llama
from llm_training_tpu_torch.ops import cross_entropy as ce
from llm_training_tpu_torch.optim.builder import OptimConfig
from llm_training_tpu_torch.trainer.checkpoint import CheckpointConfig, Checkpointer
from llm_training_tpu_torch.trainer.trainer import Trainer, TrainerConfig, _batch_counts
from torch_threads import one_torch_thread  # noqa: F401

jax_ce = importlib.import_module("llm_training_tpu.ops.cross_entropy")
VOCAB = 512
TINY = dict(
    vocab_size=VOCAB, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, head_dim=8, max_position_embeddings=128,
    rms_norm_eps=1e-5, rope_theta=10000.0, compute_dtype="float32", param_dtype="float32",
)
RTOL = 1e-5  # fp32: summation order only
GRAD_TOL = 1e-4  # of the tensor's max |g|: a backward through two layers
FIT_RTOL = 1e-4  # the fit parity tolerance (tests/test_torch_train.py)
STEPS = 20
OPTIM = dict(learning_rate=2e-3, warmup_steps=3, min_lr_ratio=0.1, grad_clip_norm=1.0,
             optimizer_kwargs={"b2": 0.95, "weight_decay": 0.1})


def _t(x):
    return torch.from_numpy(np.array(x))


def _jax_model(seed=0):
    model = JaxLlama(JaxLlamaConfig(**TINY, scan_layers=True, attention_impl="xla"))
    variables = model.init(jax.random.key(seed), np.zeros((1, 4), np.int32))
    return model, jax.device_get(nn.meta.unbox(variables))


def _perturbed(tree, seed=1, scale=0.02):
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        node = np.asarray(node)
        return (node + scale * rng.standard_normal(node.shape)).astype(node.dtype)

    return walk(tree)


def _examples(rng, pairs, truncated=()):
    """Seeded preference pairs: a shared prompt (labels -100) and two
    responses; rows in `truncated` have a chosen response cut to nothing
    (every chosen label -100, as when the prompt fills max_length)."""
    out = []
    for row in range(pairs):
        prompt = rng.integers(1, VOCAB, int(rng.integers(2, 9)))
        example = {}
        for side in ("chosen", "rejected"):
            response = rng.integers(1, VOCAB, int(rng.integers(1, 9)))
            ids = np.concatenate([prompt, response])
            labels = ids.copy()
            labels[:len(prompt)] = -100
            if side == "chosen" and row in truncated:
                labels[:] = -100
            example.update({f"{side}_input_ids": ids.tolist(), f"{side}_labels": labels.tolist(),
                            f"{side}_length": len(ids)})
        out.append(example)
    return out


def _collate(examples, side="right", multiple=None):
    config = types.SimpleNamespace(tokenizer=types.SimpleNamespace(pad_token_id=0),
                                   pad_to_multiple_of=multiple)
    return PreferenceTuningDataCollator(config, side)(examples)


def _max_rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


# ---------------------------------------------------------------- fused_linear_log_probs


def _log_probs_case(seed=0):
    rng = np.random.default_rng(seed)
    hidden = rng.standard_normal((3, 10, 16)).astype(np.float32)
    weight = (0.3 * rng.standard_normal((16, 37))).astype(np.float32)
    bias = rng.standard_normal(37).astype(np.float32)
    labels = rng.integers(0, 37, (3, 10))
    labels[:, :3] = -100
    labels[1, :] = -100  # a fully ignored row
    mix = rng.standard_normal(3).astype(np.float32)  # weighs the rows in the gradient
    return hidden, weight, bias, labels, mix


@pytest.mark.parametrize("cap,use_bias", [(None, False), (5.0, True)], ids=["plain", "cap_bias"])
@pytest.mark.parametrize("chunk", [1, 4, 7, 10], ids=["chunk1", "chunk4", "chunk7", "whole"])
def test_fused_linear_log_probs_matches_jax(chunk, cap, use_bias):
    """Per-row sums and counts within rtol 1e-5 of JAX's, over chunks that
    divide the row, leave an uneven tail or cover it whole, with a soft cap
    and a bias; the gradients of hidden and weight within 1e-5 of max|g|."""
    hidden, weight, bias, labels, mix = _log_probs_case()
    b = bias if use_bias else None

    def jax_fn(h, w):
        logps, counts = jax_ce.fused_linear_log_probs(
            h, w, jnp.asarray(labels), chunk_size=chunk, logits_soft_cap=cap,
            bias=None if b is None else jnp.asarray(b))
        return (logps * mix).sum(), (logps, counts)

    (_, (jlogps, jcounts)), jgrads = jax.value_and_grad(jax_fn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(hidden), jnp.asarray(weight))
    h, w = _t(hidden).requires_grad_(), _t(weight).requires_grad_()
    logps, counts = ce.fused_linear_log_probs(h, w, _t(labels), chunk_size=chunk,
                                              logits_soft_cap=cap,
                                              bias=None if b is None else _t(b))
    (logps * _t(mix)).sum().backward()
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    assert counts[1] == 0 and logps[1] == 0.0
    np.testing.assert_allclose(logps.detach().numpy(), np.asarray(jlogps), rtol=RTOL)
    assert _max_rel(h.grad.numpy(), jgrads[0]) <= 1e-5
    assert _max_rel(w.grad.numpy(), jgrads[1]) <= 1e-5


@pytest.mark.parametrize("chunk", [4, 10], ids=["chunk4", "whole"])
def test_fused_linear_log_probs_bf16_matches_jax(chunk):
    """bf16 hidden and weight: the logits are the product's fp32
    accumulator in both packages, so the per-row sums agree within rtol
    1e-5; the bf16 gradients within one bf16 step (2^-8 of max|g|), as the
    bf16 fused cross-entropy's (`tests/test_torch_train.py`)."""
    hidden, weight, _, labels, mix = _log_probs_case(3)

    def jax_fn(h, w):
        logps, _ = jax_ce.fused_linear_log_probs(h, w, jnp.asarray(labels), chunk_size=chunk)
        return (logps * mix).sum(), logps

    (_, jlogps), jgrads = jax.value_and_grad(jax_fn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(hidden, jnp.bfloat16), jnp.asarray(weight, jnp.bfloat16))
    h = _t(hidden).bfloat16().requires_grad_()
    w = _t(weight).bfloat16().requires_grad_()
    logps, _ = ce.fused_linear_log_probs(h, w, _t(labels), chunk_size=chunk)
    (logps * _t(mix)).sum().backward()
    assert logps.dtype == torch.float32 and h.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(logps.detach().numpy(), np.asarray(jlogps), rtol=RTOL)
    for got, ref in ((h.grad, jgrads[0]), (w.grad, jgrads[1])):
        assert _max_rel(got.float().numpy(), np.asarray(ref.astype(jnp.float32))) <= 2.0**-8


def test_head_and_bias_tied_and_untied():
    """The head matrix is `[embed, vocab]`: the lm_head's weight transposed,
    or the embedding table's when tied; the port's Llama heads have no bias."""
    for tied in (False, True):
        model = Llama(LlamaConfig(**{**TINY, "tie_word_embeddings": tied}), device="cpu")
        head, bias = head_and_bias(model)
        table = model.model.embed_tokens.weight if tied else model.lm_head.weight
        assert head.shape == (32, VOCAB) and bias is None
        assert head.data_ptr() == table.data_ptr()


# ---------------------------------------------------------------- the collator


@pytest.mark.parametrize("multiple", [None, 64], ids=["longest", "multiple64"])
@pytest.mark.parametrize("side", ["right", "left"])
def test_preference_collator_matches_jax(side, multiple):
    examples = _examples(np.random.default_rng(4), 3)
    config = types.SimpleNamespace(tokenizer=types.SimpleNamespace(pad_token_id=7),
                                   pad_to_multiple_of=multiple)
    ours = PreferenceTuningDataCollator(config, side)(examples)
    theirs = JaxCollator(config, side)(examples)
    assert ours.keys() == theirs.keys()
    for key in ours:
        assert ours[key].dtype == theirs[key].dtype
        np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)
    if multiple:
        assert ours["chosen_input_ids"].shape[1] == multiple


def test_batch_counts_of_a_preference_batch():
    """The trainer counts a preference batch's pairs, and the non-padding
    tokens of both sides."""
    batch = _collate(_examples(np.random.default_rng(5), 3), multiple=64)
    tokens = int((batch["chosen_segment_ids"] > 0).sum() + (batch["rejected_segment_ids"] > 0).sum())
    assert _batch_counts(batch) == (3, tokens)


# ---------------------------------------------------------------- the objectives


def _dpo_pair(label_smoothing=0.0, perturb=True):
    """JAX params `{policy, ref}` (a perturbed policy beside the initial
    weights) and the port's DPO on the same weights."""
    jax_model, ref = _jax_model()
    params = {"policy": _perturbed(ref) if perturb else ref, "ref": ref}
    objective = DPO(DPOConfig(model=ModelProvider("Llama", TINY),
                              label_smoothing=label_smoothing))
    pair = objective.configure_model(torch.device("cpu"), torch.Generator().manual_seed(0))
    pair.load_state_dict(state_dict_from_jax(params, LlamaConfig(**TINY)))
    jax_objective = JaxDPO(JaxDPOConfig(label_smoothing=label_smoothing), model=jax_model)
    return jax_objective, params, objective


def _against_jax(jax_objective, params, objective, batch):
    """Loss, metrics and gradients of both objectives on one batch."""
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_objective.loss_and_metrics(p, jbatch), has_aux=True))(params)
    loss, metrics = objective.loss_and_metrics({k: _t(v) for k, v in batch.items()})
    loss.backward()
    assert metrics.keys() == jmetrics.keys()
    for key, value in jmetrics.items():
        np.testing.assert_allclose(float(metrics[key]), float(value), rtol=RTOL, atol=1e-7,
                                   err_msg=key)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=RTOL)
    return jmetrics, jgrads


@pytest.mark.parametrize("label_smoothing", [0.0, 0.1], ids=["ls0", "ls0.1"])
def test_dpo_matches_jax(label_smoothing):
    """The DPO loss and its eight metrics within rtol 1e-5 of JAX's on a
    perturbed policy; the policy's gradients within 1e-4 of max|g|; the
    reference has no gradient (JAX's are zero)."""
    jax_objective, params, objective = _dpo_pair(label_smoothing)
    batch = _collate(_examples(np.random.default_rng(6), 4))
    jmetrics, jgrads = _against_jax(jax_objective, params, objective, batch)
    assert len(jmetrics) == 8
    expected = state_dict_from_jax(jgrads, LlamaConfig(**TINY))
    for name, p in objective.pair.named_parameters():
        if name.startswith("ref."):
            assert p.grad is None and not p.requires_grad
            assert not expected[name].any(), name
        else:
            assert _max_rel(p.grad.numpy(), expected[name].numpy()) <= GRAD_TOL, name


def test_dpo_loss_is_ln2_where_policy_is_reference():
    """Policy == reference: every log-ratio is 0, the loss is ln 2 and no
    reward is above another."""
    _, _, objective = _dpo_pair(perturb=False)
    loss, metrics = objective.loss_and_metrics(
        {k: _t(v) for k, v in _collate(_examples(np.random.default_rng(7), 3)).items()})
    assert float(loss.detach()) == pytest.approx(np.log(2.0), rel=1e-7)
    assert float(metrics["reward_accuracy"]) == 0.0


def test_orpo_matches_jax():
    """The ORPO loss and its ten metrics within rtol 1e-5 of JAX's, with a
    pair whose chosen response is fully truncated (count 0: the clamped
    log-odds keep the loss finite); gradients within 1e-4 of max|g|."""
    jax_model, params = _jax_model()
    model = Llama(LlamaConfig(**TINY), device="cpu")
    model.load_state_dict(state_dict_from_jax(params, LlamaConfig(**TINY)))
    objective = ORPO(ORPOConfig(), model=model)
    batch = _collate(_examples(np.random.default_rng(8), 4, truncated=(2,)))
    jmetrics, jgrads = _against_jax(JaxORPO(JaxORPOConfig(), model=jax_model), params,
                                    objective, batch)
    assert len(jmetrics) == 10 and np.isfinite(float(jmetrics["loss"]))
    expected = state_dict_from_jax(jgrads, LlamaConfig(**TINY))
    for name, p in model.named_parameters():
        assert _max_rel(p.grad.numpy(), expected[name].numpy()) <= GRAD_TOL, name


def test_dpo_reference_is_an_exact_copy_and_frozen():
    """Built from the config, the reference starts bit-equal to the policy,
    requires no gradient, and `^ref/` is frozen for the optimizer; a config
    `ref_model` is initialised from the same generator state."""
    objective = DPO(DPOConfig(model=ModelProvider("Llama", TINY)))
    assert objective.config.frozen_modules == ["^ref/"]
    pair = objective.configure_model(torch.device("cpu"), torch.Generator().manual_seed(3))
    for (name, p), (_, r) in zip(pair.policy.named_parameters(), pair.ref.named_parameters()):
        assert torch.equal(p, r) and p.data_ptr() != r.data_ptr(), name
        assert p.requires_grad and not r.requires_grad
    other = DPO(DPOConfig(model=ModelProvider("Llama", TINY),
                          ref_model=ModelProvider("Llama", TINY)))
    other_pair = other.configure_model(torch.device("cpu"), torch.Generator().manual_seed(3))
    for p, r in zip(other_pair.policy.parameters(), other_pair.ref.parameters()):
        assert torch.equal(p, r)
    # no pre-trained source: nothing is loaded into either model
    assert objective.pretrained_sources(pair.policy, None) == (None, None)


# ---------------------------------------------------------------- the fits


class _Batches(BaseDataModule):
    def __init__(self, batches, val=()):
        super().__init__(BaseDataModuleConfig())
        self.batches, self.val = batches, list(val)

    def setup(self):
        pass

    def train_batches(self, start_step=0):
        yield from self.batches[start_step:]

    def val_batches(self):
        yield from self.val


class _Losses:
    def __init__(self):
        self.losses = []

    def on_step_end(self, trainer, step, metrics):
        self.losses.append(metrics["loss"])


def _jax_fit(objective, params, batches, accumulate):
    """The JAX objective under the JAX build_optimizer chain with its
    `frozen_modules` (and optax.MultiSteps for accumulation): the loss of
    each optimizer step's last micro-batch, and the final params."""
    tx, _ = jax_optimizer(JaxOptimConfig(**OPTIM), STEPS, objective.config.frozen_modules or None)
    if accumulate > 1:
        tx = optax.MultiSteps(tx, accumulate)
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
    return losses[accumulate - 1::accumulate]


@pytest.mark.parametrize("accumulate", [1, 2])
@pytest.mark.parametrize("kind", ["dpo", "orpo"])
def test_preference_fit_matches_jax(kind, accumulate):
    """20 optimizer steps from the same weights on the same collated
    batches: the port's Trainer follows the JAX chain within rtol 1e-4. DPO
    starts at ln 2 (policy == reference) and its reference stays bit-equal
    to its initial weights; both losses fall."""
    jax_model, params = _jax_model(seed=1)
    config = LlamaConfig(**TINY)
    rng = np.random.default_rng(9)
    # padded to one width (pairs are at most 16 tokens): JAX compiles its
    # step once, not once per batch width
    distinct = [_collate(_examples(rng, 2), multiple=16) for _ in range(4)]
    batches = [distinct[i % 4] for i in range(STEPS * accumulate)]
    model = Llama(config, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, config))
    if kind == "dpo":
        jax_objective = JaxDPO(JaxDPOConfig(), model=jax_model)
        jax_params = {"policy": params, "ref": params}
        objective = DPO(DPOConfig(optim=OptimConfig(**OPTIM)), model=model)
    else:
        jax_objective = JaxORPO(JaxORPOConfig(), model=jax_model)
        jax_params = params
        objective = ORPO(ORPOConfig(optim=OptimConfig(**OPTIM)), model=model)
    expected = _jax_fit(jax_objective, jax_params, batches, accumulate)
    recorder = _Losses()
    trainer = Trainer(
        TrainerConfig(max_steps=STEPS, accumulate_grad_batches=accumulate, log_every_n_steps=1),
        callbacks=[recorder], device="cpu",
    )
    state = trainer.fit(objective, _Batches(batches))
    np.testing.assert_allclose(recorder.losses, expected, rtol=FIT_RTOL)
    assert recorder.losses[-1] < recorder.losses[0]
    if kind == "dpo":
        assert recorder.losses[0] == pytest.approx(np.log(2.0), rel=1e-6)
        initial = state_dict_from_jax(params, config)
        for name, p in state.model.ref.named_parameters():
            assert torch.equal(p, initial[name]), name
        assert not any(k.startswith(("optimizer.mu.ref.", "optimizer.nu.ref."))
                       for k in state.state_dict())


@pytest.mark.parametrize("kind", ["dpo", "orpo"])
def test_validate_from_checkpoint_matches_jax(tmp_path, kind):
    """A state carried from JAX weights (DPO: a perturbed policy beside the
    reference) saved by the port's checkpointer: `validate_from_checkpoint`
    and `validate` give the JAX objective's losses over the validation
    batches averaged by their target tokens, within rtol 1e-5."""
    jax_model, ref = _jax_model(seed=2)
    config = LlamaConfig(**TINY)
    if kind == "dpo":
        jax_objective = JaxDPO(JaxDPOConfig(), model=jax_model)
        params = {"policy": _perturbed(ref), "ref": ref}
        make = lambda: DPO(DPOConfig(model=ModelProvider("Llama", TINY)))  # noqa: E731
    else:
        jax_objective = JaxORPO(JaxORPOConfig(), model=jax_model)
        params = _perturbed(ref)
        make = lambda: ORPO(ORPOConfig(model=ModelProvider("Llama", TINY)))  # noqa: E731
    rng = np.random.default_rng(10)
    val = [_collate(_examples(rng, 3)) for _ in range(3)]
    losses, weights = [], []
    metrics_of = jax.jit(lambda p, b: jax_objective.loss_and_metrics(p, b, train=False)[1])
    for batch in val:
        metrics = metrics_of(params, {k: jnp.asarray(v) for k, v in batch.items()})
        losses.append(float(metrics["loss"]))
        weights.append(float(metrics["target_tokens"]))
    expected = float(np.average(losses, weights=weights))

    def trainer():
        return Trainer(TrainerConfig(max_steps=1), device="cpu", checkpointer=Checkpointer(
            CheckpointConfig(dirpath=str(tmp_path), async_save=False)))

    saver = trainer()
    state, _ = saver.init_state(make())
    state.model.load_state_dict(state_dict_from_jax(params, config))
    saver.checkpointer.save(1, state)
    saver.checkpointer.close()
    reader = trainer()
    result = reader.validate_from_checkpoint(make(), _Batches([], val))
    assert result["val_loss"] == pytest.approx(expected, rel=RTOL)
    again = Trainer(TrainerConfig(), device="cpu").validate(make(), _Batches([], val), reader.state)
    assert again["val_loss"] == pytest.approx(expected, rel=RTOL)


# ---------------------------------------------------------------- the CLI


@pytest.mark.parametrize("name", ["dpo", "orpo"])
def test_example_model_nodes_build_the_ports_objectives(name):
    """The model nodes of `config/examples/phi-3/phi-3-mini_{dpo,orpo}.yaml`
    build the port's DPO and ORPO with the example's settings; their
    `HFCausalLM` model reads the example's HF directory when the model is
    built, which is missing here and named in the error."""
    import yaml

    with open(f"config/examples/phi-3/phi-3-mini_{name}.yaml") as f:
        node = yaml.safe_load(f)["model"]
    objective = instantiate_from_config(node)
    assert isinstance(objective, {"dpo": DPO, "orpo": ORPO}[name])
    assert objective.config.beta == 0.1
    assert objective.config.model.model_class == "HFCausalLM"
    if name == "dpo":
        assert objective.config.label_smoothing == 0.0
        assert objective.config.frozen_modules == ["^ref/"]
    with pytest.raises(FileNotFoundError, match="Phi-3-mini-4k-instruct"):
        objective.configure_model(torch.device("cpu"), torch.Generator())


@pytest.mark.parametrize("command", ["generate", "evaluate", "serve"])
@pytest.mark.parametrize("kind", ["DPO", "ORPO"])
def test_inference_commands_refuse_preference_objectives(tmp_path, kind, command):
    """generate, evaluate and serve --config drive one causal LM: a DPO or
    ORPO config is refused with the JAX command's message."""
    config = {
        "trainer": {"max_steps": 1},
        "model": {"class_path": f"llm_training_tpu.lms.{kind}",
                  "init_args": {"model": {"model_class": "Llama", "model_kwargs": TINY}}},
        "data": {"class_path": "llm_training_tpu.data.DummyDataModule",
                 "init_args": {"batch_size": 2, "max_length": 16, "vocab_size": VOCAB}},
    }
    path = tmp_path / "config.json"
    path.write_text(json.dumps(config))
    extra = {"generate": ["--prompt-tokens", "1,2"], "evaluate": [], "serve": []}[command]
    with pytest.raises(SystemExit, match=f"builds {kind} — point {command} at a config whose "
                                         "model node is llm_training_tpu.lms.CLM"):
        cli_main([command, "--config", str(path), *extra, "--device", "cpu"])


def test_clm_keeps_its_numbers_through_head_and_bias():
    """The CLM loss through `head_and_bias` on a tied head equals the
    cross-entropy of the full logits."""
    model = Llama(LlamaConfig(**{**TINY, "tie_word_embeddings": True}), device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    ids = torch.randint(1, VOCAB, (2, 12), generator=torch.Generator().manual_seed(1))
    loss, _ = CLM(CLMConfig(ce_chunk_size=5), model=model).loss_and_metrics(
        {"input_ids": ids}, train=False)
    with torch.no_grad():
        logits = model(ids).logits
    full = ce.cross_entropy(logits, ce.shift_labels(ids))
    assert float(loss) == pytest.approx(float(full), rel=1e-6)
