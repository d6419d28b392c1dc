"""Port parity of the run lifecycle on the CPU: checkpoint, loss-exact
resume and the read-only restore, against the port's own uninterrupted run
and against the JAX `Trainer` + `Checkpointer` on the same config and
numpy weights (a tiny Llama, fp32, constant schedule after warmup,
accumulation 2, NEFTune on so the carried key matters).
"""

import hashlib
import json
import pickle
import shutil
import types

import flax.linen as nn
import jax
import numpy as np
import pytest
import torch

from llm_training_tpu.data import DummyDataModule as JaxDummy
from llm_training_tpu.data import DummyDataModuleConfig as JaxDummyConfig
from llm_training_tpu.lms import CLM as JaxCLM
from llm_training_tpu.lms import CLMConfig as JaxCLMConfig
from llm_training_tpu.lms import ModelProvider as JaxProvider
from llm_training_tpu.optim import OptimConfig as JaxOptimConfig
from llm_training_tpu.trainer import Trainer as JaxTrainer
from llm_training_tpu.trainer import TrainerConfig as JaxTrainerConfig
from llm_training_tpu.trainer.checkpoint import CheckpointConfig as JaxCheckpointConfig
from llm_training_tpu.trainer.checkpoint import Checkpointer as JaxCheckpointer
from llm_training_tpu_torch.data.dummy import DummyDataModule, DummyDataModuleConfig
from llm_training_tpu_torch.lms.base import ModelProvider
from llm_training_tpu_torch.lms.clm import CLM, CLMConfig
from llm_training_tpu_torch.models.llama.config import LlamaConfig
from llm_training_tpu_torch.models.llama.from_jax import (
    state_dict_from_jax,
    train_state_dict_from_jax,
)
from llm_training_tpu_torch.models.llama.model import Llama
from llm_training_tpu_torch.optim.builder import OptimConfig
from llm_training_tpu_torch.trainer.checkpoint import CheckpointConfig, Checkpointer
from llm_training_tpu_torch.trainer.trainer import Trainer, TrainerConfig

# the tiny Llama of tests/test_checkpoint_cli.py, on the plain attention path
TINY = dict(
    vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
    compute_dtype="float32", attention_impl="xla",
)
DATA = dict(batch_size=8, max_length=64, num_samples=64, vocab_size=256, validation_split=8)
OPTIM = dict(learning_rate=1e-3, warmup_steps=2, lr_scheduler="constant")
STEPS, ACCUMULATE, NEFTUNE = 6, 2, 5.0
PARITY = dict(rtol=1e-4)  # the fit parity tolerance (tests/test_torch_train.py)


class _Losses:
    def __init__(self):
        self.losses = {}

    def on_step_end(self, trainer, step, metrics):
        self.losses[step] = float(metrics["loss"])


def _data():
    return DummyDataModule(DummyDataModuleConfig(**DATA))


def _objective(params=None, model_kwargs=None):
    """The port's CLM: on the JAX weights `params` when given, else built
    from the config (random weights from the trainer's seed)."""
    kwargs = {**TINY, **(model_kwargs or {})}
    model = None
    if params is not None:
        config = LlamaConfig.from_dict(kwargs)
        model = Llama(config, device="cpu")
        model.load_state_dict(state_dict_from_jax(params, config))
    return CLM(
        CLMConfig(model=ModelProvider("Llama", kwargs), optim=OptimConfig(**OPTIM),
                  neftune_alpha=NEFTUNE),
        model=model,
    )


def _trainer(directory, max_steps=STEPS, every=None, async_save=True, max_to_keep=3,
             accumulate=ACCUMULATE, run_config=None, callbacks=()):
    checkpointer = None
    if directory is not None:
        checkpointer = Checkpointer(
            CheckpointConfig(dirpath=str(directory), async_save=async_save,
                             max_to_keep=max_to_keep), run_config=run_config,
        )
    return Trainer(
        TrainerConfig(max_steps=max_steps, log_every_n_steps=1, accumulate_grad_batches=accumulate,
                      checkpoint_every_n_steps=every),
        callbacks=list(callbacks), device="cpu", checkpointer=checkpointer,
    )


def _fit(trainer, objective, resume_step=None):
    recorder = _Losses()
    trainer.callbacks.append(recorder)
    state = trainer.fit(objective, _data(), resume_step=resume_step)
    if trainer.checkpointer is not None:
        trainer.checkpointer.close()
    return recorder.losses, state


def _tree_bytes(directory) -> dict[str, str]:
    return {str(p.relative_to(directory)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(directory.rglob("*")) if p.is_file()}


# ---------------------------------------------------------------- the JAX runs


def _jax_objective():
    return JaxCLM(JaxCLMConfig(
        model=JaxProvider(model_class="llm_training_tpu.models.Llama", model_kwargs=TINY),
        optim=JaxOptimConfig(**OPTIM), neftune_alpha=NEFTUNE,
    ))


def _jax_fit(directory, **trainer_kw):
    recorder = _Losses()
    trainer = JaxTrainer(
        JaxTrainerConfig(max_steps=STEPS, log_every_n_steps=1, accumulate_grad_batches=ACCUMULATE,
                         **trainer_kw),
        callbacks=[recorder],
        checkpointer=JaxCheckpointer(JaxCheckpointConfig(dirpath=str(directory), async_save=False,
                                                         max_to_keep=10)),
    )
    trainer.fit(_jax_objective(), JaxDummy(JaxDummyConfig(**DATA)))
    return trainer, recorder.losses


def _carried(jax_state, meta) -> dict[str, torch.Tensor]:
    """A restored JAX TrainState (clip -> adamw under MultiSteps) as the
    port's state dict."""
    opt = jax.device_get(jax_state.opt_state)
    adam = opt.inner_opt_state[1][0]  # (clip, (adam, decay, schedule))
    return train_state_dict_from_jax(
        LlamaConfig.from_dict(TINY),
        params=jax.device_get(jax_state.params), step=int(jax_state.step),
        rng=jax.device_get(jax.random.key_data(jax_state.rng)), count=int(adam.count), mu=adam.mu, nu=adam.nu,
        acc_grads=opt.acc_grads, mini_step=int(opt.mini_step),
    )


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory, devices):
    """Two JAX fits: uninterrupted to step 6 (checkpoints at 3 and 6), and a
    resume from its step 3 in a copy of the directory. Also the JAX initial
    weights (the trainer's `init_params` under `key(seed)`) and the JAX
    states of steps 3 and 6."""
    root = tmp_path_factory.mktemp("jax")
    full, full_losses = _jax_fit(root / "full", checkpoint_every_n_steps=3)
    shutil.copytree(root / "full", root / "resume")
    shutil.rmtree(root / "resume" / "6")
    _, resumed_losses = _jax_fit(root / "resume")
    states = {
        step: full.checkpointer.maybe_restore(full.abstract_state, full.state_shardings, step=step,
                                              repair=False)
        for step in (3, 6)
    }
    data = JaxDummy(JaxDummyConfig(**DATA))
    data.setup()
    batch = next(data.train_batches())
    init = nn.meta.unbox(
        _jax_objective().init_params(jax.random.key(JaxTrainerConfig().seed), batch))
    return dict(full=full_losses, resumed=resumed_losses, states=states, dir=root / "full",
                init=jax.device_get(init))


# ---------------------------------------------------------------- (a) bit-exact resume


@pytest.fixture
def deterministic():
    """torch's deterministic kernels: without them two uninterrupted CPU runs
    already differ in the last bits of the AdamW moments (threaded
    accumulation in the backward), so no resume could equal one."""
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before)


@pytest.mark.parametrize("async_save", [True, False], ids=["async", "sync"])
def test_resume_is_bit_exact(tmp_path, async_save, deterministic):
    """3 steps, a checkpoint, then a fresh Trainer resumes to step 6: its
    losses, parameters, optimizer state, counters and data cursor equal the
    uninterrupted 6-step run's bit for bit (accumulation 2, NEFTune on)."""
    full, full_state = _fit(_trainer(None), _objective())
    first, _ = _fit(_trainer(tmp_path, max_steps=3, async_save=async_save), _objective())
    trainer = _trainer(tmp_path, async_save=async_save)
    resumed, state = _fit(trainer, _objective())
    assert sorted(resumed) == [4, 5, 6]
    assert {**first, **resumed} == full
    full_tensors, tensors = full_state.state_dict(), state.state_dict()
    assert full_tensors.keys() == tensors.keys()
    for name in full_tensors:
        assert torch.equal(full_tensors[name], tensors[name]), name
    assert state.rng == full_state.rng and state.step == STEPS * ACCUMULATE
    meta = trainer.checkpointer.read_meta(3)
    assert meta["data_state"] == {"global_batch_size": 8, "sample_cursor": 3 * ACCUMULATE * 8,
                                  "replica_stride": 8}
    samples = STEPS * ACCUMULATE * 8
    assert trainer.counters == {"consumed_samples": samples, "consumed_tokens": samples * 64}


# ---------------------------------------------------------------- (b) against JAX


def test_resumed_losses_match_jax(tmp_path, jax_runs):
    """From the JAX initial weights: the port's checkpoint at step 3 and
    resume to 6 follow the JAX Trainer + Checkpointer's resumed losses
    within rtol 1e-4, and both follow the uninterrupted JAX run."""
    first, _ = _fit(_trainer(tmp_path, max_steps=3), _objective(jax_runs["init"]))
    resumed, _ = _fit(_trainer(tmp_path), _objective(jax_runs["init"]))
    assert abs(first[1] - jax_runs["full"][1]) < 1e-5
    steps = [4, 5, 6]
    np.testing.assert_allclose([resumed[s] for s in steps], [jax_runs["resumed"][s] for s in steps],
                               **PARITY)
    np.testing.assert_allclose([jax_runs["resumed"][s] for s in steps],
                               [jax_runs["full"][s] for s in steps], rtol=1e-6)


def test_jax_state_carried_across_resumes_in_port(tmp_path, jax_runs):
    """JAX fits 3 steps; its TrainState (params, adam moments and count,
    MultiSteps' accumulator, the key, the step) becomes a port checkpoint;
    the port's steps 4-6 from it follow JAX's uninterrupted steps 4-6."""
    jax_state, meta = jax_runs["states"][3]
    trainer = _trainer(tmp_path)
    objective = _objective()
    state, _ = trainer.init_state(objective)
    state.load_state_dict(_carried(jax_state, meta))
    assert state.step == 3 * ACCUMULATE and state.optimizer.count == 3
    trainer.checkpointer.save(3, state, counters=meta["counters"])
    trainer.checkpointer.wait()
    resumed, _ = _fit(_trainer(tmp_path), _objective())
    np.testing.assert_allclose([resumed[s] for s in (4, 5, 6)],
                               [jax_runs["full"][s] for s in (4, 5, 6)], **PARITY)


def test_validate_from_checkpoint_matches_jax(tmp_path, jax_runs):
    """JAX's step-6 state carried into a port checkpoint: the port's
    `validate_from_checkpoint` gives JAX's `val_loss` within 1e-5."""
    jax_state, meta = jax_runs["states"][6]
    trainer = _trainer(tmp_path)
    state, _ = trainer.init_state(_objective())
    state.load_state_dict(_carried(jax_state, meta))
    trainer.checkpointer.save(6, state, counters=meta["counters"])
    trainer.checkpointer.wait()
    expected = JaxTrainer(
        JaxTrainerConfig(max_steps=STEPS, accumulate_grad_batches=ACCUMULATE),
        checkpointer=JaxCheckpointer(JaxCheckpointConfig(dirpath=str(jax_runs["dir"]),
                                                         async_save=False, max_to_keep=10)),
    ).validate_from_checkpoint(_jax_objective(), JaxDummy(JaxDummyConfig(**DATA)))
    result = _trainer(tmp_path).validate_from_checkpoint(_objective(), _data())
    assert abs(result["val_loss"] - expected["val_loss"]) < 1e-5


# ---------------------------------------------------------------- (c) the directory


def test_meta_embeds_config_counters_and_cursor(tmp_path):
    run_config = {"model": {"class_path": "llm_training_tpu.lms.CLM"}, "note": "hi"}
    trainer = _trainer(tmp_path, max_steps=2, every=2, run_config=run_config)
    _fit(trainer, _objective())
    assert trainer.checkpointer.all_steps() == [2]
    meta = json.loads((tmp_path / "step_2" / "meta.json").read_text())
    assert meta["config"] == run_config and meta["step"] == 2
    assert meta["counters"] == {"consumed_samples": 2 * ACCUMULATE * 8,
                                "consumed_tokens": 2 * ACCUMULATE * 8 * 64}
    assert meta["data_state"]["sample_cursor"] == 2 * ACCUMULATE * 8
    assert meta["run_metadata"]["torch_version"] == torch.__version__
    assert meta["optimizer"]["kind"] == "adamw" and meta["optimizer"]["accumulate"] == ACCUMULATE
    assert trainer.checkpointer.read_meta() == meta


def test_max_to_keep_prunes_oldest(tmp_path):
    trainer = _trainer(tmp_path, every=1, max_to_keep=2)
    _fit(trainer, _objective())
    assert trainer.checkpointer.all_steps() == [5, 6]
    assert trainer.checkpointer.last_save["pruned"] == [4]
    # the pruned steps' manifests go with them
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "manifest-5.json", "manifest-6.json", "step_5", "step_6"]


def test_restore_for_inference_is_read_only(tmp_path):
    """The read-only restore changes no byte of the directory (nor adds or
    removes a file), and raises on a directory without a step."""
    with pytest.raises(ValueError, match="no checkpoint found"):
        _trainer(tmp_path / "empty").restore_for_inference(_objective())
    assert not (tmp_path / "empty").exists()
    _, trained = _fit(_trainer(tmp_path, max_steps=3, every=1, max_to_keep=1), _objective())
    before = _tree_bytes(tmp_path)
    state = _trainer(tmp_path).restore_for_inference(_objective())
    assert _tree_bytes(tmp_path) == before
    assert state.optimizer is None and state.step == 3 * ACCUMULATE
    for name, tensor in trained.model.state_dict().items():
        assert torch.equal(state.model.state_dict()[name], tensor), name


def test_save_of_existing_step_is_a_noop_unless_forced(tmp_path):
    trainer = _trainer(tmp_path, max_steps=2, every=2)
    _, state = _fit(trainer, _objective())
    checkpointer = trainer.checkpointer
    before = _tree_bytes(tmp_path)
    with torch.no_grad():
        state.model.model.norm.weight.add_(1.0)
    checkpointer.save(2, state)
    checkpointer.wait()
    assert _tree_bytes(tmp_path) == before
    checkpointer.save(2, state, force=True)
    checkpointer.wait()
    assert _tree_bytes(tmp_path) != before
    restored = _trainer(tmp_path).restore_for_inference(_objective())
    assert torch.equal(restored.model.model.norm.weight, state.model.model.norm.weight)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["manifest-2.json", "step_2"]


# ---------------------------------------------------------------- no fallback


def test_resume_with_another_optimizer_layout_raises(tmp_path):
    _fit(_trainer(tmp_path, max_steps=2), _objective())
    with pytest.raises(RuntimeError, match="optimizer-state layout depends on") as info:
        _fit(_trainer(tmp_path, accumulate=1), _objective())
    assert "accumulate" in str(info.value.__cause__)


def test_save_on_exit_false_is_accepted_and_unused(tmp_path, devices):
    """R3: a `trainer.checkpoint` node with `save_on_exit: false` builds in
    both packages, and both fits still leave their last step (JAX never
    reads the key)."""
    node = {"dirpath": str(tmp_path / "port"), "async_save": False, "save_on_exit": False}
    _fit(Trainer(TrainerConfig(max_steps=2, log_every_n_steps=1), device="cpu",
                 checkpointer=Checkpointer(CheckpointConfig.from_node(node))), _objective())
    jax_node = {**node, "dirpath": str(tmp_path / "jax")}
    jax_trainer = JaxTrainer(JaxTrainerConfig(max_steps=2, log_every_n_steps=1),
                             checkpointer=JaxCheckpointer(JaxCheckpointConfig(**jax_node)))
    jax_trainer.fit(_jax_objective(), JaxDummy(JaxDummyConfig(**DATA)))
    jax_trainer.checkpointer.close()
    assert Checkpointer(CheckpointConfig(dirpath=node["dirpath"])).all_steps() == [2]
    assert jax_trainer.checkpointer.manager.all_steps() == [2]


def test_durability_keys_raise():
    """The durability keys build now, with JAX's defaults
    (`tests/test_torch_durability.py` holds every key to JAX's); unknown
    keys and a verify mode JAX refuses still raise, and `save_on_exit:
    false` is accepted and unused, as JAX's is."""
    config = CheckpointConfig.from_node({"dirpath": "x", "verify": "full"})
    assert (config.verify, config.save_retries, config.mirror_dir) == ("full", 3, None)
    with pytest.raises(ValueError, match="unknown field"):
        CheckpointConfig.from_node({"dirpath": "x", "keep": 1})
    with pytest.raises(ValueError, match="verify"):
        CheckpointConfig.from_node({"dirpath": "x", "verify": "slow"})
    assert CheckpointConfig(dirpath="x", save_on_exit=False).save_on_exit is False


def test_async_save_failure_surfaces(tmp_path):
    """A background write that fails is raised by wait() and, if nobody
    waited, by the next save."""
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    trainer = _trainer(blocker / "ckpt")
    state, _ = trainer.init_state(_objective())
    trainer.checkpointer.save(1, state)
    with pytest.raises(RuntimeError, match="async checkpoint save"):
        trainer.checkpointer.wait()
    trainer.checkpointer.save(2, state)
    trainer.checkpointer._thread.join()
    with pytest.raises(RuntimeError, match="async checkpoint save"):
        trainer.checkpointer.save(3, state)


def test_checkpoint_index_refuses_code(tmp_path):
    """DCP's pickled index is read by an unpickler that admits DCP's own
    metadata classes only: an index naming any other callable raises. The
    step's manifest catches the rewritten index first; without a manifest
    (a legacy step) the unpickler refuses it."""
    _fit(_trainer(tmp_path, max_steps=1), _objective())

    class Payload:
        def __reduce__(self):
            return (print, ("unpickled code ran",))

    (tmp_path / "step_1" / ".metadata").write_bytes(pickle.dumps(Payload()))
    with pytest.raises(RuntimeError, match="failed to restore"):
        _trainer(tmp_path).restore_for_inference(_objective())
    (tmp_path / "manifest-1.json").unlink()
    with pytest.raises((RuntimeError, pickle.UnpicklingError), match="never holds"):
        _trainer(tmp_path).restore_for_inference(_objective())


# ---------------------------------------------------------------- DPO


class _Pairs:
    """Seeded preference batches (2 pairs, collated by the port's
    collator), batch n drawn from seed n: a pure function of the
    micro-step, as a resumable stream must be."""

    def setup(self):
        pass

    def train_batches(self, start_step=0):
        from llm_training_tpu_torch.data.preference_tuning.collator import (
            PreferenceTuningDataCollator,
        )

        config = types.SimpleNamespace(tokenizer=types.SimpleNamespace(pad_token_id=0),
                                       pad_to_multiple_of=8)
        collate = PreferenceTuningDataCollator(config)
        for step in range(start_step, 10**6):
            rng = np.random.default_rng(step % 4)
            examples = []
            for _ in range(2):
                prompt = rng.integers(1, 256, 5).tolist()
                example = {}
                for side in ("chosen", "rejected"):
                    ids = prompt + rng.integers(1, 256, int(rng.integers(2, 8))).tolist()
                    example.update({f"{side}_input_ids": ids, f"{side}_length": len(ids),
                                    f"{side}_labels": [-100] * 5 + ids[5:]})
                examples.append(example)
            yield collate(examples)


def _dpo():
    from llm_training_tpu_torch.lms import DPO, DPOConfig

    return DPO(DPOConfig(model=ModelProvider("Llama", TINY), optim=OptimConfig(**OPTIM)))


def test_dpo_resume_is_bit_exact(tmp_path, deterministic):
    """DPO with accumulation 2: 3 steps, a checkpoint, then a fresh Trainer
    resumes to step 6. Losses and every tensor equal the uninterrupted
    run's bit for bit; the reference equals its initial weights (the
    policy's); the state holds no moments for the reference and a zero
    accumulator for it."""
    def fit(trainer):
        recorder = _Losses()
        trainer.callbacks.append(recorder)
        state = trainer.fit(_dpo(), _Pairs())
        if trainer.checkpointer is not None:
            trainer.checkpointer.close()
        return recorder.losses, state

    full, full_state = fit(_trainer(None))
    first, _ = fit(_trainer(tmp_path, max_steps=3))
    resumed, state = fit(_trainer(tmp_path))
    assert sorted(resumed) == [4, 5, 6]
    assert {**first, **resumed} == full
    assert abs(full[1] - np.log(2.0)) < 1e-6
    full_tensors, tensors = full_state.state_dict(), state.state_dict()
    assert full_tensors.keys() == tensors.keys()
    for name in full_tensors:
        assert torch.equal(full_tensors[name], tensors[name]), name
    assert not [k for k in tensors if k.startswith(("optimizer.mu.ref.", "optimizer.nu.ref."))]
    assert [k for k in tensors if k.startswith("optimizer.mu.")] == [
        f"optimizer.mu.{n}" for n, _ in state.model.policy.named_parameters(prefix="policy")]
    initial, _ = _trainer(None).init_state(_dpo())
    for name, p in state.model.ref.named_parameters(prefix="ref"):
        assert torch.equal(p, initial.model.get_parameter(name)), name
        assert not tensors[f"optimizer.acc.{name}"].any(), name


def test_jax_dpo_state_carried_into_port(devices):
    """A JAX DPO state (`{policy, ref}` parameters; AdamW moments masked for
    the reference by `^ref/`; MultiSteps' accumulator over both) becomes
    the port's DPO TrainState: its per-parameter tensors, counted as
    tensors and as elements, are the optax leaves; the keys are exactly the
    port's; the values carry across."""
    import optax

    from llm_training_tpu.lms import DPO as JaxDPO
    from llm_training_tpu.lms import DPOConfig as JaxDPOConfig
    from llm_training_tpu.optim.builder import build_optimizer as jax_optimizer

    # the looped layout: one leaf per parameter, as the port has
    jax_objective = JaxDPO(JaxDPOConfig(model=JaxProvider(
        model_class="llm_training_tpu.models.Llama", model_kwargs={**TINY, "scan_layers": False})))
    batch = next(_Pairs().train_batches())
    params = jax.device_get(nn.meta.unbox(jax_objective.init_params(jax.random.key(0), batch)))
    tx = optax.MultiSteps(jax_optimizer(JaxOptimConfig(**OPTIM), STEPS,
                                        jax_objective.config.frozen_modules)[0], ACCUMULATE)
    opt_state = tx.init(params)
    grads = jax.tree.map(lambda x: np.full(x.shape, 1e-3, x.dtype), params)
    _, opt_state = tx.update(grads, opt_state, params)
    adam = next(x for x in jax.tree.leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(x, optax.ScaleByAdamState))
    opt_state = jax.device_get(opt_state)
    carried = train_state_dict_from_jax(
        LlamaConfig.from_dict(TINY), params=params, step=1, rng=np.asarray([0, 1], np.uint32),
        count=int(adam.count), mu=jax.device_get(adam.mu), nu=jax.device_get(adam.nu),
        acc_grads=opt_state.acc_grads, mini_step=int(opt_state.mini_step))
    state, _ = _trainer(None).init_state(_dpo())
    port = state.state_dict()
    assert set(carried) == set(port)
    leaves = [np.asarray(x) for x in jax.tree.leaves(opt_state) if np.ndim(x) > 0]
    ours = [t for k, t in port.items() if k.startswith("optimizer.") and t.ndim > 0]
    assert len(ours) == len(leaves)
    assert sum(t.numel() for t in ours) == sum(x.size for x in leaves)
    state.load_state_dict(carried)
    for name, tensor in state.state_dict().items():
        assert torch.equal(tensor, carried[name]), name
