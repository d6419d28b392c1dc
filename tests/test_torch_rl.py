"""Port parity of GRPO and `rl-fit` on the CPU: `fused_linear_token_log_probs`,
group-relative advantages, the GRPO objective (loss, metrics, gradients),
the verifiable rewards, the rollout collector over the serving engine
(behavior logprobs against a teacher-forced forward, stale samples
dropped, the weight sync's stream equivalence), a JAX GRPO train state
carried into the port, and `rl-fit` over the smoke config in both
packages (the same rollout tokens and rewards, losses and final
parameters within rtol 1e-4), with its SIGTERM drill: exit 75, then a
relaunch that adopts the journaled rollouts.
"""

import copy
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from llm_training_tpu.lms.grpo import GRPO as JaxGRPO
from llm_training_tpu.lms.grpo import GRPOConfig as JaxGRPOConfig
from llm_training_tpu.lms.grpo import group_relative_advantages as jax_advantages
from llm_training_tpu.models import Llama as JaxLlama
from llm_training_tpu.models import LlamaConfig as JaxLlamaConfig
from llm_training_tpu.optim.builder import OptimConfig as JaxOptimConfig
from llm_training_tpu.optim.builder import build_optimizer as jax_optimizer
from llm_training_tpu.rl import reward as jax_reward
from llm_training_tpu_torch.cli import main as cli
from llm_training_tpu_torch.infer.sampling import SamplingConfig
from llm_training_tpu_torch.lms import GRPO, GRPOConfig
from llm_training_tpu_torch.lms.base import ModelProvider
from llm_training_tpu_torch.lms.grpo import group_relative_advantages
from llm_training_tpu_torch.models.llama.config import LlamaConfig
from llm_training_tpu_torch.models.llama.from_jax import (
    state_dict_from_jax,
    train_state_dict_from_jax,
    tree_from_flat,
)
from llm_training_tpu_torch.models.llama.model import Llama
from llm_training_tpu_torch.rl import RolloutCollector, resolve_reward, sync_weights
from llm_training_tpu_torch.rl import reward as port_reward
from llm_training_tpu_torch.rl import rollout as port_rollout
from llm_training_tpu_torch.serve.engine import ServeConfig, ServingEngine
from llm_training_tpu_torch.trainer.trainer import Trainer, TrainerConfig

jax_ce = importlib.import_module("llm_training_tpu.ops.cross_entropy")
port_ce = importlib.import_module("llm_training_tpu_torch.ops.cross_entropy")
ROOT = Path(__file__).resolve().parent.parent
VOCAB = 64
TINY = dict(
    vocab_size=VOCAB, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, head_dim=8, max_position_embeddings=64,
    rms_norm_eps=1e-5, rope_theta=10000.0, compute_dtype="float32", param_dtype="float32",
)
RTOL = 1e-5  # fp32: summation order only
GRAD_TOL = 1e-4  # of the tensor's max |g|: a backward through two layers
FIT_RTOL = 1e-4
SMOKE_CONFIG = "config/examples/smoke/rl-smoke.yaml"
PORT_SMOKE_CONFIG = "llm_training_tpu_torch/config/rl-smoke.json"
# scripts/rl_smoke.py's recipe, cut to 3 rounds
SMOKE_FLAGS = [
    "--prompts-per-round", "8", "--prompt-len", "4", "--max-new-tokens", "8",
    "--updates-per-round", "2", "--prompt-style", "repeat", "--reward", "copy_digit",
    "--temperature", "1.0", "--eos-token-id", "-1", "--max-batch", "4",
    "--max-model-len", "64", "--prefill-chunk", "8", "--rounds", "3",
]


def _t(x):
    return torch.from_numpy(np.array(x))


def _max_rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _jax_params(seed=0):
    model = JaxLlama(JaxLlamaConfig(**TINY, scan_layers=True, attention_impl="xla"))
    variables = model.init(jax.random.key(seed), np.zeros((1, 4), np.int32))
    return model, jax.device_get(nn.meta.unbox(variables))


def _port_model(variables) -> Llama:
    model = Llama(LlamaConfig(**TINY), device="cpu")
    model.load_state_dict(state_dict_from_jax(variables, LlamaConfig(**TINY)))
    return model.eval()


# ---------------------------------------------------------------- token log-probs


@pytest.mark.parametrize("case", ["plain", "ignore", "soft_cap", "bias"])
def test_fused_linear_token_log_probs_matches_jax(case):
    """Per-token log-probs, the validity mask and the gradients of a
    weighted sum against JAX's on the same inputs (fp32, 1e-5), with a
    chunk (4) that does not divide the sequence (10)."""
    rng = np.random.default_rng(3)
    hidden = rng.standard_normal((3, 10, 16)).astype(np.float32)
    weight = (0.3 * rng.standard_normal((16, 40))).astype(np.float32)
    labels = rng.integers(0, 40, (3, 10)).astype(np.int64)
    if case == "ignore":
        labels[0, :4] = -100
        labels[2, 7:] = -100
    bias = (0.5 * rng.standard_normal(40)).astype(np.float32) if case == "bias" else None
    cap = 2.0 if case == "soft_cap" else None
    mix = rng.standard_normal((3, 10)).astype(np.float32)

    def jax_fn(h, w):
        logps, valid = jax_ce.fused_linear_token_log_probs(
            h, w, jnp.asarray(labels), chunk_size=4, logits_soft_cap=cap,
            bias=None if bias is None else jnp.asarray(bias))
        return (logps * mix).sum(), (logps, valid)

    (_, (jlogps, jvalid)), (jdh, jdw) = jax.value_and_grad(jax_fn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(hidden), jnp.asarray(weight))
    h, w = _t(hidden).requires_grad_(), _t(weight).requires_grad_()
    logps, valid = port_ce.fused_linear_token_log_probs(
        h, w, _t(labels), chunk_size=4, logits_soft_cap=cap,
        bias=None if bias is None else _t(bias))
    (logps * _t(mix)).sum().backward()
    assert logps.shape == (3, 10) and logps.dtype == torch.float32
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_allclose(logps.detach().numpy(), np.asarray(jlogps), rtol=RTOL, atol=1e-6)
    assert not logps.detach()[~valid].any()
    assert _max_rel(h.grad.numpy(), jdh) <= RTOL and _max_rel(w.grad.numpy(), jdw) <= RTOL


def test_group_relative_advantages_match_jax():
    """Groups of 3, 2 (equal rewards), 1, and padding singletons: JAX's
    advantages; a singleton or zero-variance group gets exactly 0."""
    rewards = np.array([0.1, 0.7, 0.4, 0.5, 0.5, 0.9, 0.0, 0.0], np.float32)
    groups = np.array([0, 0, 0, 1, 1, 2, 3, 4], np.int32)
    got = group_relative_advantages(_t(rewards), _t(groups)).numpy()
    want = np.asarray(jax_advantages(jnp.asarray(rewards), jnp.asarray(groups)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)
    assert not got[3:].any() and got[:3].any()


# ---------------------------------------------------------------- the objective


def _grpo_batch(rng, rows=6, seq=12):
    """Prompt + completion rows, right-padded: groups of 3, 2 (equal
    rewards) and a padding row with no completion tokens."""
    input_ids = rng.integers(1, VOCAB, (rows, seq)).astype(np.int32)
    segment_ids = np.zeros((rows, seq), np.int32)
    completion = np.zeros((rows, seq), np.int32)
    behavior = np.zeros((rows, seq), np.float32)
    for row in range(rows - 1):
        length, prompt = int(rng.integers(7, seq + 1)), int(rng.integers(2, 5))
        segment_ids[row, :length] = 1
        completion[row, prompt:length] = 1
        behavior[row, prompt:length] = rng.uniform(-5.5, -3.0, length - prompt)
    return {"input_ids": input_ids, "segment_ids": segment_ids, "completion_mask": completion,
            "behavior_logprobs": behavior,
            "rewards": np.array([0.2, 0.9, 0.4, 0.5, 0.5, 0.0], np.float32),
            "group_ids": np.array([0, 0, 0, 1, 1, 2], np.int32)}


def test_grpo_matches_jax():
    """GRPO's loss and its seven metrics within rtol 1e-5 of JAX's on a
    perturbed policy (ratios inside and outside the clip), the policy's
    gradients within 1e-4 of max|g|; the reference gets none."""
    jax_model, ref = _jax_params()
    policy = jax.tree.map(lambda x: x + 0.05 * np.random.default_rng(1).standard_normal(
        x.shape).astype(x.dtype), ref)
    params = {"policy": policy, "ref": ref}
    objective = GRPO(GRPOConfig(model=ModelProvider("Llama", TINY)))
    pair = objective.configure_model(torch.device("cpu"), torch.Generator().manual_seed(0))
    pair.load_state_dict(state_dict_from_jax(params, LlamaConfig(**TINY)))
    batch = _grpo_batch(np.random.default_rng(5))
    jax_objective = JaxGRPO(JaxGRPOConfig(), model=jax_model)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_objective.loss_and_metrics(p, jbatch), has_aux=True))(params)
    loss, metrics = objective.loss_and_metrics({k: _t(v) for k, v in batch.items()})
    loss.backward()
    assert metrics.keys() == jmetrics.keys() and len(metrics) == 7
    assert 0 < float(jmetrics["ratio_clip_frac"]) < 1
    for key, value in jmetrics.items():
        np.testing.assert_allclose(float(metrics[key]), float(value), rtol=RTOL, atol=1e-6,
                                   err_msg=key)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=RTOL)
    expected = state_dict_from_jax(jgrads, LlamaConfig(**TINY))
    for name, p in pair.named_parameters():
        if name.startswith("ref."):
            assert p.grad is None and not p.requires_grad and not expected[name].any(), name
        else:
            assert _max_rel(p.grad.numpy(), expected[name].numpy()) <= GRAD_TOL, name


def test_grpo_state_from_jax_freezes_exactly_the_reference():
    """A JAX GRPO train state (`policy/`, `ref/`, AdamW's moments masked by
    `^ref/`) carries into the port's state: the same keys, the moments for
    the policy only (optax's unmasked leaves, as tensors and elements), the
    reference frozen and a bit-equal copy of the policy at init."""
    jax_model, init = _jax_params()
    params = {"policy": init, "ref": init}
    objective = GRPO(GRPOConfig(model=ModelProvider("Llama", TINY)))
    assert objective.config.frozen_modules == ["^ref/"]
    tx, _ = jax_optimizer(JaxOptimConfig(learning_rate=1e-2), 10, objective.config.frozen_modules)
    opt_state = jax.jit(tx.init)(params)

    @jax.jit
    def update(params, opt_state):
        grads = jax.tree.map(jnp.ones_like, params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    params, opt_state = jax.device_get(update(params, opt_state))
    adam = next(x for x in jax.tree.leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(x, optax.ScaleByAdamState))
    adam = jax.device_get(adam)
    carried = train_state_dict_from_jax(
        LlamaConfig(**TINY), params=params, step=1, rng=np.asarray([0, 43], np.uint32),
        count=int(adam.count), mu=adam.mu, nu=adam.nu)
    trainer = Trainer(TrainerConfig(max_steps=10), device="cpu")
    state, _ = trainer.init_state(objective)
    pair = state.model
    assert all(torch.equal(p, q) for p, q in zip(pair.policy.parameters(), pair.ref.parameters()))
    frozen = {n for n, t in zip(state.optimizer.names, state.optimizer.trainable) if not t}
    assert frozen == {n for n, _ in pair.named_parameters() if n.startswith("ref.")}
    assert set(carried) == set(state.state_dict())
    state.load_state_dict(carried)
    moments = [np.asarray(x) for x in jax.tree.leaves((adam.mu, adam.nu))]
    ours = {k: t for k, t in state.optimizer.state_dict().items() if k.startswith(("mu.", "nu."))}
    # the scanned JAX tree stacks the layers: count elements, not tensors
    assert ours and not [k for k in ours if ".ref." in k]
    assert sum(t.numel() for t in ours.values()) == sum(x.size for x in moments)
    for name, tensor in state.state_dict().items():
        assert torch.equal(tensor, carried[name]), name


# ---------------------------------------------------------------- rewards


@pytest.mark.parametrize("name,kwargs", [
    ("copy_digit", {}), ("regex", {"pattern": r"\b7\b"}), ("numeric_answer", {"answer": "42"}),
    ("length", {"target_len": 3}),
], ids=["copy_digit", "regex", "numeric_answer", "length"])
def test_rewards_match_jax(name, kwargs):
    """Each built-in over a grid of prompts and completions: JAX's value."""
    ours, theirs = resolve_reward(name, **kwargs), jax_reward.resolve_reward(name, **kwargs)
    prompts = [[], [7], [3, 7], [42, 5]]
    completions = [[], [7], [7, 7, 3], [4, 2], [42], [1, 7, 9, 7, 7]]
    for prompt in prompts:
        for completion in completions:
            assert ours(prompt, completion) == theirs(prompt, completion), (prompt, completion)


def test_reward_env_selection_matches_jax(monkeypatch):
    """`LLMT_RL_REWARD` and the built-ins' environment fallbacks select as
    in JAX; a missing setting and an unknown name raise in both."""
    monkeypatch.setenv("LLMT_RL_REWARD", "length")
    monkeypatch.setenv("LLMT_RL_REWARD_TARGET_LEN", "4")
    assert resolve_reward()([1], [1, 2]) == jax_reward.resolve_reward()([1], [1, 2]) == 0.5
    monkeypatch.delenv("LLMT_RL_REWARD_TARGET_LEN")
    for module in (port_reward, jax_reward):
        with pytest.raises(ValueError, match="length reward needs a target"):
            module.resolve_reward()
        with pytest.raises(ValueError, match="regex reward needs a pattern"):
            module.resolve_reward("regex")
        with pytest.raises(ValueError, match="unknown reward"):
            module.resolve_reward("nope")
    monkeypatch.delenv("LLMT_RL_REWARD")
    assert resolve_reward()([5], [5, 1]) == 0.5


# ---------------------------------------------------------------- collector and sync


def _engine(model, **overrides) -> ServingEngine:
    config = ServeConfig(**{"max_batch": 2, "max_model_len": 48, "block_size": 8,
                            "prefill_chunk": 4, "eos_token_id": None, **overrides})
    return ServingEngine(model, config, device="cpu")


def test_decode_logprobs_match_teacher_forced_forward():
    """The behavior logprobs the engine collects through the paged cache
    equal a teacher-forced full forward over the finished sequence (GRPO's
    ratio denominator), at temperature 1."""
    model = _port_model(_jax_params()[1])
    engine = _engine(model, sampling=SamplingConfig(temperature=1.0), seed=11)
    collector = RolloutCollector(engine, group_size=2, max_new_tokens=8)
    rollouts = collector.collect(0, [[3, 17, 42, 7], [5, 9]])
    assert len(rollouts) == 4 and collector.stats()["rl/rollouts_stale_dropped"] == 0
    for rollout in rollouts:
        seq = torch.tensor([rollout.prompt + rollout.tokens])
        with torch.no_grad():
            logps = torch.log_softmax(model(seq).logits[0].float(), -1)
        reference = [float(logps[len(rollout.prompt) + j - 1, t])
                     for j, t in enumerate(rollout.tokens)]
        np.testing.assert_allclose(rollout.logprobs, reference, rtol=1e-4, atol=1e-5)


def test_stale_generation_rollouts_dropped():
    """A weight reload in the middle of a collection makes every rollout in
    flight span two generations: all of them are dropped at harvest."""
    model = _port_model(_jax_params()[1])
    engine = _engine(model)
    collector = RolloutCollector(engine, group_size=2, max_new_tokens=8)
    steps = [0]

    def reload_mid_collection():
        steps[0] += 1
        if steps[0] == 3:  # the same tensors, a new generation
            engine.reload_weights(model.state_dict(keep_vars=True))
        return False

    rollouts = collector.collect(0, [[3, 17, 42], [5, 9]], should_stop=reload_mid_collection)
    stats = collector.stats()
    assert stats["rl/rollouts_stale_dropped"] >= 1
    assert all(r.generation == engine.weights_generation == 1 for r in rollouts)
    assert stats["rl/rollouts_collected"] + stats["rl/rollouts_stale_dropped"] == 4.0


def test_weight_sync_stream_equivalence_fused_vs_host_vs_fresh():
    """A greedy request in flight across a sync continues with the same
    tokens under `fused` and `host` sync and on a fresh engine over the
    synced weights fed prompt + the tokens so far. `fused` binds the given
    tensors (an engine over the policy itself copies nothing); `host` fills
    the engine's own tensors through the host."""
    w0, w1 = _jax_params(0)[1], _jax_params(1)[1]
    target = _port_model(w1)
    prompt, total = [3, 17, 42, 7], 10

    def run_with_sync(mode):
        engine = _engine(_port_model(w0), max_batch=1)
        own = engine.model.state_dict(keep_vars=True)
        before = [e["token"] for e in engine.submit(id="r", prompt=prompt, max_new_tokens=total)
                  if e["type"] == "token"]
        while len(before) < 4:
            before += [e["token"] for e in engine.step() if e["type"] == "token"]
        summary = sync_weights(engine, target.state_dict(keep_vars=True), mode=mode)
        assert summary["generation"] == engine.weights_generation == 1
        held = engine.model.state_dict(keep_vars=True)
        for name, tensor in target.state_dict(keep_vars=True).items():
            assert (held[name] is tensor) == (mode == "fused"), name
            assert (held[name] is own[name]) == (mode == "host"), name
            assert torch.equal(held[name], tensor), name
        done = None
        while done is None:
            for event in engine.step():
                assert event["generation"] == 1
                if event["type"] == "done":
                    done = event
        assert done["evictions"] == 1
        return len(before), done["tokens"]

    k, fused = run_with_sync("fused")
    assert (k, fused) == run_with_sync("host")
    fresh = _engine(copy.deepcopy(target), max_batch=1)
    events = list(fresh.submit(id="f", prompt=prompt + fused[:k], max_new_tokens=total - k))
    done = None
    while done is None:
        done = next((e for e in fresh.step() if e["type"] == "done"), None)
    assert fused[k:] == done["tokens"]


def test_reload_weights_validates_before_evicting():
    """A reload of other names, shapes or dtypes raises and changes
    nothing: no eviction, no generation bump."""
    model = _port_model(_jax_params()[1])
    engine = _engine(model)
    engine.submit(id="a", prompt=[1, 2, 3], max_new_tokens=6)
    engine.step()
    weights = dict(model.state_dict(keep_vars=True))
    bad = {**weights, "lm_head.weight": torch.zeros(3, 3)}
    for broken, match in ((bad, "shape/dtype/device mismatch"),
                          ({k: v for k, v in weights.items() if k != "model.norm.weight"},
                           "names mismatch"),
                          ({**weights, "model.norm.weight": weights["model.norm.weight"].double()},
                           "mismatch")):
        with pytest.raises(ValueError, match=match):
            engine.reload_weights(broken)
    assert engine.weights_generation == 0 and engine.scheduler.evictions == 0
    assert len(engine.scheduler.running) == 1


# ---------------------------------------------------------------- rl-fit in both packages

# runs the JAX `rl-fit` and dumps its initial and final parameters and each
# round's harvested rollouts into argv[1]
_JAX_RL_FIT = r"""
import json, sys
import numpy as np, jax
from llm_training_tpu.cli.main import main
from llm_training_tpu.rl import loop, rollout
out = sys.argv[1]
setup, run, harvest = loop.RLLoop.setup, loop.RLLoop.run, rollout.RolloutCollector._harvest

def dump(name, tree):
    leaves = jax.tree_util.tree_flatten_with_path(jax.device_get(tree))[0]
    np.savez(f"{out}/{name}.npz", **{"/".join(str(getattr(k, "key", k)) for k in path):
                                     np.asarray(v) for path, v in leaves})

def setup_(self):
    setup(self)
    dump("init", self.state.params)

def run_(self, *args, **kwargs):
    result = run(self, *args, **kwargs)
    dump("final", self.state.params)
    return result

def harvest_(self, round_idx):
    rollouts = harvest(self, round_idx)
    with open(f"{out}/rollouts.jsonl", "a") as f:
        for r in rollouts:
            f.write(json.dumps({"id": r.id, "prompt": r.prompt, "tokens": r.tokens,
                                "logprobs": r.logprobs}) + "\n")
    return rollouts

loop.RLLoop.setup, loop.RLLoop.run, rollout.RolloutCollector._harvest = setup_, run_, harvest_
sys.exit(main(sys.argv[2:]))
"""


def _clean_env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("LLMT_") and k != "XLA_FLAGS"}
    return {**env, "PYTHONPATH": str(ROOT), "JAX_PLATFORMS": "cpu"}


def _records(text: str, kind: str) -> list[dict]:
    return [r for r in (json.loads(line) for line in text.splitlines() if line.startswith("{"))
            if r.get("type") == kind]


@pytest.fixture(scope="module")
def jax_rl_fit(tmp_path_factory):
    """The JAX `rl-fit` on the smoke config, 3 rounds, in a process of its own
    (one CPU device, as `scripts/rl_smoke.py` runs it)."""
    out = tmp_path_factory.mktemp("jax-rl")
    run = subprocess.run(
        [sys.executable, "-c", _JAX_RL_FIT, str(out), "rl-fit", "--config", SMOKE_CONFIG,
         *SMOKE_FLAGS, f"run_root={out / 'run'}"],
        cwd=ROOT, env=_clean_env(), capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    rollouts = [json.loads(line) for line in (out / "rollouts.jsonl").read_text().splitlines()]
    return out, _records(run.stdout, "rl_round"), _records(run.stdout, "stats")[0], rollouts


def _load_jax_init(monkeypatch, init_npz: Path):
    """The port's GRPO pair starts from the JAX run's initial parameters."""
    real = GRPO.configure_model

    def configure_model(self, device, generator, load_pretrained=True):
        pair = real(self, device, generator, load_pretrained)
        with np.load(init_npz) as flat:
            pair.load_state_dict(state_dict_from_jax(tree_from_flat(flat), self.model.config))
        return pair

    monkeypatch.setattr(GRPO, "configure_model", configure_model)


def _harvested(monkeypatch) -> list:
    got = []
    real = port_rollout.RolloutCollector._harvest

    def harvest(self, round_idx):
        rollouts = real(self, round_idx)
        got.extend(rollouts)
        return rollouts

    monkeypatch.setattr(port_rollout.RolloutCollector, "_harvest", harvest)
    return got


def _port_rl_fit(capsys, *argv) -> tuple[int, list[dict], dict | None]:
    capsys.readouterr()
    rc = cli.main(["rl-fit", "--config", PORT_SMOKE_CONFIG, "--device", "cpu", *SMOKE_FLAGS,
                   *argv])
    out = capsys.readouterr().out
    stats = _records(out, "stats")
    return rc, _records(out, "rl_round"), stats[0]["stats"] if stats else None


def test_smoke_config_is_the_jax_example():
    """The port's JSON smoke config is the JAX package's YAML example."""
    import yaml

    assert json.loads((ROOT / PORT_SMOKE_CONFIG).read_text()) == yaml.safe_load(
        (ROOT / SMOKE_CONFIG).read_text())


def test_rl_fit_matches_jax(jax_rl_fit, monkeypatch, capsys, tmp_path):
    """`rl-fit` on the smoke config from the same initial parameters: every
    round's rollouts have JAX's tokens (and logprobs within 1e-4), rewards
    and mean reward; the loss, KL and clip fraction within rtol 1e-4, each
    tensor of the final policy and reference within 1e-4 relative in norm;
    the mean reward rises as the smoke gate asks (the last two rounds over
    the first two)."""
    out, jax_rounds, jax_stats, jax_rollouts = jax_rl_fit
    _load_jax_init(monkeypatch, out / "init.npz")
    got = _harvested(monkeypatch)
    final = {}
    real_run = cli.RLLoop.run

    def run(self, *args, **kwargs):
        result = real_run(self, *args, **kwargs)
        final.update({k: v.detach().clone() for k, v in self.state.model.state_dict().items()})
        return result

    monkeypatch.setattr(cli.RLLoop, "run", run)
    rc, rounds, stats = _port_rl_fit(capsys, f"run_root={tmp_path}")
    assert rc == 0 and len(rounds) == len(jax_rounds) == 3
    assert [(r.id, r.prompt, r.tokens) for r in got] == [
        (r["id"], r["prompt"], r["tokens"]) for r in jax_rollouts]
    assert len(got) == 96
    np.testing.assert_allclose([lp for r in got for lp in r.logprobs],
                               [lp for r in jax_rollouts for lp in r["logprobs"]],
                               rtol=1e-4, atol=1e-5)
    ours, theirs = resolve_reward("copy_digit"), jax_reward.resolve_reward("copy_digit")
    assert [ours(r.prompt, r.tokens) for r in got] == [
        theirs(r["prompt"], r["tokens"]) for r in jax_rollouts]
    for mine, jax_round in zip(rounds, jax_rounds):
        for key in ("round", "collected", "mean_reward", "generation", "rl/rollouts_collected",
                    "rl/rollouts_stale_dropped"):
            assert mine[key] == jax_round[key], key
        for key in ("loss", "kl_to_ref", "ratio_clip_frac"):
            np.testing.assert_allclose(mine[key], jax_round[key], rtol=FIT_RTOL, err_msg=key)
    rewards = [r["mean_reward"] for r in rounds]
    assert sum(rewards[-2:]) > sum(rewards[:2]), rewards
    for key in ("rl/weight_syncs", "rl/rollouts_collected", "serve/weights_generation",
                "serve/tokens_generated"):
        assert stats[key] == jax_stats["stats"][key], key
    with np.load(out / "final.npz") as flat:
        expected = state_dict_from_jax(tree_from_flat(flat), LlamaConfig(**TINY | dict(
            vocab_size=16, hidden_size=32, intermediate_size=64, num_attention_heads=4,
            num_key_value_heads=2, head_dim=None, max_position_embeddings=64, rms_norm_eps=1e-6)))
    assert set(expected) == set(final)
    # per tensor, in norm: Adam divides each coordinate's step by its own
    # moment, so a coordinate whose gradient is ~0 moves by the ratio of two
    # tiny numbers (the worst element reaches 1.7e-4 of its tensor's max)
    worst = max(np.linalg.norm(t.numpy() - expected[n].numpy()) / np.linalg.norm(
        expected[n].numpy()) for n, t in final.items())
    assert worst <= FIT_RTOL, worst


def test_rl_fit_sigterm_drill_resumes(monkeypatch, capsys, tmp_path):
    """A shutdown requested five engine steps into round 2: drain, the
    rollouts in flight journaled, the round cursor checkpointed, exit 75.
    The relaunch (host sync) replays and adopts them, finishes every round
    and exits 0 with the journal retired; no stale sample is trained on."""
    installed = []

    class Shutdown(cli.GracefulShutdown):
        def install(self):
            installed.append(self)
            return self

    real_step = ServingEngine.step
    counted = [0]

    def step(self):
        if self.weights_generation == 1:
            counted[0] += 1
            if counted[0] == 5:
                installed[-1].request()
        return real_step(self)

    monkeypatch.setattr(cli, "GracefulShutdown", Shutdown)
    monkeypatch.setattr(ServingEngine, "step", step)
    run_dir = tmp_path / "smoke" / "rl-smoke"
    rc, rounds, stats = _port_rl_fit(capsys, f"run_root={tmp_path}")
    assert rc == 75 and [r["round"] for r in rounds] == [0]
    journal = (run_dir / "rl-journal.jsonl").read_text().splitlines()
    in_flight = {json.loads(line)["id"] for line in journal} - {
        json.loads(line)["id"] for line in journal if json.loads(line)["event"] == "done"}
    assert in_flight and all(i.startswith("rl:r1:") for i in in_flight)
    meta = json.loads((run_dir / "checkpoints" / "step_2" / "meta.json").read_text())
    assert meta["rl"] == {"round": 1}

    monkeypatch.setattr(ServingEngine, "step", real_step)
    rc, rounds, stats = _port_rl_fit(capsys, f"run_root={tmp_path}", "--sync-mode", "host")
    assert rc == 0 and [r["round"] for r in rounds] == [1, 2]
    assert stats["serve/replayed_requests"] >= 1
    assert stats["rl/rollouts_stale_dropped"] == 0
    # round 1's adopted samples are collected, not submitted again
    assert stats["rl/rollouts_collected"] == 64
    assert stats["rl/rollouts_submitted"] == 64 - stats["serve/replayed_requests"]
    assert not (run_dir / "rl-journal.jsonl").exists()
    assert not (run_dir / "rl-journal.replaying.jsonl").exists()
    meta = json.loads((run_dir / "checkpoints" / "step_6" / "meta.json").read_text())
    assert meta["rl"] == {"round": 3}


@pytest.mark.parametrize("env,flags,match", [
    ({}, ["--max-queue", "8"], None),
    ({"LLMT_SLO_TTFT_P99_MS": "50"}, [], "SLO monitor"),
    ({"LLMT_METRICS_PORT": "9400"}, [], "exporter"),
    ({"LLMT_CHAOS_SERVE_SIGTERM_STEP": "5"}, [], None),
], ids=["max_queue", "slo", "metrics_port", "serve_chaos"])
def test_rl_fit_refuses_what_is_not_ported(monkeypatch, tmp_path, env, flags, match):
    """What `rl-fit` cannot honour yet raises, naming ROADMAP A.7b: an armed
    SLO target and the exporter. `--max-queue` and the serve chaos triggers
    are ported (A.7a): the queue bound reaches the engine's scheduler and
    the trigger parses (zero rounds run no engine step, so it never
    fires)."""
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    argv = ["rl-fit", "--config", PORT_SMOKE_CONFIG, "--device", "cpu", *flags,
            f"run_root={tmp_path}"]
    if match is not None:
        with pytest.raises(NotImplementedError, match=match) as raised:
            cli.main(argv)
        assert "A.7b" in str(raised.value)
        return
    engines = []
    real_setup = cli.RLLoop.setup

    def setup(loop):
        real_setup(loop)
        engines.append(loop.engine)

    monkeypatch.setattr(cli.RLLoop, "setup", setup)
    assert cli.main([*argv, "--rounds", "0"]) == 0
    scheduler = engines[0].scheduler.config
    assert scheduler.max_queue == (8 if flags else None)


def test_rl_fit_needs_grpo(tmp_path):
    config = json.loads((ROOT / "llm_training_tpu_torch/config/cpu-smoke.json").read_text())
    path = tmp_path / "clm.json"
    path.write_text(json.dumps(config))
    with pytest.raises(SystemExit, match="rl-fit drives the GRPO objective"):
        cli.main(["rl-fit", "--config", str(path), "--device", "cpu", f"run_root={tmp_path}"])


def test_rl_fit_user_traffic_rides_the_engine(capsys, tmp_path):
    """`--user-traffic` requests share the engine at priority 0: their
    terminals reach the foreign-event path (counted in `user_done`), the
    rollouts are harvested as before."""
    rc, rounds, stats = _port_rl_fit(capsys, "--user-traffic", "3", "--rounds", "2",
                                     f"run_root={tmp_path}")
    assert rc == 0 and [r["user_done"] for r in rounds] == [3, 6]
    assert stats["rl/user_requests_done"] == 6 and stats["rl/rollouts_collected"] == 64
    assert stats["serve/requests_completed"] == 64 + 6
