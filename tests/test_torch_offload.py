"""Port parity of the offloaded, block-quantized optimizer state on the CPU:
the port's `Trainer` with `offload_optimizer_state` against the JAX
trainer's own offloaded train steps (`_build_blocked_offload_step` without
accumulation, the serialized `_build_step` with accumulation or frozen
modules), driven as `tests/test_quantized_state.py` drives them, with
device memory kinds (the JAX fit cannot place `pinned_host` on the CPU).
Also: the JAX offloaded state (int8 `QuantArray`s, bfloat16 casts) carried
into the port, Lion and Adafactor fits against the JAX chain, and JAX
Lion/Adafactor state carried into the port.

Tolerances: the losses within rtol 1e-4 (the fit parity limit,
`tests/test_torch_train.py`). The parameters within atol 2e-4 and rtol
1e-3 (the JAX test's limit for int8 state against float32,
`tests/test_quantized_state.py`), all but 0.1% of each tensor's elements:
the port's moments differ from JAX's in the last bits, which now and then
moves a code across a rounding boundary, and a moved code changes that
element's later steps by up to a grid step of its block. Those few
elements stay within 2 x peak lr x steps, the furthest two Adam
trajectories of one element can part when each step moves it by about lr.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from llm_training_tpu.lms.clm import CLM as JaxCLM
from llm_training_tpu.lms.clm import CLMConfig as JaxCLMConfig
from llm_training_tpu.lms.dpo import DPO as JaxDPO
from llm_training_tpu.lms.dpo import DPOConfig as JaxDPOConfig
from llm_training_tpu.optim.builder import OptimConfig as JaxOptimConfig
from llm_training_tpu.optim.builder import build_optimizer as jax_optimizer
from llm_training_tpu.optim.quantized_state import QuantArray
from llm_training_tpu.parallel.mesh import MeshConfig, build_mesh
from llm_training_tpu.trainer.state import TrainState as JaxTrainState
from llm_training_tpu.trainer.trainer import LOGICAL_AXIS_RULES
from llm_training_tpu.trainer.trainer import Trainer as JaxTrainer
from llm_training_tpu.trainer.trainer import TrainerConfig as JaxTrainerConfig
from llm_training_tpu_torch.lms import DPO, DPOConfig
from llm_training_tpu_torch.lms.clm import CLM, CLMConfig
from llm_training_tpu_torch.models.llama.config import LlamaConfig
from llm_training_tpu_torch.models.llama.from_jax import (
    state_dict_from_jax,
    train_state_dict_from_jax,
)
from llm_training_tpu_torch.optim.builder import OptimConfig
from llm_training_tpu_torch.trainer.trainer import Trainer, TrainerConfig
from tests.test_torch_train import TINY, _Batches, _jax_llama, _Losses, _packed_batch, _port_llama

STEPS = 4
OPTIM = dict(learning_rate=2e-3, warmup_steps=2, min_lr_ratio=0.1, grad_clip_norm=1.0,
             optimizer_kwargs={"b2": 0.95, "weight_decay": 0.1})
FIT_RTOL = 1e-4
PARAM_TOL = dict(atol=2e-4, rtol=1e-3)
BLOCK = 16


def _assert_params_track(model, final: dict, steps: int, lr: float) -> None:
    for name, p in model.named_parameters():
        got, ref = p.detach().numpy(), final[name].numpy()
        outside = ~np.isclose(got, ref, **PARAM_TOL)
        assert outside.mean() <= 1e-3, (name, int(outside.sum()), got.size)
        np.testing.assert_allclose(got, ref, rtol=0, atol=2 * lr * steps, err_msg=name)


def _batches(accumulate: int, steps: int = STEPS) -> list[dict]:
    rng = np.random.default_rng(9)
    distinct = [_packed_batch(rng, 2, 32) for _ in range(4)]
    return [distinct[i % 4] for i in range(steps * accumulate)]


def _quant_leaves(opt_state) -> list:
    return [x for x in jax.tree.leaves(opt_state, is_leaf=lambda x: isinstance(x, QuantArray))
            if isinstance(x, QuantArray)]


def _jax_offload_run(objective, params, batches, accumulate, dtype, optim=OPTIM):
    """The JAX trainer's offloaded step over `batches` on one CPU device.
    Returns each optimizer step's (loss, params, opt_state) after its
    last micro-batch, and what JAX's re-encode of the untouched moments
    did on the non-final micro-steps: (codes moved, scales moved, the
    largest move of a scale in float32 ulps)."""
    trainer = JaxTrainer(JaxTrainerConfig(
        max_steps=STEPS, accumulate_grad_batches=accumulate, offload_optimizer_state=True,
        offload_state_dtype=dtype, offload_quant_block=BLOCK))
    trainer.mesh = build_mesh(MeshConfig(), devices=jax.devices()[:1])
    moved = [0, 0, 0]
    with trainer.mesh, nn.logical_axis_rules(LOGICAL_AXIS_RULES):
        tx, _ = trainer._build_tx(objective)
        assert trainer._blocked_offload == (accumulate == 1 and not objective.config.frozen_modules)
        state = JaxTrainState.create(params, trainer._opt_init(tx, params), jax.random.key(43))
        device = NamedSharding(trainer.mesh, PartitionSpec())
        if trainer._blocked_offload:
            opt_sh = tuple(jax.tree.map(lambda _: device, block) for block in state.opt_state)
            step = trainer._build_blocked_offload_step(objective, tx, opt_sh, opt_sh)
        else:
            trainer.state_shardings = jax.tree.map(lambda _: device, jax.eval_shape(lambda: state))
            step = trainer._build_step(objective, tx)
        step = jax.jit(step)
        out = []
        for micro, batch in enumerate(batches):
            before = jax.device_get(_quant_leaves(state.opt_state))
            state, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
            if (micro + 1) % accumulate:
                for a, b in zip(before, jax.device_get(_quant_leaves(state.opt_state))):
                    moved[0] += int((np.asarray(a.q) != np.asarray(b.q)).sum())
                    sa, sb = (np.asarray(x.scale).view(np.int32).astype(np.int64) for x in (a, b))
                    moved[1] += int((sa != sb).sum())
                    moved[2] = max(moved[2], int(np.abs(sa - sb).max()))
            else:
                out.append((float(metrics["loss"]), *jax.device_get((state.params,
                                                                     state.opt_state))))
    return out, moved


def _port_fit(objective, batches, accumulate, dtype, offload=True, steps=STEPS):
    recorder = _Losses()
    trainer = Trainer(
        TrainerConfig(max_steps=steps, accumulate_grad_batches=accumulate, log_every_n_steps=1,
                      offload_optimizer_state=offload,
                      offload_state_dtype=dtype if offload else "float32",
                      offload_quant_block=BLOCK),
        callbacks=[recorder], device="cpu",
    )
    state = trainer.fit(objective, _Batches(batches))
    return recorder.losses, state


CASES = [("int8", 1), ("int8", 2), ("bfloat16", 1), ("bfloat16", 2)]


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's offloaded CLM runs, one per (dtype, accumulation), on one
    tiny Llama's weights."""
    jax_model, params = _jax_llama(seed=1)
    runs = {}
    for dtype, accumulate in CASES:
        objective = JaxCLM(JaxCLMConfig(optim=JaxOptimConfig(**OPTIM)), model=jax_model)
        runs[dtype, accumulate] = _jax_offload_run(objective, params, _batches(accumulate),
                                                   accumulate, dtype)
    return params, runs


@pytest.mark.parametrize("dtype,accumulate", CASES, ids=[f"{d}-acc{a}" for d, a in CASES])
def test_offloaded_fit_matches_jax(jax_runs, dtype, accumulate):
    """4 optimizer steps with the state offloaded through the codec: the
    port's losses and final parameters track JAX's offloaded steps, and
    the stored state has JAX's dtypes. Under accumulation JAX re-encodes
    the untouched moments on every non-final micro-step; its codes come
    back the same (the codec is a fixed point), which is why the port
    skips it. Its scales do not all: inside XLA's fused step about 4% of
    them move by 1 ulp (ROADMAP C.13), while the port's codec is
    bit-idempotent (`tests/test_torch_optim.py`), so skipping equals
    re-encoding there."""
    params, runs = jax_runs
    expected, (codes_moved, scales_moved, ulps) = runs[dtype, accumulate]
    assert codes_moved == 0
    assert ulps <= 1 and (scales_moved > 0) == (dtype == "int8" and accumulate > 1)
    losses, state = _port_fit(CLM(CLMConfig(optim=OptimConfig(**OPTIM)), model=_port_llama(params)),
                              _batches(accumulate), accumulate, dtype)
    np.testing.assert_allclose(losses, [loss for loss, _, _ in expected], rtol=FIT_RTOL)
    final = state_dict_from_jax(expected[-1][1], LlamaConfig(**TINY))
    _assert_params_track(state.model, final, STEPS, OPTIM["learning_rate"])
    stored = state.optimizer.state_dict()
    kinds = {k.split(".")[0]: t.dtype for k, t in stored.items() if t.ndim}
    if dtype == "int8":
        assert stored["mu.model.embed_tokens.weight.q"].dtype == torch.int8
        assert stored["nu.lm_head.weight.q"].dtype == torch.uint8
    else:
        assert kinds["mu"] == kinds["nu"] == torch.bfloat16
    assert kinds.get("acc", torch.float32) == torch.float32
    assert state.optimizer.store.host_bytes() > 0


@pytest.mark.parametrize("dtype,accumulate", [("int8", 2), ("bfloat16", 2)])
def test_jax_offloaded_state_resumes_in_the_port(jax_runs, dtype, accumulate):
    """JAX's offloaded state after 3 optimizer steps (the serialized
    layout: `QuantArray` codes and scales, or bfloat16 casts, and the
    float32 accumulator) carried into the port, bit for bit; then the
    port's step 4 follows JAX's step 4."""
    runs = jax_runs[1]
    last_loss, last_params, _ = runs[dtype, accumulate][0][STEPS - 1]
    _, params, opt = runs[dtype, accumulate][0][STEPS - 2]
    adam = opt.inner_opt_state[1][0]  # MultiSteps(chain(clip, adamw chain))
    config = LlamaConfig(**TINY)
    carried = train_state_dict_from_jax(
        config, params=params, step=(STEPS - 1) * accumulate,
        rng=np.asarray([0, 43], np.uint32), count=int(adam.count), mu=adam.mu, nu=adam.nu,
        acc_grads=opt.acc_grads, mini_step=int(opt.mini_step))
    trainer = Trainer(
        TrainerConfig(max_steps=STEPS, accumulate_grad_batches=accumulate, log_every_n_steps=1,
                      offload_optimizer_state=True, offload_state_dtype=dtype,
                      offload_quant_block=BLOCK), device="cpu")
    objective = CLM(CLMConfig(optim=OptimConfig(**OPTIM)), model=_port_llama(jax_runs[0]))
    state, _ = trainer.init_state(objective)
    assert set(carried) == set(state.state_dict())
    state.load_state_dict(carried)
    for key, tensor in state.state_dict().items():
        assert torch.equal(tensor, carried[key]), key
    batches = _batches(accumulate)
    for micro in range((STEPS - 1) * accumulate, STEPS * accumulate):
        metrics = trainer.train_micro_step(objective, state, batches[micro])
    assert float(metrics["loss"]) == pytest.approx(last_loss, rel=FIT_RTOL)
    final = state_dict_from_jax(last_params, config)
    _assert_params_track(state.model, final, 1, OPTIM["learning_rate"])


def test_offloaded_dpo_matches_jax_serialized_path():
    """DPO with int8 offloaded state: JAX takes its serialized path (the
    reference is frozen by `^ref/`), whose masked reference holds no state;
    the port's losses follow it within rtol 1e-4, its reference ends
    bit-equal to its start, and the optimizer stores nothing for it. The
    parameters are not compared: where the policy equals the reference,
    many embedding rows get gradients that cancel to rounding noise, and
    Adam's first steps move each such element by about lr in the noise's
    sign, in float32 state too."""
    from tests.test_torch_preference import TINY as PREF_TINY
    from tests.test_torch_preference import _collate, _examples, _jax_model

    jax_model, params = _jax_model(seed=1)
    config = LlamaConfig(**PREF_TINY)
    rng = np.random.default_rng(9)
    distinct = [_collate(_examples(rng, 2)) for _ in range(3)]
    batches = [distinct[i % 3] for i in range(4)]
    jax_objective = JaxDPO(JaxDPOConfig(optim=JaxOptimConfig(**OPTIM)), model=jax_model)
    expected, _ = _jax_offload_run(jax_objective, {"policy": params, "ref": params}, batches, 1,
                                   "int8")
    from llm_training_tpu_torch.models.llama.model import Llama

    model = Llama(config, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, config))
    losses, state = _port_fit(DPO(DPOConfig(optim=OptimConfig(**OPTIM)), model=model), batches, 1,
                              "int8", steps=4)
    np.testing.assert_allclose(losses, [loss for loss, _, _ in expected], rtol=FIT_RTOL)
    assert losses[0] == pytest.approx(np.log(2.0), rel=1e-6) and losses[-1] < losses[0]
    initial = state_dict_from_jax(params, config)
    for name, p in state.model.ref.named_parameters():
        assert torch.equal(p, initial[name]), name
    stored = state.optimizer.state_dict()
    assert not [k for k in stored if ".ref." in k]
    assert stored["mu.policy.model.embed_tokens.weight.q"].dtype == torch.int8


# ---------------------------------------------------------------- lion, adafactor fits

FITS = {
    "lion": dict(optimizer="lion", learning_rate=3e-4, warmup_steps=2, grad_clip_norm=1.0),
    # the tiny Llama's leaves factor from 32: the stacks [2, 64, 32|64|128],
    # the embedding [128, 64] and lm_head [64, 128]; the norm stacks [2, 64]
    # and the final norm keep the full v
    "adafactor": dict(optimizer="adafactor", learning_rate=0.3, warmup_steps=2,
                      optimizer_kwargs={"min_dim_size_to_factor": 32, "momentum": 0.9}),
}


def _jax_chain_fit(jax_model, params, batches, optim, steps):
    """The JAX CLM under the JAX build_optimizer chain: the losses of each
    step and the (params, opt_state) after each."""
    objective = JaxCLM(JaxCLMConfig(), model=jax_model)
    tx, _ = jax_optimizer(JaxOptimConfig(**optim), steps)
    state = tx.init(params)

    @jax.jit
    def step(params, state, batch):
        loss_fn = lambda p: objective.loss_and_metrics(p, batch, train=True)[0]  # noqa: E731
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state, loss

    out = []
    for batch in batches:
        params, state, loss = step(params, state, {k: jnp.asarray(v) for k, v in batch.items()})
        out.append((float(loss), *jax.device_get((params, state))))
    return out


def _optax_state(opt_state) -> dict:
    """count and the state trees of a lion or adafactor chain, by field."""
    fields = {}
    for node in jax.tree.leaves(opt_state, is_leaf=lambda x: isinstance(
            x, (optax.ScaleByLionState, optax.FactoredState, optax.EmaState))):
        if isinstance(node, optax.ScaleByLionState):
            fields.update(count=node.count, mu=node.mu)
        elif isinstance(node, optax.FactoredState):
            fields.update(count=node.count, v_row=node.v_row, v_col=node.v_col, v=node.v)
        elif isinstance(node, optax.EmaState):
            fields["ema"] = node.ema
    return fields


@pytest.mark.parametrize("name", list(FITS))
def test_fit_matches_jax(name):
    """8 steps of a tiny Llama (scanned JAX layout): the port's Trainer
    follows the JAX chain within rtol 1e-4 and the loss falls; then JAX's
    state after step 7 (Adafactor's per-leaf moments with optax's (1,)
    placeholders, which the port keeps) carried into the port gives JAX's
    step 8."""
    steps = 8
    jax_model, params = _jax_llama(seed=1)
    batches = _batches(1, steps)
    expected = _jax_chain_fit(jax_model, params, batches, FITS[name], steps)
    losses, _ = _port_fit(CLM(CLMConfig(optim=OptimConfig(**FITS[name])),
                              model=_port_llama(params)), batches, 1, "float32", offload=False,
                          steps=steps)
    np.testing.assert_allclose(losses, [loss for loss, _, _ in expected], rtol=FIT_RTOL)
    assert losses[-1] < losses[0]

    _, params_before, opt_before = expected[steps - 2]
    fields = _optax_state(opt_before)
    config = LlamaConfig(**TINY)
    carried = train_state_dict_from_jax(
        config, params=params_before, step=steps - 1, rng=np.asarray([0, 43], np.uint32),
        count=int(fields.pop("count")), **fields)
    trainer = Trainer(TrainerConfig(max_steps=steps), device="cpu")
    objective = CLM(CLMConfig(optim=OptimConfig(**FITS[name])), model=_port_llama(params))
    state, _ = trainer.init_state(objective)
    assert set(carried) == set(state.state_dict())
    state.load_state_dict(carried)
    metrics = trainer.train_micro_step(objective, state, batches[-1])
    assert float(metrics["loss"]) == pytest.approx(expected[-1][0], rel=FIT_RTOL)
    final = state_dict_from_jax(expected[-1][1], config)
    for pname, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), final[pname].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=pname)
