"""Port parity of the training path on the CPU: cross-entropy, the CLM
objective, schedules and optimizers, activation checkpointing, the data
pipeline pieces, and a 20-step fit of a tiny Llama against the JAX CLM
with its optax chain. The same numpy inputs go to both packages (fp32).
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

from llm_training_tpu.data.dummy import DummyDataModule as JaxDummy
from llm_training_tpu.data.dummy import DummyDataModuleConfig as JaxDummyConfig
from llm_training_tpu.data.pre_training.collator import PreTrainingDataCollator as JaxCollator
from llm_training_tpu.data.pre_training.datamodule import _best_fit_decreasing as jax_bfd
from llm_training_tpu.data.pre_training.datamodule import best_fit_bin_packing_py as jax_bfp
from llm_training_tpu.lms.clm import CLM as JaxCLM
from llm_training_tpu.lms.clm import CLMConfig as JaxCLMConfig
from llm_training_tpu.models import Llama as JaxLlama
from llm_training_tpu.models import LlamaConfig as JaxLlamaConfig
from llm_training_tpu.optim.builder import OptimConfig as JaxOptimConfig
from llm_training_tpu.optim.builder import build_lr_schedule as jax_schedule
from llm_training_tpu.optim.builder import build_optimizer as jax_optimizer
from llm_training_tpu_torch import prng
from llm_training_tpu_torch.cli.main import main as cli_main
from llm_training_tpu_torch.data.base import BaseDataModule, BaseDataModuleConfig
from llm_training_tpu_torch.data.dummy import DummyDataModule, DummyDataModuleConfig
from llm_training_tpu_torch.data.pre_training import packing
from llm_training_tpu_torch.data.pre_training.collator import PreTrainingDataCollator
from llm_training_tpu_torch.lms.clm import CLM, CLMConfig
from llm_training_tpu_torch.models import remat
from llm_training_tpu_torch.models.llama.config import LlamaConfig
from llm_training_tpu_torch.models.llama.from_jax import state_dict_from_jax
from llm_training_tpu_torch.models.llama.model import Llama
from llm_training_tpu_torch.ops import cross_entropy as ce
from llm_training_tpu_torch.optim.builder import OptimConfig, build_lr_schedule, build_optimizer
from llm_training_tpu_torch.trainer.trainer import Trainer, TrainerConfig

# the JAX package exports the function `cross_entropy` over its module's name
jax_ce = importlib.import_module("llm_training_tpu.ops.cross_entropy")
TOL = dict(rtol=1e-5, atol=1e-6)  # fp32, summation order only
TINY = dict(
    vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, head_dim=16,
    max_position_embeddings=64, rms_norm_eps=1e-5, rope_theta=500000.0,
    rope_scaling={
        "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
        "high_freq_factor": 4.0, "original_max_position_embeddings": 16,
    },
    compute_dtype="float32", param_dtype="float32",
)
CONFIG_FILE = "llm_training_tpu_torch/config/cpu-smoke.json"


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------- losses


def test_shift_labels_matches_jax():
    labels = np.random.default_rng(0).integers(0, 50, (2, 7)).astype(np.int64)
    np.testing.assert_array_equal(
        ce.shift_labels(_t(labels)).numpy(), np.asarray(jax_ce.shift_labels(jnp.asarray(labels)))
    )


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_cross_entropy_matches_jax(reduction):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5))
    labels[0, 1] = labels[1, 4] = -100
    np.testing.assert_allclose(
        ce.cross_entropy(_t(logits), _t(labels), reduction=reduction).numpy(),
        np.asarray(jax_ce.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), reduction=reduction)),
        **TOL,
    )


@pytest.mark.parametrize("chunk", [4, 7, 64], ids=["uneven", "uneven7", "one_chunk"])
def test_fused_linear_cross_entropy_matches_jax(chunk):
    """Loss and gradients (hidden, weight), with ignored labels and an
    uneven last chunk (30 tokens)."""
    rng = np.random.default_rng(2)
    hidden = rng.standard_normal((3, 10, 16)).astype(np.float32)
    weight = (0.3 * rng.standard_normal((16, 37))).astype(np.float32)
    labels = rng.integers(0, 37, (3, 10))
    labels[:, -1] = -100
    labels[1, 3] = -100

    def jax_loss(h, w):
        total, count = jax_ce.fused_linear_cross_entropy(h, w, jnp.asarray(labels), chunk_size=chunk)
        return total / count, count

    (jl, jcount), jgrads = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(hidden), jnp.asarray(weight)
    )
    h, w = _t(hidden).requires_grad_(), _t(weight).requires_grad_()
    total, count = ce.fused_linear_cross_entropy(h, w, _t(labels), chunk_size=chunk)
    loss = total / count
    loss.backward()
    assert int(count) == int(jcount) == 26
    np.testing.assert_allclose(float(loss), float(jl), **TOL)
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(jgrads[0]), **TOL)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(jgrads[1]), **TOL)


def _bf16_step_error(got, ref) -> float:
    """max |got - ref| over max |ref|, in bf16 steps (2^-8)."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / np.abs(ref).max() / 2.0**-8)


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("cap", [None, 30.0], ids=["nocap", "cap30"])
def test_fused_linear_cross_entropy_bf16_matches_jax(cap, bias):
    """bf16 hidden and weight: the logits are the product's fp32 accumulator
    in both packages (JAX: `preferred_element_type=float32`), never rounded
    to bf16. The loss sum differs only by the order of its fp32 sums (rtol
    1e-5); the bf16 gradients of hidden and weight are within one bf16 step
    (2^-8 of max|ref|)."""
    rng = np.random.default_rng(11)
    tokens, embed, vocab, chunk = 96, 64, 512, 32
    hidden = rng.standard_normal((tokens, embed)).astype(np.float32)
    weight = (0.5 * rng.standard_normal((embed, vocab))).astype(np.float32)
    b = rng.standard_normal(vocab).astype(np.float32) if bias else None
    labels = rng.integers(0, vocab, tokens)
    labels[::7] = -100

    def jax_total(h, w):
        return jax_ce.fused_linear_cross_entropy(
            h, w, jnp.asarray(labels), chunk_size=chunk, logits_soft_cap=cap,
            bias=None if b is None else jnp.asarray(b, jnp.bfloat16),
        )[0]

    jtotal, jgrads = jax.value_and_grad(jax_total, argnums=(0, 1))(
        jnp.asarray(hidden, jnp.bfloat16), jnp.asarray(weight, jnp.bfloat16)
    )
    h = _t(hidden).bfloat16().requires_grad_()
    w = _t(weight).bfloat16().requires_grad_()
    total, _ = ce.fused_linear_cross_entropy(
        h, w, _t(labels), chunk_size=chunk, logits_soft_cap=cap,
        bias=None if b is None else _t(b).bfloat16(),
    )
    total.backward()
    assert total.dtype == torch.float32 and h.grad.dtype == w.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(float(total.detach()), float(jtotal), rtol=1e-5)
    steps = {
        "hidden": _bf16_step_error(h.grad.float().numpy(), jgrads[0].astype(jnp.float32)),
        "weight": _bf16_step_error(w.grad.float().numpy(), jgrads[1].astype(jnp.float32)),
    }
    print(f"bf16 fused CE gradients vs JAX, in bf16 steps of max|ref|: {steps}")
    assert max(steps.values()) <= 1.0, steps


def test_swiglu_bf16_matches_jax():
    """bf16 `silu_mul` against `llm_training_tpu/ops/swiglu.py` on the same
    inputs. `F.silu` computes in fp32 and rounds once; `jax.nn.silu` in bf16
    rounds after each primitive of x * logistic(x), so single elements
    differ by a few bf16 steps of their own value. Held to 2 x 2^-8 of
    max|ref|."""
    from llm_training_tpu.ops.swiglu import silu_mul as jax_silu_mul
    from llm_training_tpu_torch.ops.swiglu import silu_mul

    rng = np.random.default_rng(12)
    gate = (3 * rng.standard_normal((96, 256))).astype(np.float32)
    up = rng.standard_normal((96, 256)).astype(np.float32)
    ours = silu_mul(_t(gate).bfloat16(), _t(up).bfloat16()).float().numpy()
    theirs = np.asarray(
        jax_silu_mul(jnp.asarray(gate, jnp.bfloat16), jnp.asarray(up, jnp.bfloat16))
        .astype(jnp.float32)
    )
    per_element = float((np.abs(ours - theirs) / np.maximum(np.abs(theirs), 1e-30)).max())
    worst = _bf16_step_error(ours, theirs)
    print(f"bf16 silu_mul vs JAX: worst difference {worst:.3f} x 2^-8 of max|ref|, "
          f"{per_element / 2.0**-8:.3f} x 2^-8 of a single element's own value, "
          f"{float((ours != theirs).mean()):.3f} of the elements differ")
    assert worst <= 2.0


# ---------------------------------------------------------------- the model and objective


def _jax_llama(seed=0, **overrides):
    model = JaxLlama(JaxLlamaConfig(**{**TINY, **overrides}, scan_layers=True, attention_impl="xla"))
    variables = model.init(jax.random.key(seed), np.zeros((1, 4), np.int32))
    return model, jax.device_get(nn.meta.unbox(variables))


def _port_llama(params, **overrides) -> Llama:
    config = LlamaConfig(**{**TINY, **overrides})
    model = Llama(config, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, config))
    return model


def _packed_batch(rng, batch, seq, max_doc=12, vocab=128):
    """A packed batch from the port's best-fit packer and collator: seeded
    documents, segment ids 1..N per row, a padding tail."""
    lengths = rng.integers(3, max_doc + 1, size=6 * batch).tolist()
    docs = {"source": ["s"] * len(lengths), "length": lengths,
            "input_ids": [rng.integers(1, vocab, n).tolist() for n in lengths]}
    rows = packing.best_fit_decreasing(docs, seq - 2)
    examples = [{"input_ids": ids, "segment_ids": segs}
                for ids, segs in zip(rows["input_ids"][:batch], rows["segment_ids"][:batch])]
    tokenizer = types.SimpleNamespace(pad_token_id=0, bos_token_id=None)
    config = types.SimpleNamespace(tokenizer=tokenizer, pad_to_multiple_of=seq)
    return PreTrainingDataCollator(config)(examples)


def test_clm_masks_packed_boundaries_like_jax():
    """On a packed batch the CLM loss and its target count match JAX: no
    label crosses a document boundary or lands on padding."""
    jax_model, params = _jax_llama()
    batch = _packed_batch(np.random.default_rng(3), 2, 32)
    seg = batch["segment_ids"]
    expected_targets = int(((seg > 0) & (seg == np.pad(seg[:, 1:], ((0, 0), (0, 1))))).sum())
    jloss, jmetrics = JaxCLM(JaxCLMConfig(), model=jax_model).loss_and_metrics(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, train=False
    )
    loss, metrics = CLM(CLMConfig(), model=_port_llama(params)).loss_and_metrics(
        {k: _t(v) for k, v in batch.items()}, train=False
    )
    assert int(metrics["target_tokens"]) == int(jmetrics["target_tokens"]) == expected_targets
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["perplexity"]), float(jmetrics["perplexity"]), rtol=1e-5)


def _neftune_against_jax(compute_dtype):
    jax_model, params = _jax_llama(compute_dtype=compute_dtype)
    host = _packed_batch(np.random.default_rng(4), 2, 32)
    batch = {k: _t(v) for k, v in host.items()}
    objective = CLM(CLMConfig(neftune_alpha=5.0),
                    model=_port_llama(params, compute_dtype=compute_dtype))
    clean = CLM(CLMConfig(), model=objective.model).loss_and_metrics(batch, train=False)[0]
    key = prng.fold_in(prng.key(9), 3)
    noisy = [objective.loss_and_metrics(batch, rng=key)[0].detach() for _ in range(2)]
    assert float(noisy[0]) == float(noisy[1]) != float(clean)
    assert float(objective.loss_and_metrics(batch, train=False)[0]) == float(clean)
    jloss = JaxCLM(JaxCLMConfig(neftune_alpha=5.0), model=jax_model).loss_and_metrics(
        params, {k: jnp.asarray(v) for k, v in host.items()},
        rng=jax.random.fold_in(jax.random.key(9), 3), train=True,
    )[0]
    # fp32: summation order only; bf16: the forward's roundings (one bf16
    # step of the loss)
    rtol = 1e-5 if compute_dtype == "float32" else 2.0**-8
    np.testing.assert_allclose(float(noisy[0]), float(jloss), rtol=rtol)
    with pytest.raises(ValueError, match="key"):
        objective.loss_and_metrics(batch, train=True)


def test_neftune_noise_is_seeded_and_train_only():
    """NEFTune draws `prng.uniform` under the key it is given, as the JAX
    CLM draws `jax.random.uniform`: the same key gives JAX's loss (the
    noise itself is bit for bit JAX's, `test_torch_prng.py`); the same key
    twice gives the same loss; eval is noiseless; training without a key
    raises."""
    _neftune_against_jax("float32")


def test_neftune_noise_bf16_matches_jax():
    """The same in bf16 compute: the noise is drawn in bf16, as JAX draws
    it in the compute dtype."""
    _neftune_against_jax("bfloat16")


def test_from_jax_carries_bf16_params_exactly():
    """fp32 params are carried in the other tests; bf16 ones keep their
    exact values (both JAX layouts share the per-leaf conversion)."""
    _, params = _jax_llama(param_dtype="bfloat16")
    state = state_dict_from_jax(params, LlamaConfig(**{**TINY, "param_dtype": "bfloat16"}))
    q = np.asarray(params["params"]["layers"]["layer"]["self_attn"]["q_proj"]["kernel"][1])
    assert state["model.layers.1.self_attn.q_proj.weight"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        state["model.layers.1.self_attn.q_proj.weight"].float().numpy(), q.astype(np.float32).T
    )


@pytest.mark.parametrize("granularity", ["full", "selective"])
def test_remat_gives_the_same_gradients(granularity):
    _, params = _jax_llama()
    batch = {k: _t(v) for k, v in _packed_batch(np.random.default_rng(5), 2, 32).items()}

    def grads(**overrides):
        model = _port_llama(params, **overrides)
        CLM(CLMConfig(), model=model).loss_and_metrics(batch, train=False)[0].backward()
        return {n: p.grad for n, p in model.named_parameters()}

    base = grads()
    other = grads(enable_gradient_checkpointing=True, recompute_granularity=granularity)
    for name, g in base.items():
        torch.testing.assert_close(other[name], g, rtol=1e-6, atol=1e-7, msg=name)


def test_selective_policy_saves_only_the_flash_forward():
    from torch.utils.checkpoint import CheckpointPolicy

    assert remat._selective_policy(None, torch.ops.llm_training_tpu_torch.flash_fwd.default) \
        == CheckpointPolicy.MUST_SAVE
    assert remat._selective_policy(None, torch.ops.aten.mm.default) \
        == CheckpointPolicy.PREFER_RECOMPUTE
    assert remat.remat_policy(LlamaConfig(**TINY)) is None


# ---------------------------------------------------------------- schedules and optimizers


@pytest.mark.parametrize("name", ["constant", "cosine", "linear"])
@pytest.mark.parametrize("warmup", [0, 4])
@pytest.mark.parametrize("ratio", [0.0, 0.1])
def test_lr_schedule_matches_optax(name, warmup, ratio):
    kw = dict(lr_scheduler=name, learning_rate=3e-3, warmup_steps=warmup, min_lr_ratio=ratio)
    ours = build_lr_schedule(OptimConfig(**kw), 25)
    theirs = jax_schedule(JaxOptimConfig(**kw), 25)
    for step in range(32):
        # optax evaluates in fp32: near the end of a decay the relative error
        # grows, so the floor is a millionth of the peak
        np.testing.assert_allclose(ours(step), float(theirs(step)), rtol=1e-6, atol=3e-9)


PARAM_SHAPES = {
    "model.embed_tokens.weight": (6, 4),
    "model.layers.0.mlp.up_proj.weight": (3, 4),
    "model.norm.weight": (4,),
}


def _run_optimizers(optim: dict, frozen, accumulate=1, updates=6, with_state=False):
    """`updates` micro-steps of seeded gradients (large enough to clip)
    through the port's optimizer and the JAX chain; returns both params
    (and, `with_state`, the port's optimizer and the optax state)."""
    rng = np.random.default_rng(6)
    init = {n: rng.standard_normal(s).astype(np.float32) for n, s in PARAM_SHAPES.items()}
    grads = [{n: (3 * rng.standard_normal(s)).astype(np.float32) for n, s in PARAM_SHAPES.items()}
             for _ in range(updates)]
    named = [(n, torch.nn.Parameter(_t(v))) for n, v in init.items()]
    opt, _ = build_optimizer(OptimConfig(**optim), 10, named, frozen, accumulate)
    tx, _ = jax_optimizer(JaxOptimConfig(**optim), 10, frozen)
    if accumulate > 1:
        tx = optax.MultiSteps(tx, accumulate)
    params = {n: jnp.asarray(v) for n, v in init.items()}
    state = tx.init(params)
    for g in grads:
        for name, p in named:
            p.grad = _t(g[name])
        opt.update()
        upd, state = tx.update({n: jnp.asarray(v) for n, v in g.items()}, state, params)
        params = optax.apply_updates(params, upd)
    out = {n: p.detach().numpy() for n, p in named}, {n: np.asarray(v) for n, v in params.items()}
    return (*out, opt, state) if with_state else out


def _assert_state_is_optax_leaves(opt, jax_state, frozen) -> None:
    """The port's per-parameter optimizer state, counted as tensors and as
    elements, equals optax's parameter-shaped leaves: `optax.masked` holds
    an empty `MaskedNode` where a parameter is frozen, so no `mu`, `nu` or
    `trace` exists for it; `MultiSteps`' accumulator covers every one."""
    leaves = [np.asarray(x) for x in jax.tree.leaves(jax_state) if np.ndim(x) > 0]
    ours = {k: t for k, t in opt.state_dict().items() if k not in ("count", "mini_step")}
    assert len(ours) == len(leaves)
    assert sum(t.numel() for t in ours.values()) == sum(x.size for x in leaves)
    for name in PARAM_SHAPES:
        if frozen and frozen[0] in name:
            assert not [k for k in ours if k.endswith(name) and not k.startswith("acc.")], name


@pytest.mark.parametrize("optim,frozen", [
    (dict(optimizer="adamw", learning_rate=1e-2), None),
    (dict(optimizer="adamw", learning_rate=1e-2, warmup_steps=2), ["embed_tokens"]),
    (dict(optimizer="adamw", learning_rate=1e-2, grad_clip_norm=None,
          optimizer_kwargs={"b2": 0.95, "weight_decay": 0.1, "eps": 1e-6}), None),
    (dict(optimizer="adam", learning_rate=1e-2, lr_scheduler="linear"), ["norm"]),
    (dict(optimizer="sgd", learning_rate=5e-2), ["up_proj"]),
    (dict(optimizer="sgd", learning_rate=5e-2, optimizer_kwargs={"momentum": 0.9}), None),
    (dict(optimizer="sgd", learning_rate=5e-2,
          optimizer_kwargs={"momentum": 0.9, "nesterov": True}), None),
], ids=["adamw", "adamw_warmup_frozen", "adamw_kwargs_noclip", "adam_linear_frozen",
        "sgd_frozen", "sgd_momentum", "sgd_nesterov"])
def test_optimizer_matches_optax(optim, frozen):
    ours, theirs, opt, jax_state = _run_optimizers(optim, frozen, with_state=True)
    _assert_state_is_optax_leaves(opt, jax_state, frozen)
    for name in PARAM_SHAPES:
        np.testing.assert_allclose(ours[name], theirs[name], rtol=1e-5, atol=1e-6, err_msg=name)
    if frozen:
        frozen_name = next(n for n in PARAM_SHAPES if frozen[0] in n)
        np.testing.assert_array_equal(ours[frozen_name], _run_optimizers(optim, frozen, updates=0)[0][frozen_name])


@pytest.mark.parametrize("optim", [
    dict(optimizer="adamw", learning_rate=1e-2, warmup_steps=1),
    dict(optimizer="sgd", learning_rate=5e-2, optimizer_kwargs={"momentum": 0.9}),
], ids=["adamw", "sgd_momentum"])
def test_frozen_accumulation_state_matches_optax_leaves(optim):
    """With accumulation and a frozen parameter: the parameters follow
    optax.MultiSteps over the masked chain, the moments cover the trainable
    parameters only and the accumulator all of them, as optax's leaves."""
    frozen = ["embed_tokens"]
    ours, theirs, opt, jax_state = _run_optimizers(optim, frozen, accumulate=3, updates=7,
                                                   with_state=True)
    _assert_state_is_optax_leaves(opt, jax_state, frozen)
    assert sorted(k.split(".")[0] for k in opt.state_dict() if "embed_tokens" in k) == ["acc"]
    for name in PARAM_SHAPES:
        np.testing.assert_allclose(ours[name], theirs[name], rtol=1e-5, atol=1e-6, err_msg=name)


def test_update_allocates_no_gradient_for_a_parameter_without_one():
    """A frozen parameter that requires no gradient (DPO's reference) gets
    no zero gradient from `update()`, with or without accumulation: its
    accumulator stays zero and no state or `.grad` is made for it."""
    for accumulate in (1, 2):
        live = torch.nn.Parameter(torch.ones(3))
        frozen = torch.nn.Parameter(torch.ones(4), requires_grad=False)
        opt, _ = build_optimizer(OptimConfig(lr_scheduler="constant"), 4,
                                 [("policy.w", live), ("ref.w", frozen)], ["^ref/"], accumulate)
        for _ in range(2 * accumulate):
            live.grad = torch.full((3,), 0.5)
            opt.update()
            assert frozen.grad is None
        assert torch.equal(frozen, torch.ones(4)) and not torch.equal(live, torch.ones(3))
        keys = set(opt.state_dict())
        assert {"mu.policy.w", "nu.policy.w"} <= keys and not {"mu.ref.w", "nu.ref.w"} & keys
        assert ("acc.ref.w" in keys) == (accumulate > 1)
        if accumulate > 1:
            assert not opt.state_dict()["acc.ref.w"].any()


def test_jax_masked_state_carried_into_port():
    """A JAX state of a tiny Llama with `frozen_modules` under MultiSteps
    (moments masked for the frozen embedding) becomes the port's
    TrainState: exactly its keys, the same values."""
    from llm_training_tpu_torch.models.llama.from_jax import train_state_dict_from_jax

    _, params = _jax_llama()
    frozen = ["embed_tokens"]
    tx = optax.MultiSteps(jax_optimizer(JaxOptimConfig(**OPTIM), STEPS, frozen)[0], 2)
    state = tx.init(params)
    rng = np.random.default_rng(13)
    for _ in range(3):
        grads = jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(x.shape), x.dtype), params)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
    adam = next(x for x in jax.tree.leaves(
        state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(x, optax.ScaleByAdamState))
    params, adam, acc = jax.device_get((params, adam, state.acc_grads))
    config = LlamaConfig(**TINY)
    carried = train_state_dict_from_jax(
        config, params=params, step=3, rng=np.asarray([0, 7], np.uint32), count=int(adam.count),
        mu=adam.mu, nu=adam.nu, acc_grads=acc, mini_step=int(state.mini_step))
    trainer = Trainer(TrainerConfig(max_steps=STEPS, accumulate_grad_batches=2), device="cpu")
    objective = CLM(CLMConfig(optim=OptimConfig(**OPTIM), frozen_modules=frozen),
                    model=Llama(config, device="cpu"))
    port_state, _ = trainer.init_state(objective)
    assert set(carried) == set(port_state.state_dict())
    port_state.load_state_dict(carried)
    assert not any(k.startswith(("optimizer.mu.model.embed", "optimizer.nu.model.embed"))
                   for k in carried)
    for name, tensor in port_state.state_dict().items():
        assert torch.equal(tensor, carried[name]), name


def test_accumulation_matches_optax_multisteps():
    ours, theirs = _run_optimizers(dict(optimizer="adamw", learning_rate=1e-2, warmup_steps=1),
                                   None, accumulate=3, updates=7)
    for name in PARAM_SHAPES:
        np.testing.assert_allclose(ours[name], theirs[name], rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("scan", [True, False], ids=["scanned", "looped"])
@pytest.mark.parametrize("pattern", [
    "mlp/up_proj/kernel",
    "params/layers/layer/self_attn",
    "layers_0/",
    r"layers_1/self_attn/(q|k)_proj/kernel",
    "embed_tokens|(^|/)norm/weight",
    r"model\.layers\.0\.mlp\.",
    "no_such_module",
], ids=["kernel_path", "scanned_path", "layers_0", "looped_regex", "embed_and_norm",
        "port_dotted_name", "matches_nothing"])
def test_frozen_modules_match_jax(scan, pattern):
    """`frozen_modules` freezes exactly the parameters `_freeze_mask` freezes
    in the JAX tree of the same layout (`scan_layers`; scanned: one leaf for
    all layers, looped: `layers_{i}`): a path of the other layout, and a
    pattern in the port's own dotted names, freeze nothing, as in JAX."""
    from llm_training_tpu.optim.builder import _freeze_mask
    from llm_training_tpu_torch.models.llama.from_jax import jax_leaf

    jax_model = JaxLlama(JaxLlamaConfig(**TINY, scan_layers=scan, attention_impl="xla"))
    variables = nn.meta.unbox(
        jax.eval_shape(jax_model.init, jax.random.key(0), np.zeros((1, 4), np.int32))
    )
    trainable = _freeze_mask(variables, [pattern])["params"]
    model = Llama(LlamaConfig(**TINY, scan_layers=scan), device="meta")
    named = list(model.named_parameters())
    expected = set()
    for name, _ in named:
        layer, keys = jax_leaf(name)
        if layer is not None:
            node = trainable["layers"]["layer"] if scan else trainable[f"layers_{layer}"]
        else:
            node = trainable
        for key in keys:
            node = node[key]
        if not node:
            expected.add(name)
    opt, _ = build_optimizer(OptimConfig(optimizer="sgd"), 4, named, [pattern],
                             scan_layers=scan)
    frozen = {name for (name, _), flag in zip(named, opt.trainable) if not flag}
    assert frozen == expected, (sorted(frozen), sorted(expected))
    # through the Trainer, which takes the layout from the objective's model config
    trainer = Trainer(TrainerConfig(max_steps=4), device="cpu")
    objective = CLM(CLMConfig(optim=OptimConfig(optimizer="sgd"), frozen_modules=[pattern]),
                    model=Llama(LlamaConfig(**TINY, scan_layers=scan), device="cpu"))
    state, _ = trainer.init_state(objective)
    frozen = {name for name, flag in zip(state.optimizer.names, state.optimizer.trainable)
              if not flag}
    assert frozen == expected, (sorted(frozen), sorted(expected))


def test_adamw_default_weight_decay_is_optax_not_torch():
    """Empty optimizer_kwargs: optax decays by 1e-4 (torch.optim.AdamW by
    1e-2). With a zero gradient only the decay moves the parameter."""
    p = torch.nn.Parameter(torch.ones(3))
    opt, _ = build_optimizer(OptimConfig(lr_scheduler="constant", learning_rate=0.5), 1, [("w", p)])
    p.grad = torch.zeros(3)
    opt.update()
    np.testing.assert_allclose(p.detach().numpy(), 1 - 0.5 * 1e-4, rtol=1e-7)


# ---------------------------------------------------------------- data


def test_packing_matches_jax():
    rng = np.random.default_rng(7)
    lengths = rng.integers(1, 40, 50).tolist()
    assert packing.best_fit_bin_packing_py(64, lengths) == jax_bfp(64, lengths)
    docs = {"source": [["a", "b"][i % 2] for i in range(30)],
            "input_ids": [rng.integers(0, 99, n).tolist() for n in lengths[:30]],
            "length": lengths[:30]}
    assert packing.best_fit_decreasing(docs, 64) == jax_bfd(docs, 64)
    with pytest.raises(ValueError, match="capacity"):
        packing.best_fit_bin_packing_py(8, [9])


@pytest.mark.parametrize("side,multiple,bos", [("right", None, 1), ("left", 8, None), ("right", 16, None)])
def test_collator_matches_jax(side, multiple, bos):
    rng = np.random.default_rng(8)
    examples = []
    for n in (5, 11, 7):
        ids = rng.integers(0, 50, n)
        ids[0] = 1
        examples.append({"input_ids": ids.tolist(), "segment_ids": [1] * 3 + [2] * (n - 3)})
    tokenizer = types.SimpleNamespace(pad_token_id=0, bos_token_id=bos)
    config = types.SimpleNamespace(tokenizer=tokenizer, pad_to_multiple_of=multiple)
    ours = PreTrainingDataCollator(config, side)(examples)
    theirs = JaxCollator(config, side)(examples)
    assert ours.keys() == theirs.keys()
    for key in ours:
        np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)


def test_dummy_datamodule_matches_jax():
    kw = dict(batch_size=4, max_length=16, num_samples=40, validation_split=8, vocab_size=64, seed=3)
    ours, theirs = DummyDataModule(DummyDataModuleConfig(**kw)), JaxDummy(JaxDummyConfig(**kw))
    ours.setup()
    theirs.setup()
    for a, b in zip(list(zip(range(12), ours.train_batches(start_step=2))),
                    list(zip(range(12), theirs.train_batches(start_step=2)))):
        for key in a[1]:
            np.testing.assert_array_equal(a[1][key], b[1][key])
    for a, b in zip(ours.val_batches(), theirs.val_batches()):
        np.testing.assert_array_equal(a["input_ids"], b["input_ids"])


# ---------------------------------------------------------------- the slice: fit


class _Batches(BaseDataModule):
    """A fixed list of host batches, served in order."""

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


STEPS = 20
OPTIM = dict(learning_rate=2e-3, warmup_steps=3, min_lr_ratio=0.1, grad_clip_norm=1.0,
             optimizer_kwargs={"b2": 0.95, "weight_decay": 0.1})


def _jax_fit(jax_model, params, batches, accumulate, neftune_alpha=None, seed=42):
    """The JAX CLM under the JAX build_optimizer chain (and optax.MultiSteps
    for accumulation), the step of `test_loss_parity.py`; micro-step n draws
    under fold_in(key(seed + 1), n), as the JAX trainer's step does. Returns
    the loss of each optimizer step's last micro-batch."""
    objective = JaxCLM(JaxCLMConfig(neftune_alpha=neftune_alpha), model=jax_model)
    tx, _ = jax_optimizer(JaxOptimConfig(**OPTIM), STEPS)
    if accumulate > 1:
        tx = optax.MultiSteps(tx, accumulate)
    state = tx.init(params)
    base = jax.random.key(seed + 1)

    @jax.jit
    def step(params, state, batch, micro):
        rng = jax.random.fold_in(base, micro)
        loss_fn = lambda p: objective.loss_and_metrics(p, batch, rng=rng, train=True)[0]  # noqa: E731
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state, loss

    losses = []
    for micro, batch in enumerate(batches):
        params, state, loss = step(params, state, {k: jnp.asarray(v) for k, v in batch.items()},
                                   jnp.int32(micro))
        losses.append(float(loss))
    return losses[accumulate - 1::accumulate]


@pytest.mark.parametrize("accumulate", [1, 2])
def test_fit_matches_jax(accumulate):
    """20 optimizer steps of a tiny Llama on the same packed batches from
    the same params: step-0 loss within 1e-5, the trajectory within rtol
    1e-4."""
    jax_model, params = _jax_llama(seed=1)
    rng = np.random.default_rng(9)
    distinct = [_packed_batch(rng, 2, 32) for _ in range(4)]  # repeated, so the loss falls
    batches = [distinct[i % 4] for i in range(STEPS * accumulate)]
    expected = _jax_fit(jax_model, params, batches, accumulate)
    recorder = _Losses()
    trainer = Trainer(
        TrainerConfig(max_steps=STEPS, accumulate_grad_batches=accumulate, log_every_n_steps=1),
        callbacks=[recorder], device="cpu",
    )
    objective = CLM(CLMConfig(optim=OptimConfig(**OPTIM)), model=_port_llama(params))
    trainer.fit(objective, _Batches(batches))
    assert abs(recorder.losses[0] - expected[0]) < 1e-5
    np.testing.assert_allclose(recorder.losses, expected, rtol=1e-4)
    assert recorder.losses[-1] < recorder.losses[0]


@pytest.mark.parametrize("accumulate", [1, 2])
def test_fit_with_neftune_matches_jax(accumulate):
    """The same 20-step fit with NEFTune noise: the port's trainer derives
    micro-step n's key as fold_in(key(seed + 1), n) and the CLM draws the
    noise as the JAX CLM does, so the trajectory stays within rtol 1e-4 of
    JAX's, with and without accumulation (a different noise stream would
    move it by far more)."""
    jax_model, params = _jax_llama(seed=1)
    rng = np.random.default_rng(9)
    distinct = [_packed_batch(rng, 2, 32) for _ in range(4)]
    batches = [distinct[i % 4] for i in range(STEPS * accumulate)]
    expected = _jax_fit(jax_model, params, batches, accumulate, neftune_alpha=5.0, seed=7)
    recorder = _Losses()
    trainer = Trainer(
        TrainerConfig(max_steps=STEPS, seed=7, accumulate_grad_batches=accumulate,
                      log_every_n_steps=1),
        callbacks=[recorder], device="cpu",
    )
    objective = CLM(CLMConfig(optim=OptimConfig(**OPTIM), neftune_alpha=5.0),
                    model=_port_llama(params))
    trainer.fit(objective, _Batches(batches))
    assert abs(recorder.losses[0] - expected[0]) < 1e-5
    np.testing.assert_allclose(recorder.losses, expected, rtol=1e-4)
    plain = _jax_fit(jax_model, params, batches, accumulate)
    assert max(abs(a - b) for a, b in zip(expected, plain)) > 1e-3  # the noise moves it


def test_cli_fit_on_cpu(tmp_path):
    """`fit --config cpu-smoke.json --device cpu` writes metrics.jsonl with a
    falling loss and a validation loss, rc 0."""
    rc = cli_main(["fit", "--config", CONFIG_FILE, "--device", "cpu", f"run_root={tmp_path}"])
    assert rc == 0
    run_dir = tmp_path / "smoke" / "cpu-smoke"
    rows = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    losses = [r["loss"] for r in rows if "loss" in r]
    assert [r["step"] for r in rows if "loss" in r] == [2, 4, 6]
    assert losses[-1] < losses[0]
    assert any("val_loss" in r for r in rows)
    assert {"grad_norm", "lr", "target_tokens", "consumed_tokens"} <= set(rows[0])
    assert json.loads((run_dir / "config.json").read_text())["run_root"] == str(tmp_path)


def test_fit_without_cuda_raises(tmp_path):
    """Without --device cpu, fit asks for CUDA and raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: fit would run on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_main(["fit", "--config", CONFIG_FILE, f"run_root={tmp_path}"])


def test_config_rejects_unknown_fields(tmp_path):
    # a trainer field of the JAX package that the port does not have yet
    with pytest.raises(ValueError, match="mesh"):
        cli_main(["fit", "--config", CONFIG_FILE, "--device", "cpu", f"run_root={tmp_path}",
                  "trainer.mesh={}"])
