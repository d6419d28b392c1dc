"""Port parity of the optimizer surface on the CPU: the block-quantized
storage codec against `llm_training_tpu/optim/quantized_state.py`, Lion
and Adafactor against optax (through the JAX `build_optimizer` chain),
the offloaded state's placement and validation, and `from_jax`'s
carry-over of their state. The same numpy inputs go to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from llm_training_tpu.optim import quantized_state as jq
from llm_training_tpu.optim.builder import OptimConfig as JaxOptimConfig
from llm_training_tpu.optim.builder import build_optimizer as jax_optimizer
from llm_training_tpu_torch.optim import quantized_state as tq
from llm_training_tpu_torch.optim.builder import OptimConfig, build_optimizer

# fp32 updates: summation order and fused multiply-adds only
UPDATE_TOL = dict(rtol=1e-5, atol=1e-6)


def _codec_inputs(kind: str, case: str, shape=(6, 512)) -> np.ndarray:
    rng = np.random.default_rng(["sym", "sqrt"].index(kind))
    if case == "zeros":
        return np.zeros(shape, np.float32)
    if case == "tiny":  # small positive second moments
        x = 10.0 ** rng.uniform(-30, -20, shape)
    elif case == "subnormal":
        x = 10.0 ** rng.uniform(-44, -30, shape)
    elif kind == "sym":
        x = rng.standard_normal(shape) * 10.0 ** rng.uniform(-6, 2, (shape[0], 1))
    else:  # a high dynamic range within a block: the dangerous case for sqrt
        x = 10.0 ** rng.uniform(-12, 1, shape)
    x = x.astype(np.float32)
    x[0, :256] = 0.0  # an all-zero block beside live ones
    x[1, 3] = 0.0
    return x


@pytest.mark.parametrize("case", ["random", "zeros", "tiny"])
@pytest.mark.parametrize("kind", ["sym", "sqrt"])
def test_codec_matches_jax_bit_for_bit(kind, case):
    """Codes, scales and the dequantized values equal JAX's bit for bit,
    along the last axis and, for the port's [out, in] layout of a Dense
    weight, along dim 0 (the transpose of JAX's [in, out])."""
    x = _codec_inputs(kind, case)
    ref = jq.quantize_array(jnp.asarray(x), kind, 256)
    ref_q, ref_scale = np.asarray(ref.q), np.asarray(ref.scale)
    got = tq.quantize_array(torch.from_numpy(x), kind, 256)
    np.testing.assert_array_equal(got.q.numpy(), ref_q)
    np.testing.assert_array_equal(got.scale.numpy(), ref_scale)
    np.testing.assert_array_equal(tq.dequantize_array(got).numpy(),
                                  np.asarray(jq.dequantize_array(ref)))
    # the port's transposed layout, blocked along dim 0
    got_t = tq.quantize_array(torch.from_numpy(np.ascontiguousarray(x.T)), kind, 256, axis=0)
    np.testing.assert_array_equal(got_t.q.numpy(), ref_q.T)
    np.testing.assert_array_equal(got_t.scale.numpy(), ref_scale.T)
    np.testing.assert_array_equal(tq.dequantize_array(got_t).numpy(),
                                  np.asarray(jq.dequantize_array(ref)).T)
    assert got.q.dtype == (torch.int8 if kind == "sym" else torch.uint8)


def test_sqrt_codec_keeps_subnormal_second_moments():
    """Where the codes differ from JAX's, and why: XLA's CPU runtime
    flushes float32 subnormals to zero, so JAX encodes a subnormal positive
    second moment as code 0 (decoding to 0, the case its floor at code 1
    exists to prevent); torch keeps subnormals, and the port's code is >= 1
    there. Every other code and every scale is equal."""
    x = _codec_inputs("sqrt", "subnormal")
    ref = jq.quantize_array(jnp.asarray(x), "sqrt", 256)
    got = tq.quantize_array(torch.from_numpy(x), "sqrt", 256)
    ref_q, got_q = np.asarray(ref.q), got.q.numpy()
    subnormal = (x > 0) & (x < np.finfo(np.float32).tiny)
    differ = got_q != ref_q
    assert differ.sum() == 1236 and (differ <= subnormal).all(), (differ.sum(), subnormal.sum())
    assert (ref_q[differ] == 0).all() and (got_q[differ] >= 1).all()
    assert (got_q[x > 0] >= 1).all()
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))


@pytest.mark.parametrize("kind", ["sym", "sqrt"])
def test_codec_is_grid_idempotent(kind):
    """decode -> encode is a fixed point, so re-encoding a state the update
    did not touch (JAX's serialized path, on every accumulation micro-step)
    gives the codes that skipping it keeps."""
    qa = tq.quantize_array(torch.from_numpy(_codec_inputs(kind, "random", (4, 1024))), kind, 256)
    for cycle in range(10):
        again = tq.quantize_array(tq.dequantize_array(qa), kind, 256)
        assert torch.equal(again.q, qa.q), f"codes drifted at cycle {cycle}"
        assert torch.equal(again.scale, qa.scale), f"scales drifted at cycle {cycle}"
        qa = again


def test_sqrt_codec_never_underestimates_nor_zeroes():
    """Ceil rounding: the decoded second moment is not under the true one
    by more than the 5e-4-step slack, and a positive one never decodes to
    0 (Adam's step would grow by sqrt(nu) / eps)."""
    x = _codec_inputs("sqrt", "random", (8, 512))
    qa = tq.quantize_array(torch.from_numpy(x), "sqrt", 256)
    dec = tq.dequantize_array(qa).numpy()
    step = np.repeat(qa.scale.numpy(), 256, axis=-1)
    assert (np.sqrt(dec) >= np.sqrt(x) - 1e-3 * step).all()
    assert (dec[x > 0] > 0).all()


def _adam_state(block: int):
    """An optax adamw state (under MultiSteps) of a tree with an eligible
    leaf, a leaf named like a state field, and an ineligible one."""
    rng = np.random.default_rng(5)
    params = {"w": jnp.zeros((4, 2 * block)), "v": jnp.zeros((2, block)), "tiny": jnp.zeros((7,))}
    tx = optax.MultiSteps(optax.adamw(1e-3), 2)
    state = tx.init(params)
    for _ in range(3):
        grads = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32),
                             params)
        _, state = tx.update(grads, state, params)
    adam = state.inner_opt_state[0]
    flat = {}
    for field, tree in (("mu", adam.mu), ("nu", adam.nu), ("acc", state.acc_grads)):
        flat.update({f"{field}.{k}": np.array(v) for k, v in tree.items()})
    return state, flat


def test_encode_state_routes_fields_like_jax():
    """The whitelist: mu (sym) and nu (sqrt) are encoded, a parameter named
    like a field does not change its codec, an ineligible shape and the
    MultiSteps accumulator stay exact float32; the codes equal JAX's; the
    bfloat16 cast applies to the same fields."""
    state, flat = _adam_state(16)
    ref = jq.encode_state(state, block=16)
    ref_adam = ref.inner_opt_state[0]
    got = tq.encode_state({k: torch.from_numpy(v) for k, v in flat.items()}, block=16)
    for field, tree in (("mu", ref_adam.mu), ("nu", ref_adam.nu)):
        for name in ("w", "v"):
            assert isinstance(tree[name], jq.QuantArray)
            entry = got[f"{field}.{name}"]
            assert entry.kind == tree[name].kind == ("sym" if field == "mu" else "sqrt")
            np.testing.assert_array_equal(entry.q.numpy(), np.asarray(tree[name].q))
            np.testing.assert_array_equal(entry.scale.numpy(), np.asarray(tree[name].scale))
        assert not isinstance(tree["tiny"], jq.QuantArray)
        assert isinstance(got[f"{field}.tiny"], torch.Tensor)
    for name in ("w", "v", "tiny"):
        assert isinstance(got[f"acc.{name}"], torch.Tensor)
        np.testing.assert_array_equal(got[f"acc.{name}"].numpy(),
                                      np.asarray(ref.acc_grads[name]))
    decoded = tq.decode_state(got)
    np.testing.assert_array_equal(decoded["mu.w"].numpy(),
                                  np.asarray(jq.decode_state(ref).inner_opt_state[0].mu["w"]))
    cast = tq.cast_state({k: torch.from_numpy(v) for k, v in flat.items()}, torch.bfloat16)
    ref_cast = jq.cast_state(state, jnp.bfloat16)
    assert cast["mu.w"].dtype == torch.bfloat16 and cast["acc.w"].dtype == torch.float32
    np.testing.assert_array_equal(cast["nu.w"].float().numpy(),
                                  np.asarray(ref_cast.inner_opt_state[0].nu["w"], np.float32))
    assert ref_cast.acc_grads["w"].dtype == jnp.float32


# ---------------------------------------------------------------- lion, adafactor

L = 3  # layers of the scanned stacks below
# the port's parameters (torch layout) of a Llama-shaped tree: Dense
# weights [out, in], norms, the embedding [V, h] and lm_head [V, h]
PORT_SHAPES = {"model.embed_tokens.weight": (40, 16), "model.norm.weight": (16,),
               "lm_head.weight": (40, 16)}
for _i in range(L):
    PORT_SHAPES.update({
        f"model.layers.{_i}.mlp.up_proj.weight": (24, 16),
        f"model.layers.{_i}.self_attn.k_proj.weight": (2, 16),
        f"model.layers.{_i}.input_layernorm.weight": (16,),
    })


def _jax_tree(port: dict[str, np.ndarray]) -> dict:
    """The same values in the JAX package's scanned tree: Dense kernels
    transposed to [in, out], each layer parameter stacked to [L, ...]."""
    stack = lambda key: np.stack([port[f"model.layers.{i}.{key}"] for i in range(L)])  # noqa: E731
    return {"params": {
        "embed_tokens": {"embedding": port["model.embed_tokens.weight"]},
        "norm": {"weight": port["model.norm.weight"]},
        "lm_head": {"kernel": port["lm_head.weight"].T},
        "layers": {"layer": {
            "mlp": {"up_proj": {"kernel": stack("mlp.up_proj.weight").transpose(0, 2, 1)}},
            "self_attn": {"k_proj": {"kernel": stack("self_attn.k_proj.weight").transpose(0, 2, 1)}},
            "input_layernorm": {"weight": stack("input_layernorm.weight")},
        }},
    }}


def _port_from_tree(tree: dict) -> dict[str, np.ndarray]:
    p = tree["params"]
    out = {"model.embed_tokens.weight": p["embed_tokens"]["embedding"],
           "model.norm.weight": p["norm"]["weight"], "lm_head.weight": p["lm_head"]["kernel"].T}
    layer = p["layers"]["layer"]
    for i in range(L):
        out[f"model.layers.{i}.mlp.up_proj.weight"] = layer["mlp"]["up_proj"]["kernel"][i].T
        out[f"model.layers.{i}.self_attn.k_proj.weight"] = layer["self_attn"]["k_proj"]["kernel"][i].T
        out[f"model.layers.{i}.input_layernorm.weight"] = layer["input_layernorm"]["weight"][i]
    return {k: np.asarray(v) for k, v in out.items()}


def _run_layouts(optim: dict, updates=5, accumulate=1):
    """`updates` micro-steps of seeded gradients through the port's
    optimizer (torch layout) and the JAX chain (scanned JAX layout).
    Returns the port's parameters, JAX's (as the port's), the port's
    optimizer and optax's state."""
    rng = np.random.default_rng(11)
    init = {n: rng.standard_normal(s).astype(np.float32) for n, s in PORT_SHAPES.items()}
    grads = [{n: (2 * rng.standard_normal(s)).astype(np.float32) for n, s in PORT_SHAPES.items()}
             for _ in range(updates)]
    named = [(n, torch.nn.Parameter(torch.from_numpy(v.copy()))) for n, v in init.items()]
    opt, _ = build_optimizer(OptimConfig(**optim), 10, named, accumulate=accumulate)
    tx, _ = jax_optimizer(JaxOptimConfig(**optim), 10)
    if accumulate > 1:
        tx = optax.MultiSteps(tx, accumulate)
    params = jax.tree.map(jnp.asarray, _jax_tree(init))
    state = tx.init(params)
    for g in grads:
        for name, p in named:
            p.grad = torch.from_numpy(g[name].copy())
        opt.update()
        updates_, state = tx.update(jax.tree.map(jnp.asarray, _jax_tree(g)), state, params)
        params = optax.apply_updates(params, updates_)
    ours = {n: p.detach().numpy() for n, p in named}
    return ours, _port_from_tree(jax.device_get(params)), opt, jax.device_get(state)


LION = [
    dict(optimizer="lion", learning_rate=1e-2),
    dict(optimizer="lion", learning_rate=1e-2, warmup_steps=2, grad_clip_norm=None,
         optimizer_kwargs={"b1": 0.8, "b2": 0.95, "weight_decay": 0.1}),
]


@pytest.mark.parametrize("optim", LION, ids=["defaults", "kwargs"])
def test_lion_matches_optax(optim):
    ours, theirs, opt, _ = _run_layouts(optim)
    for name in PORT_SHAPES:
        np.testing.assert_allclose(ours[name], theirs[name], **UPDATE_TOL, err_msg=name)
    assert sorted({k.split(".")[0] for k in opt.state_dict()}) == ["count", "mini_step", "mu"]


ADAFACTOR = {
    # the stacks [L, in, out] and the 2-D leaves factor; the norm stacks
    # [L, 16] do not (L = 3 < 8), nor the 1-D final norm
    "factored": dict(optimizer="adafactor", learning_rate=1e-2,
                     optimizer_kwargs={"min_dim_size_to_factor": 8}),
    "momentum_decay": dict(optimizer="adafactor", learning_rate=1e-2, warmup_steps=2,
                           optimizer_kwargs={"min_dim_size_to_factor": 8, "momentum": 0.9,
                                             "weight_decay_rate": 1e-2}),
    "no_param_scale": dict(optimizer="adafactor", learning_rate=1e-2,
                           optimizer_kwargs={"min_dim_size_to_factor": 8,
                                             "multiply_by_parameter_scale": False,
                                             "clipping_threshold": None, "decay_rate": 0.7}),
    # L becomes a factored axis: the norm stacks [3, 16] and the k_proj
    # stacks [3, 16, 2] couple their layers through v_col / v_row
    "stack_axis_factored": dict(optimizer="adafactor", learning_rate=1e-2,
                                optimizer_kwargs={"min_dim_size_to_factor": 2}),
    "unfactored": dict(optimizer="adafactor", learning_rate=1e-2,
                       optimizer_kwargs={"factored": False, "eps": 1e-20}),
    "defaults": dict(optimizer="adafactor", learning_rate=1e-2),
}


def _adafactor_leaves(state) -> dict[str, dict]:
    """optax's FactoredState / EmaState trees, by field."""
    out = {}
    for node in jax.tree.leaves(state, is_leaf=lambda x: isinstance(
            x, (optax.FactoredState, optax.EmaState))):
        if isinstance(node, optax.FactoredState):
            out.update(v_row=node.v_row, v_col=node.v_col, v=node.v)
        elif isinstance(node, optax.EmaState):
            out["ema"] = node.ema
    return out


@pytest.mark.parametrize("case", list(ADAFACTOR))
def test_adafactor_matches_optax(case):
    """Adafactor over the JAX layout: the parameters after 5 updates, and
    each state tensor, named by its JAX leaf, equal to optax's leaf in
    optax's shape (the (1,) placeholders of the unused side included)."""
    ours, theirs, opt, state = _run_layouts(ADAFACTOR[case])
    assert all(np.isfinite(v).all() for v in ours.values())
    for name in PORT_SHAPES:
        np.testing.assert_allclose(ours[name], theirs[name], **UPDATE_TOL, err_msg=name)
    live = opt.state_dict()
    leaves = {"model.embed_tokens.weight": ("embed_tokens", "embedding"),
              "model.norm.weight": ("norm", "weight"), "lm_head.weight": ("lm_head", "kernel"),
              "model.layers.*.mlp.up_proj.weight": ("layers", "layer", "mlp", "up_proj", "kernel"),
              "model.layers.*.self_attn.k_proj.weight":
                  ("layers", "layer", "self_attn", "k_proj", "kernel"),
              "model.layers.*.input_layernorm.weight":
                  ("layers", "layer", "input_layernorm", "weight")}
    expected = {}
    for field, tree in _adafactor_leaves(state).items():
        for leaf, path in leaves.items():
            node = tree["params"]
            for key in path:
                node = node[key]
            expected[f"{field}.{leaf}"] = np.asarray(node)
    assert set(expected) == set(live) - {"count", "mini_step"}
    for key, value in expected.items():
        assert value.shape == tuple(live[key].shape), key
        # fp32 sums in another order: relative to the tensor's largest value
        np.testing.assert_allclose(live[key].numpy(), value, rtol=1e-5,
                                   atol=1e-6 * np.abs(value).max(), err_msg=key)
    if case == "factored":  # the stacks factor over [in, out], the norm stacks not at all
        assert live["v_row.model.layers.*.mlp.up_proj.weight"].shape == (L, 16)
        assert live["v_col.model.layers.*.mlp.up_proj.weight"].shape == (L, 24)
        assert live["v.model.layers.*.input_layernorm.weight"].shape == (L, 16)


def test_adafactor_accumulation_matches_optax_multisteps():
    ours, theirs, _, _ = _run_layouts(ADAFACTOR["momentum_decay"], updates=6, accumulate=3)
    for name in PORT_SHAPES:
        np.testing.assert_allclose(ours[name], theirs[name], **UPDATE_TOL, err_msg=name)


# ---------------------------------------------------------------- offload placement


OFFLOAD_CASES = [
    (dict(optimizer="adamw", learning_rate=1e-2), 1),
    (dict(optimizer="adamw", learning_rate=1e-2, warmup_steps=1), 3),
    (dict(optimizer="lion", learning_rate=1e-2), 2),
    (ADAFACTOR["momentum_decay"], 2),
    (dict(optimizer="sgd", learning_rate=1e-2, optimizer_kwargs={"momentum": 0.9}), 1),
]


@pytest.mark.parametrize("optim,accumulate", OFFLOAD_CASES,
                         ids=["adamw", "adamw_acc3", "lion_acc2", "adafactor_acc2", "sgd"])
def test_float32_offload_is_bit_equal(optim, accumulate, monkeypatch):
    """float32 offload is a placement, not other math: the parameters and
    the state equal the on-device run's bit for bit, with large
    parameters cut into row chunks (a chunk of 64 elements here)."""
    from llm_training_tpu_torch.optim import builder

    monkeypatch.setattr(builder, "_CHUNK", 64)
    results = []
    for offload in (False, True):
        rng = np.random.default_rng(3)
        named = [(n, torch.nn.Parameter(torch.from_numpy(rng.standard_normal(s).astype(np.float32))))
                 for n, s in PORT_SHAPES.items()]
        opt, _ = build_optimizer(OptimConfig(**optim), 10, named, accumulate=accumulate,
                                 offload=offload)
        for _ in range(3 * accumulate):
            for _, p in named:
                p.grad = torch.from_numpy((3 * rng.standard_normal(p.shape)).astype(np.float32))
            opt.update()
        results.append(({n: p.detach().clone() for n, p in named}, opt.state_dict()))
        assert opt.store.host_bytes() == (sum(t.nbytes for k, t in opt.state_dict().items()
                                        if k not in ("count", "mini_step")) if offload else 0)
    (p0, s0), (p1, s1) = results
    for name in p0:
        assert torch.equal(p0[name], p1[name]), name
    assert set(s0) == set(s1)
    for key in s0:
        assert torch.equal(s0[key], s1[key]), key


def test_state_dtypes_store_what_jax_stores():
    """Under offload the state is stored as JAX's codec stores it: int8
    codes for mu (sym) and nu (sqrt) of eligible tensors, blocked along
    the JAX array's last axis (the port's dim 0 for a Dense weight);
    float32 for a tensor whose block axis is not a multiple of the block
    and for the accumulator; bfloat16 for every whitelisted field."""
    named = [(n, torch.nn.Parameter(torch.zeros(s))) for n, s in PORT_SHAPES.items()]
    opt, _ = build_optimizer(OptimConfig(), 4, named, accumulate=2, offload=True,
                             state_dtype="int8", quant_block=8)
    state = opt.state_dict()
    # lm_head [V=40, h=16]: JAX kernel [16, 40], blocks of 8 along V
    assert state["mu.lm_head.weight.q"].dtype == torch.int8
    assert state["mu.lm_head.weight.scale"].shape == (5, 16)
    assert state["nu.model.embed_tokens.weight.q"].dtype == torch.uint8
    assert state["nu.model.embed_tokens.weight.scale"].shape == (40, 2)
    # k_proj [2, 16]: its JAX last axis (2) is no multiple of 8
    assert state["mu.model.layers.0.self_attn.k_proj.weight"].dtype == torch.float32
    assert state["acc.lm_head.weight"].dtype == torch.float32
    opt, _ = build_optimizer(OptimConfig(), 4, named, accumulate=2, offload=True,
                             state_dtype="bfloat16")
    dtypes = {k.split(".")[0]: t.dtype for k, t in opt.state_dict().items() if t.ndim}
    assert dtypes == {"mu": torch.bfloat16, "nu": torch.bfloat16, "acc": torch.float32}


# ---------------------------------------------------------------- AdamW's bias correction


@pytest.mark.parametrize("decay", [0.9, 0.999])
def test_bias_correction_is_optax_float32(decay):
    """R2: `1 - decay**t` as optax's `scale_by_adam` computes it, in float32
    from the float32 decay, for t = 1..2000: bit for bit JAX's factor.
    (JAX's float32 `pow` itself differs from the correctly rounded power in
    the last bit at some t, e.g. 0.999**873; `1 -` the power absorbs it.)"""
    from llm_training_tpu_torch.optim.builder import bias_correction

    t = jnp.arange(1, 2001, dtype=jnp.int32)
    want = np.asarray(1 - jnp.float32(decay) ** t)
    got = np.array([bias_correction(decay, int(i)) for i in range(1, 2001)], dtype=np.float32)
    np.testing.assert_array_equal(got, want)
    assert all(float(np.float32(g)) == g for g in map(float, got[:5]))


def test_adamw_default_b2_update_norms_match_optax():
    """R2, C.19's smallest input: AdamW with the default b2 0.999, two
    updates. Each update's global norm is within 1e-6 relative of optax's
    (with the float64 bias correction the second differed by 1.0e-5)."""
    optim = dict(optimizer="adamw", learning_rate=1e-2, lr_scheduler="constant")
    rng = np.random.default_rng(5)
    init = {n: rng.standard_normal(s).astype(np.float32) for n, s in PORT_SHAPES.items()}
    grads = [{n: (0.1 * rng.standard_normal(s)).astype(np.float32) for n, s in PORT_SHAPES.items()}
             for _ in range(2)]
    named = [(n, torch.nn.Parameter(torch.from_numpy(v.copy()))) for n, v in init.items()]
    opt, _ = build_optimizer(OptimConfig(**optim), 10, named)
    assert opt.hyper["b2"] == 0.999
    tx, _ = jax_optimizer(JaxOptimConfig(**optim), 10)
    params = jax.tree.map(jnp.asarray, _jax_tree(init))
    state = tx.init(params)
    for g in grads:
        for name, p in named:
            p.grad = torch.from_numpy(g[name].copy())
        opt.update_sq = {}
        opt.update()
        ours = float(sum(float(sq) for sqs in opt.update_sq.values() for sq in sqs)) ** 0.5
        opt.update_sq = None
        updates, state = tx.update(jax.tree.map(jnp.asarray, _jax_tree(g)), state, params)
        params = optax.apply_updates(params, updates)
        want = float(optax.global_norm(updates))
        assert abs(ours - want) <= 1e-6 * want, (ours, want)
