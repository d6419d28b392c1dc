"""Port parity of the hybrid families (fp32, CPU): Qwen3-Next's gated
DeltaNet, MiniMax's lightning attention and Bamba's Mamba-2 SSD, with their
softmax layers and (Qwen3-Next, MiniMax) their experts
(`tests/torch_hybrid_cases.py`).

- The three chunked scans (`chunk_gated_delta_rule`, `lightning_attention`,
  `mamba2_ssd`) against JAX's on seeded numpy inputs, forward and VJP,
  within 1e-5 of max|JAX|, at a length that is a multiple of the chunk and
  at one that is not; the delta rule and the SSD with `segment_reset_decay`
  too (JAX's lightning attention takes none). Under a reset, JAX's VJP is
  NaN wherever a document starts inside a chunk (its masked exp()
  overflows: ROADMAP C.50); the port's is finite, equal to JAX's at every
  entry JAX gets finite, and at the others to JAX's forward-mode
  derivative of the same function (`jax.jacfwd`: a masked tangent is
  selected away, never multiplied by the overflow).
- Each family's config field for field against JAX's, with its derived
  properties and its published preset.
- Logits (rtol 1e-4, atol 1e-5), the loss, the aux loss and router
  statistics (MoE types), and every parameter's gradient (1e-4 in relative
  norm) against JAX's looped and periodic trees, with random parameters
  carried by `state_dict_from_jax` (the port's MoE through the ragged
  impl, G1's plain version; JAX through its exact dense one).
- With `segment_state_reset` on a packed row whose second document starts
  inside a chunk: JAX's logits (as above), packed and for the second
  document alone, the port's gradients finite and each parameter's along
  a random direction equal to JAX's forward-mode derivative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_hybrid_cases import MOE_TYPES, TYPES, models
from torch_moe_cases import random_params
from torch_threads import one_torch_thread  # noqa: F401

from llm_training_tpu_torch.models.llama.from_jax import jax_path, state_dict_from_jax

TOL = 1e-4
SCAN_TOL = 1e-5
CHUNK = 8


# ---------------------------------------------------------------- the scans


def _delta_rule_inputs(rng, seq):
    b, h = 2, 3
    return [rng.standard_normal((b, seq, h, 8)), rng.standard_normal((b, seq, h, 8)),
            rng.standard_normal((b, seq, h, 6)), -rng.uniform(0.05, 1.0, (b, seq, h)),
            rng.uniform(0.1, 0.9, (b, seq, h))]


def _lightning_inputs(rng, seq):
    b, h = 2, 3
    return [rng.standard_normal((b, seq, h, 8)) * 0.5, rng.standard_normal((b, seq, h, 8)) * 0.5,
            rng.standard_normal((b, seq, h, 8)), rng.uniform(0.05, 0.6, (h,))]


def _ssd_inputs(rng, seq):
    b, h = 2, 3
    return [rng.standard_normal((b, seq, h, 6)), rng.uniform(0.05, 1.0, (b, seq, h)),
            -rng.uniform(0.2, 2.0, (h,)), rng.standard_normal((b, seq, h, 4)),
            rng.standard_normal((b, seq, h, 4))]


def _scan(name):
    """(JAX's function, the port's, the inputs' maker), each function
    called as f(*inputs, reset) with the chunk of 8."""
    if name == "delta_rule":
        from llm_training_tpu.models.qwen3_next.model import chunk_gated_delta_rule as theirs
        from llm_training_tpu_torch.models.qwen3_next.model import chunk_gated_delta_rule as ours

        return (lambda *a, r=None: theirs(*a, chunk_size=CHUNK, reset_decay=r),
                lambda *a, r=None: ours(*a, chunk_size=CHUNK, reset_decay=r), _delta_rule_inputs)
    if name == "lightning":
        from llm_training_tpu.models.minimax.model import lightning_attention as theirs
        from llm_training_tpu_torch.models.minimax.model import lightning_attention as ours

        return (lambda *a, r=None: theirs(*a, CHUNK), lambda *a, r=None: ours(*a, CHUNK),
                _lightning_inputs)
    from llm_training_tpu.models.bamba.model import mamba2_ssd as theirs
    from llm_training_tpu_torch.models.bamba.model import mamba2_ssd as ours

    return (lambda *a, r=None: theirs(*a, CHUNK, reset_decay=r),
            lambda *a, r=None: ours(*a, CHUNK, reset_decay=r), _ssd_inputs)


def _segments(seq):
    """Two rows of packed documents whose starts fall inside chunks."""
    rows = [[1] * 9 + [2] * (seq - 9), [1] * 5 + [2] * 8 + [3] * (seq - 13)]
    return np.asarray(rows, np.int32)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# every scan at a multiple of the chunk and past one; the resets at the
# latter (their starts inside chunks either way)
SCANS = [(name, reset, seq) for name in ("delta_rule", "lightning", "ssd")
         for reset in ((False, True) if name != "lightning" else (False,))
         for seq in ((20,) if reset else (16, 20))]


@pytest.mark.parametrize("name,reset,seq", SCANS, ids=[
    f"{n}-{'reset' if r else 'plain'}-S{s}" for n, r, s in SCANS])
def test_scan_forward_and_vjp_match_jax(name, reset, seq):
    from llm_training_tpu.models.qwen3_next.model import segment_reset_decay as jax_reset
    from llm_training_tpu_torch.models.qwen3_next.model import segment_reset_decay

    theirs, ours, make = _scan(name)
    rng = np.random.default_rng(seq + 7 * reset)
    inputs = [np.asarray(x, np.float32) for x in make(rng, seq)]
    seg = _segments(seq)
    jax_r = jax_reset(jnp.asarray(seg)) if reset else None
    out, vjp = jax.vjp(jax.jit(lambda *a: theirs(*a, r=jax_r)), *map(jnp.asarray, inputs))
    cotangent = rng.standard_normal(out.shape).astype(np.float32)
    jax_grads = [np.asarray(g) for g in vjp(jnp.asarray(cotangent))]
    tensors = [torch.tensor(x, requires_grad=True) for x in inputs]
    got = ours(*tensors, r=segment_reset_decay(torch.from_numpy(seg)) if reset else None)
    grads = torch.autograd.grad(got, tensors, torch.from_numpy(cotangent))
    assert got.shape == out.shape and got.dtype == torch.float32
    assert _rel(got.detach().numpy(), out) <= SCAN_TOL
    nan_entries = 0
    for i, (grad, want) in enumerate(zip(grads, jax_grads)):
        finite = np.isfinite(want)
        nan_entries += int((~finite).sum())
        assert torch.isfinite(grad).all(), i
        if finite.any():
            assert _rel(grad.numpy()[finite], want[finite]) <= SCAN_TOL, i
    # JAX's masked exp() overflows under a reset inside a chunk (C.50)
    assert (nan_entries > 0) == (reset and name != "lightning")
    # where JAX's VJP is NaN: JAX's forward-mode derivative of the same
    # function (a masked tangent is selected away, never multiplied)
    for i, (grad, want) in enumerate(zip(grads, jax_grads)):
        bad = ~np.isfinite(want)
        if not bad.any():
            continue
        args = list(map(jnp.asarray, inputs))

        def projected(x, i=i):
            return (theirs(*args[:i], x, *args[i + 1:], r=jax_r) * cotangent).sum()

        forward = np.asarray(jax.jit(jax.jacfwd(projected))(args[i]))
        assert np.isfinite(forward).all()
        assert _rel(grad.numpy(), forward) <= SCAN_TOL, i


def test_segment_reset_decay_matches_jax():
    from llm_training_tpu.models.qwen3_next.model import segment_reset_decay as theirs
    from llm_training_tpu_torch.models.qwen3_next.model import segment_reset_decay

    seg = np.asarray([[1, 1, 2, 2, 2, 0, 0], [3, 3, 3, 3, 3, 3, 4]], np.int32)
    ours = segment_reset_decay(torch.from_numpy(seg))
    assert ours.dtype == torch.float32
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs(jnp.asarray(seg))))


# ---------------------------------------------------------------- configs


@pytest.mark.parametrize("model_type", TYPES)
def test_config_matches_jax_field_for_field(model_type):
    """`config_from_hf` of each case builds JAX's config, field for field,
    with the same derived properties, for both layouts."""
    for scan in (True, False):
        jax_config, config = models(model_type, scan_layers=scan)[2:]
        assert dataclasses.asdict(config) == jax_config.model_dump()
        assert config.scan_period == jax_config.scan_period == (2 if scan else 0)
        assert str(config.jax_layout) == ("period2" if scan else "looped")
        assert vars(config.rope_config) == jax_config.rope_config.model_dump()
        for i in range(config.num_hidden_layers):
            kind = (config.layer_is_attention(i) if model_type == "bamba"
                    else config.layer_is_linear(i))
            want = (jax_config.layer_is_attention(i) if model_type == "bamba"
                    else jax_config.layer_is_linear(i))
            assert kind == want
    if model_type == "bamba":
        assert (config.mamba_intermediate, config.mamba_conv_dim, config.resolved_head_dim) == (
            jax_config.mamba_intermediate, jax_config.mamba_conv_dim,
            jax_config.resolved_head_dim)


PRESETS = {"qwen3_next": "qwen3-next-80b-a3b", "minimax": "minimax-text-01",
           "bamba": "bamba-9b"}


@pytest.mark.parametrize("model_type", TYPES)
def test_presets_are_jax_configs(model_type):
    """Each published preset is a valid JAX config with the same fields
    (and JAX's HF default layer pattern where the preset writes it out)."""
    import importlib

    import llm_training_tpu.models as jax_models

    module = importlib.import_module(f"llm_training_tpu_torch.models.{model_type}.config")
    name = PRESETS[model_type]
    config = module.preset(name)
    jax_config = getattr(jax_models, type(config).__name__)(**module.PRESETS[name])
    assert dataclasses.asdict(config) == jax_config.model_dump()
    assert config.jax_layout == (module.JaxLayout("looped") if model_type == "bamba"
                                 else module.JaxLayout("period", 4 if model_type == "qwen3_next"
                                                       else 8))
    if model_type == "qwen3_next":
        default = dataclasses.replace(config, layer_types=None)
        assert [default.layer_is_linear(i) for i in range(48)] == [
            config.layer_is_linear(i) for i in range(48)]
    # a cut keeps the published layer kinds of the layers it keeps
    cut = module.preset(name, num_hidden_layers=2)
    assert cut.num_hidden_layers == 2 and cut.hidden_size == config.hidden_size


def test_configs_refuse_as_jax():
    """JAX's validation: MiniMax's layer_types required, its one MLP width,
    Qwen3-Next's head grouping, Bamba's mixer width and indices."""
    from llm_training_tpu.models import BambaConfig as JaxBamba
    from llm_training_tpu.models import MiniMaxConfig as JaxMiniMax
    from llm_training_tpu.models import Qwen3NextConfig as JaxQwen3Next
    from llm_training_tpu_torch.models.bamba import BambaConfig
    from llm_training_tpu_torch.models.minimax import MiniMaxConfig
    from llm_training_tpu_torch.models.qwen3_next import Qwen3NextConfig

    cases = [
        (MiniMaxConfig, JaxMiniMax, dict(moe_intermediate_size=32, num_hidden_layers=2)),
        (MiniMaxConfig, JaxMiniMax, dict(moe_intermediate_size=32, intermediate_size=64,
                                         num_hidden_layers=1, layer_types=["full_attention"])),
        (MiniMaxConfig, JaxMiniMax, dict(moe_intermediate_size=32, num_hidden_layers=1,
                                         layer_types=["sliding"])),
        (Qwen3NextConfig, JaxQwen3Next, dict(linear_num_key_heads=3, linear_num_value_heads=4)),
        (Qwen3NextConfig, JaxQwen3Next, dict(num_experts=4)),
        (BambaConfig, JaxBamba, dict(hidden_size=64, mamba_n_heads=4, mamba_d_head=8)),
        (BambaConfig, JaxBamba, dict(attn_layer_indices=[40])),
    ]
    for ours, theirs, fields in cases:
        with pytest.raises(ValueError) as want:
            theirs(**fields)
        with pytest.raises(ValueError) as got:
            ours(**fields)
        assert str(got.value) in str(want.value), (str(got.value), str(want.value))


# ---------------------------------------------------------------- the models


def _batch(seq=20):
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 128, (2, seq)).astype(np.int32)
    seg = np.asarray([[1] * 9 + [2] * (seq - 9), [1] * 15 + [0] * (seq - 15)], np.int32)
    labels = rng.integers(0, 128, (2, seq))
    return ids, seg, labels


def _grad_errors(port, want) -> dict[str, float]:
    floor = 1e-3 * max(float(g.norm()) for g in want.values())
    return {n: float((p.grad - want[n]).norm()) / max(float(want[n].norm()), floor)
            for n, p in port.named_parameters()}


CASES = [(t, scan) for t in TYPES for scan in (False, True)]


@pytest.mark.parametrize("model_type,scan", CASES,
                         ids=[f"{t}-{'periodic' if s else 'looped'}" for t, s in CASES])
def test_logits_loss_and_gradients_match_jax(model_type, scan):
    jax_model, port_cls, jax_config, config = models(model_type, scan_layers=scan)
    assert dataclasses.asdict(config) == jax_config.model_dump()
    if model_type in MOE_TYPES:
        config = dataclasses.replace(config, moe_impl="ragged")
    params = random_params(jax_model)
    ids, seg, labels = _batch()

    def loss_fn(p):
        out = jax_model.apply(p, input_ids=jnp.asarray(ids), segment_ids=jnp.asarray(seg))
        logp = jax.nn.log_softmax(out.logits, -1)
        ce = -jnp.take_along_axis(logp, jnp.asarray(labels)[..., None], -1).mean()
        return ce + (0.0 if out.aux_loss is None else out.aux_loss), (ce, out)

    (_, (jax_ce, jax_out)), jax_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    port = port_cls(config, device="cpu")
    port.load_state_dict(state_dict_from_jax(params, config))
    out = port(torch.from_numpy(ids).long(), segment_ids=torch.from_numpy(seg))
    ce = -torch.log_softmax(out.logits, -1).gather(-1, torch.from_numpy(labels)[..., None]).mean()
    (ce + (0.0 if out.aux_loss is None else out.aux_loss)).backward()
    np.testing.assert_allclose(out.logits.detach().numpy(), np.asarray(jax_out.logits),
                               rtol=TOL, atol=1e-5)
    np.testing.assert_allclose(float(ce.detach()), float(jax_ce), rtol=TOL)
    moe_type = model_type in MOE_TYPES
    assert (out.aux_loss is None) == (jax_out.aux_loss is None) == (not moe_type)
    assert (out.ep_dropped_rows is None) == (jax_out.ep_dropped_rows is None)
    if moe_type:
        np.testing.assert_allclose(float(out.aux_loss.detach()), float(jax_out.aux_loss),
                                   rtol=TOL)
        assert float(out.ep_dropped_rows) == float(jax_out.ep_dropped_rows) == 0.0
        stats, jax_stats = out.router_stats, jax_out.router_stats
        assert stats.layer_ids == jax_stats.layer_ids == tuple(range(4))
        for got, want in ((stats.sel_frac, jax_stats.sel_frac),
                          (stats.mean_prob, jax_stats.mean_prob)):
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    want = state_dict_from_jax(jax_grads, config)
    assert set(want) == {n for n, _ in port.named_parameters()}
    errors = _grad_errors(port, want)
    worst = max(errors, key=errors.get)
    assert errors[worst] <= TOL, (worst, errors[worst])


@pytest.mark.parametrize("model_type", ["qwen3_next", "bamba"])
def test_segment_reset_gradients_match_jax_s_forward_mode(model_type):
    """`segment_state_reset` on one packed row of documents of 9 and 11
    tokens (the second starting inside the first chunk), positions
    restarting, JAX's looped tree: the port's logits are JAX's, packed and
    for the second document alone, and the port's packed document is no
    further from its run alone than JAX's is from JAX's (the reset's fp32
    resolution, C.50). JAX's reverse-mode gradients are NaN there (C.50,
    shown by the scans' test); the port's are finite, and for each
    parameter its gradient dotted with
    a seeded random direction equals JAX's forward-mode derivative of the
    loss along that direction (within 1e-4 of the sum of the products'
    magnitudes)."""
    jax_model, port_cls, _, config = models(model_type, segment_state_reset=True,
                                            scan_layers=False)
    if model_type in MOE_TYPES:
        config = dataclasses.replace(config, moe_impl="ragged")
    params = random_params(jax_model, seed=2)
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 128, (1, 20)).astype(np.int32)
    labels = rng.integers(0, 128, (1, 20))
    seg = np.asarray([[1] * 9 + [2] * 11], np.int32)
    pos = np.asarray([list(range(9)) + list(range(11))], np.int32)

    def loss_fn(p):
        out = jax_model.apply(p, input_ids=jnp.asarray(ids), segment_ids=jnp.asarray(seg),
                              position_ids=jnp.asarray(pos))
        logp = jax.nn.log_softmax(out.logits, -1)
        return -jnp.take_along_axis(logp, jnp.asarray(labels)[..., None], -1).sum(), out.logits

    jax_logits = jax.jit(lambda p: loss_fn(p)[1])(params)
    port = port_cls(config, device="cpu")
    port.load_state_dict(state_dict_from_jax(params, config))
    t = lambda x: torch.from_numpy(np.asarray(x)).long()  # noqa: E731
    out = port(t(ids), segment_ids=t(seg), position_ids=t(pos))
    np.testing.assert_allclose(out.logits.detach().numpy(), np.asarray(jax_logits),
                               rtol=TOL, atol=1e-5)
    with torch.no_grad():
        alone = port(t(ids[:, 9:]), segment_ids=t(seg[:, 9:]), position_ids=t(pos[:, 9:]))
    jax_alone = np.asarray(jax.jit(lambda p: jax_model.apply(
        p, input_ids=ids[:, 9:], segment_ids=seg[:, 9:], position_ids=pos[:, 9:]).logits)(params))
    np.testing.assert_allclose(alone.logits.numpy(), jax_alone, rtol=TOL, atol=1e-5)
    # the reset's -1e4 log-decay resolves a decay to ~1e-3 in fp32, so the
    # packed document is its run alone only to that resolution, in JAX too
    gap = np.abs(out.logits.detach().numpy()[:, 9:] - alone.logits.numpy()).max()
    jax_gap = np.abs(np.asarray(jax_logits)[:, 9:] - jax_alone).max()
    assert gap <= jax_gap + 1e-5, (gap, jax_gap)
    (-torch.log_softmax(out.logits, -1).gather(
        -1, torch.from_numpy(labels)[..., None]).sum()).backward()
    grads = {n: p.grad for n, p in port.named_parameters()}
    assert all(torch.isfinite(g).all() for g in grads.values())
    directions = jax.tree.map(
        lambda a: np.random.default_rng(a.size).standard_normal(a.shape).astype(np.float32),
        params)
    paths, treedef = jax.tree_util.tree_flatten_with_path(directions)
    leaves = [x for _, x in paths]
    along = jax.jit(lambda tangent: jax.jvp(lambda p: loss_fn(p)[0], (params,), (tangent,))[1])
    # one leaf's direction at a time, zeros elsewhere
    forward = np.asarray([float(along(treedef.unflatten(
        [x if j == i else np.zeros_like(x) for j, x in enumerate(leaves)])))
        for i in range(len(leaves))])
    assert np.isfinite(forward).all()
    where = {"/".join(str(k.key) for k in path): i for i, (path, _) in enumerate(paths)}
    moved = state_dict_from_jax(directions, config)
    for name, grad in grads.items():
        want = forward[where[jax_path(name, config.jax_layout)]]
        got = float((grad * moved[name]).sum())
        scale = float((grad * moved[name]).abs().sum())
        assert abs(got - want) <= TOL * scale, (name, got, want, scale)
