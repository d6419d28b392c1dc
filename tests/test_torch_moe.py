"""Port parity of the MoE block (`models/moe.py`) and of G1's plain version
(`ops/kernels/grouped_gemm.py`) on the CPU, against the JAX package on the
same numpy inputs:

- the grouped GEMM's forward against `jax.lax.ragged_dot` and its dgrad /
  wgrad against `jax.grad` of it, over layouts with empty first, middle
  and last groups and over the Hopper kernel's edge layouts
  (`bench_grouped_gemm.edge_layouts`) (fp32: within 1e-5; a group with no
  rows has a zero weight gradient), and the autograd function's gradients
  equal the plain entry points';
- `router_block_stats` (padding left out), `sparsemixer_topk`, and
  `dropless_moe_apply`'s dense, ragged and bucketed impls (the bucketed
  path's dropped count equal, its capacity overflowing), each within 1e-5
  (fp32); an unknown impl raises as JAX's does;
- the combine's order in bf16: each token's rows added in ascending
  expert id, rounded after each add, bit for bit JAX's scatter-add (which
  slot order would not give);
- `MoEMLP` with JAX's parameters (softmax and sparsemixer routing, gated
  and always-on shared experts), the port's dense and ragged impls against
  JAX's exact dense one: outputs and router statistics within 1e-5, and
  every parameter gradient within 1e-4 (relative norm).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from llm_training_tpu.models import moe as jax_moe
from llm_training_tpu.models.llama.config import LlamaConfig as JaxLlamaConfig
from llm_training_tpu_torch.models import moe
from llm_training_tpu_torch.models.llama.config import LlamaConfig
from llm_training_tpu_torch.ops.kernels import bench_grouped_gemm as bench
from llm_training_tpu_torch.ops.kernels import grouped_gemm as gg

TOL = 1e-5
LAYOUTS = {
    "one group": [37],
    "empty first": [0, 5, 9, 3],
    "empty middle": [4, 0, 0, 11, 2],
    "empty last": [6, 17, 0],
    "ragged": [1, 7, 13, 2, 31, 5],
}


def _operands(sizes, k=24, n=16, seed=0):
    rng = np.random.default_rng(seed)
    m = sum(sizes)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((len(sizes), k, n)).astype(np.float32)
    dy = rng.standard_normal((m, n)).astype(np.float32)
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(sizes)]), dtype=torch.int32)
    return x, w, dy, offsets


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_grouped_gemm_matches_ragged_dot(layout):
    sizes = LAYOUTS[layout]
    x, w, dy, offsets = _operands(sizes)
    gs = jnp.asarray(sizes, jnp.int32)
    want = jax.lax.ragged_dot(jnp.asarray(x), jnp.asarray(w), gs)
    _, vjp = jax.vjp(lambda a, b: jax.lax.ragged_dot(a, b, gs), jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(dy))
    tx, tw, tdy = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(dy)
    np.testing.assert_allclose(gg.grouped_gemm_fwd(tx, tw, offsets).numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    dx = gg.grouped_gemm_dgrad(tdy, tw, offsets)
    dw = gg.grouped_gemm_wgrad(tx, tdy, offsets, len(sizes))
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(want_dw), rtol=TOL, atol=TOL)
    for g, size in enumerate(sizes):
        if size == 0:
            assert not dw[g].any()
    # the autograd function's backward is the two entry points
    ax, aw = tx.clone().requires_grad_(), tw.clone().requires_grad_()
    gg.grouped_gemm(ax, aw, offsets).backward(tdy)
    assert torch.equal(ax.grad, dx) and torch.equal(aw.grad, dw)
    # the plain differentiable version (autograd through the slices) agrees
    px, pw = tx.clone().requires_grad_(), tw.clone().requires_grad_()
    gg.grouped_gemm_fwd_torch(px, pw, offsets).backward(tdy)
    torch.testing.assert_close(px.grad, dx, rtol=TOL, atol=TOL)
    torch.testing.assert_close(pw.grad, dw, rtol=TOL, atol=TOL)
    assert gg.offsets_from_sizes(torch.tensor(sizes)).tolist() == offsets.tolist()


@pytest.mark.parametrize("layout", sorted(bench.edge_layouts()))
def test_grouped_gemm_edge_layouts_match_ragged_dot(layout):
    """The Hopper kernel's edge layouts (`bench_grouped_gemm.edge_layouts`:
    groups starting off multiples of 8, a 1-row group between groups of
    thousands, K and N tails of the tile, 1024 small groups, one group over
    five bands), which the card holds the kernel to G1's plain version on:
    here the plain version's three directions against `ragged_dot` and its
    VJP within 1e-5 (fp32; relative to each output's largest element, as
    sums of up to 4100 terms in another order differ by that much near
    zero), an empty group's weight gradient zero."""
    sizes, k, n = bench.edge_layouts()[layout]
    x, w, dy, offsets = _operands(sizes, k=k, n=n, seed=4)
    gs = jnp.asarray(sizes, jnp.int32)
    fwd = lambda a, b: jax.lax.ragged_dot(a, b, gs)  # noqa: E731
    want, vjp = jax.vjp(fwd, jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(dy))
    tx, tw, tdy = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(dy)
    dw = gg.grouped_gemm_wgrad(tx, tdy, offsets, len(sizes))
    for got, ref in ((gg.grouped_gemm_fwd(tx, tw, offsets), want),
                     (gg.grouped_gemm_dgrad(tdy, tw, offsets), want_dx), (dw, want_dw)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL * np.abs(ref).max())
    empty = [g for g, size in enumerate(sizes) if size == 0]
    assert not dw[empty].any()


def test_grouped_gemm_wrappers_refuse_what_they_cannot_take():
    x, w, dy, offsets = _operands([3, 4])
    with pytest.raises(ValueError, match="does not match"):
        gg.grouped_gemm_fwd(torch.from_numpy(x)[:, :5], torch.from_numpy(w), offsets)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        gg.grouped_gemm_fwd(torch.from_numpy(x).to("meta"), torch.from_numpy(w).to("meta"),
                            offsets.to("meta"))
    launches = [f.launches for f in gg.LAUNCHERS]
    gg.grouped_gemm_fwd(torch.from_numpy(x), torch.from_numpy(w), offsets)
    assert [f.launches for f in gg.LAUNCHERS] == launches  # the CPU launches nothing


def _routing(seed=0, tokens=24, experts=6, top_k=2):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((tokens, experts)).astype(np.float32)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), -1))
    idx = np.argsort(-probs, -1, kind="stable")[:, :top_k].astype(np.int32)
    weights = np.take_along_axis(probs, idx, -1)
    return logits, probs, idx, weights


def test_router_block_stats_match_jax():
    _, probs, idx, _ = _routing()
    pad = np.random.default_rng(1).random(24) > 0.3
    for mask in (None, pad):
        want = jax_moe.router_block_stats(jnp.asarray(idx), jnp.asarray(probs), 6,
                                          None if mask is None else jnp.asarray(mask))
        got = moe.router_block_stats(torch.from_numpy(idx).long(), torch.from_numpy(probs), 6,
                                     None if mask is None else torch.from_numpy(mask))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("eps", [0.01, 0.5])
def test_sparsemixer_topk_matches_jax(eps):
    logits, *_ = _routing(seed=2, tokens=40, experts=8)
    logits[3, 5] = logits[3].max()  # a tie with the argmax: the first index wins
    w_want, i_want = jax_moe.sparsemixer_topk(jnp.asarray(logits), eps)
    w_got, i_got = moe.sparsemixer_topk(torch.from_numpy(logits), eps)
    np.testing.assert_array_equal(i_got.numpy(), np.asarray(i_want))
    np.testing.assert_allclose(w_got.numpy(), np.asarray(w_want), rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="top_k=2"):
        moe.sparsemixer_topk(torch.from_numpy(logits), eps, top_k=3)


def _expert_fns(w, package):
    """(dense_fn, ragged_fn, bmm_fn) of a plain per-expert matrix `w [E, H,
    H]` for `package` (a ReLU between two uses of it, so the rows differ
    by expert); ragged_fn's group argument is JAX's sizes or the port's
    offsets."""
    if package == "jax":
        wj = jnp.asarray(w)
        dense = lambda x: jnp.einsum("th,ehi->tei", jax.nn.relu(x), wj)  # noqa: E731
        ragged = lambda xs, gs, eo, ww: jax.lax.ragged_dot(jax.nn.relu(xs), wj, gs)  # noqa: E731
        bmm = lambda xb: jnp.einsum("ech,ehi->eci", jax.nn.relu(xb), wj)  # noqa: E731
        return dense, ragged, bmm
    wt = torch.from_numpy(w)
    dense = lambda x: torch.einsum("th,ehi->tei", torch.relu(x), wt)  # noqa: E731
    ragged = lambda xs, offs, eo, ww: gg.grouped_gemm(torch.relu(xs), wt, offs)  # noqa: E731
    bmm = lambda xb: torch.einsum("ech,ehi->eci", torch.relu(xb), wt)  # noqa: E731
    return dense, ragged, bmm


@pytest.mark.parametrize("impl,capacity", [("dense", 1.25), ("ragged", 1.25),
                                           ("bucketed", 1.25), ("bucketed", 0.5)])
def test_dropless_moe_apply_matches_jax(impl, capacity):
    _, _, idx, weights = _routing(seed=3, tokens=32, experts=6, top_k=2)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((32, 16)).astype(np.float32)
    w = rng.standard_normal((6, 16, 16)).astype(np.float32)
    want, want_dropped = jax_moe.dropless_moe_apply(
        jnp.asarray(x), jnp.asarray(idx), jnp.asarray(weights), 6, impl,
        *_expert_fns(w, "jax")[:2], bmm_fn=_expert_fns(w, "jax")[2],
        moe_capacity_factor=capacity)
    dense, ragged, bmm = _expert_fns(w, "port")
    got, dropped = moe.dropless_moe_apply(
        torch.from_numpy(x), torch.from_numpy(idx).long(), torch.from_numpy(weights), 6, impl,
        dense, ragged, bmm_fn=bmm, moe_capacity_factor=capacity)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    assert float(dropped) == float(want_dropped)
    if capacity < 1:
        assert float(dropped) > 0  # the small buckets overflow
    with pytest.raises(ValueError, match="unknown moe_impl"):
        moe.dropless_moe_apply(torch.from_numpy(x), torch.from_numpy(idx).long(),
                               torch.from_numpy(weights), 6, "grouped", dense, ragged)


def test_combine_order_in_bf16_is_jax_s_bit_for_bit():
    """Identity experts: the output is each token's weighted rows summed. In
    bf16 the order of the adds shows, and the port's equals JAX's
    scatter-add over the expert-sorted rows exactly; adding in top-k slot
    order gives other bits."""
    rng = np.random.default_rng(5)
    tokens, top_k, experts = 64, 4, 8
    x = rng.standard_normal((tokens, 32)).astype(np.float32)
    logits = rng.standard_normal((tokens, experts))
    idx = np.argsort(-logits, -1)[:, :top_k].astype(np.int32)
    w = rng.random((tokens, top_k)).astype(np.float32)
    want, _ = jax_moe.dropless_moe_apply(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(idx), jnp.asarray(w, jnp.bfloat16), experts,
        "ragged", None, lambda xs, gs, eo, ww: xs)
    xb, wb = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    got, _ = moe.dropless_moe_apply(xb, torch.from_numpy(idx).long(), wb, experts, "ragged",
                                    None, lambda xs, offs, eo, ww: xs)
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_array_equal(got.float().numpy(), want)
    by_slot = torch.zeros_like(xb)
    for k in range(top_k):
        by_slot = by_slot + xb * wb[:, k:k + 1]
    assert not np.array_equal(by_slot.float().numpy(), want)


MLP_CASES = {
    "softmax": dict(),
    "no renorm + gated shared": dict(norm_topk_prob=False, shared_expert_intermediate_size=24),
    "always-on shared": dict(shared_expert_intermediate_size=24, shared_expert_gated=False),
    "sparsemixer": dict(moe_router_impl="sparsemixer", router_jitter_eps=0.3,
                        norm_topk_prob=False),
}


def _mlp_state(params: dict) -> dict:
    """JAX's MoEMLP tree -> the port's `MoEMLP` state dict."""
    out = {"gate.weight": torch.from_numpy(np.asarray(params["gate"]["kernel"]).T.copy())}
    for name, value in params.items():
        if name != "gate":
            out[name] = torch.from_numpy(np.asarray(value))
    return out


@pytest.mark.parametrize("case", sorted(MLP_CASES))
@pytest.mark.parametrize("impl", ["dense", "ragged"])
def test_moe_mlp_matches_jax(case, impl):
    fields = dict(vocab_size=64, hidden_size=32, intermediate_size=48, num_hidden_layers=1,
                  num_attention_heads=4, num_key_value_heads=2, num_experts=6,
                  num_experts_per_tok=2, moe_intermediate_size=16, moe_impl=impl,
                  compute_dtype="float32", param_dtype="float32", **MLP_CASES[case])
    # JAX's side runs its exact dense path (its ragged one is the TPU's)
    jax_config = JaxLlamaConfig(**{**fields, "moe_impl": "dense"})
    config = LlamaConfig(**fields)
    rng = np.random.default_rng(6)
    hidden = rng.standard_normal((2, 9, 32)).astype(np.float32)
    pad = np.ones((2, 9), bool)
    pad[1, 6:] = False
    block = jax_moe.MoEMLP(jax_config)
    shapes = jax.eval_shape(lambda: block.init(jax.random.key(0), hidden, pad))
    params = jax.tree.map(lambda a: (0.3 * rng.standard_normal(a.shape)).astype(np.float32),
                          nn.meta.unbox(shapes))

    def run(p):
        out, (sel, prob, dropped) = block.apply(p, jnp.asarray(hidden), jnp.asarray(pad))
        return (out ** 2).sum(), (out, sel, prob, dropped)

    (_, (out, sel, prob, dropped)), grads = jax.value_and_grad(run, has_aux=True)(params)
    port = moe.MoEMLP(config, device="cpu")
    port.load_state_dict(_mlp_state(params["params"]))
    got, (got_sel, got_prob, got_dropped) = port(torch.from_numpy(hidden), torch.from_numpy(pad))
    (got ** 2).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_sel.numpy(), np.asarray(sel), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_prob.detach().numpy(), np.asarray(prob), rtol=TOL, atol=TOL)
    assert float(got_dropped) == float(dropped) == 0.0
    want = _mlp_state(grads["params"])
    for name, param in port.named_parameters():
        err = float((param.grad - want[name]).norm() / want[name].norm().clamp_min(1e-12))
        assert err <= 1e-4, (name, err)


def test_expert_parallel_mesh_names_a9b(monkeypatch):
    class Mesh:
        mesh_dim_names = ("expert",)

        def __getitem__(self, name):
            return type("Axis", (), {"size": lambda self: 2})()

    monkeypatch.setattr(moe, "active_mesh", lambda: Mesh())
    _, _, idx, weights = _routing()
    with pytest.raises(NotImplementedError, match="A.9b"):
        moe.dropless_moe_apply(torch.zeros(24, 4), torch.from_numpy(idx).long(),
                               torch.from_numpy(weights), 6, "ragged", None, None)
