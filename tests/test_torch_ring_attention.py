"""The port's ring attention (`parallel/ring_attention.py`) against JAX's
`ring_attention` shard_mapped over a `sequence` mesh of the virtual CPU
devices, on the cases of `tests/test_ring_attention.py`: forward, 8-way,
gradients, soft cap, chunks that are no block multiple, sliding windows
(and their gradients), sinks (and their gradients), window with sinks, and
a Llama with `ring_attention` at model level. The port drives the chunk
owners as a virtual ring in this process (the plain chunk functions);
one 4-process gloo world runs the real rotation and gives the virtual
ring's numbers. fp32, within 1e-5.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from llm_training_tpu.models.llama import Llama as JaxLlama
from llm_training_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from llm_training_tpu.parallel.ring_attention import ring_attention as jax_ring
from llm_training_tpu.trainer.trainer import LOGICAL_AXIS_RULES
from llm_training_tpu_torch.models.llama.config import LlamaConfig
from llm_training_tpu_torch.models.llama.from_jax import state_dict_from_jax
from llm_training_tpu_torch.parallel import ring_attention as ra

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-5, atol=1e-5)
MODEL = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
             attention_impl="xla", param_dtype="float32", compute_dtype="float32")
# (name, ring size, sequence, JAX ring kwargs)
CASES = [
    ("forward", 4, 64, {}),
    ("eight_way", 8, 64, {}),
    ("soft_cap", 4, 64, {"logits_soft_cap": 15.0}),
    ("non_block_multiple", 4, 160, {}),
    ("window7", 4, 64, {"sliding_window": 7}),
    ("window16", 4, 64, {"sliding_window": 16}),
    ("window37", 4, 64, {"sliding_window": 37}),
    ("window20", 4, 64, {"sliding_window": 20}),
    ("sinks", 4, 64, {"sinks": True}),
    ("window_sinks", 4, 64, {"sliding_window": 20, "sinks": True}),
]


def _data(seed, seq=64, batch=2, hq=4, hkv=2, d=16):
    """JAX's test data: segments crossing chunk boundaries, trailing
    padding; sinks and a cotangent beside them."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((batch, seq, hq, d)).astype(np.float32)
    k = rng.standard_normal((batch, seq, hkv, d)).astype(np.float32)
    v = rng.standard_normal((batch, seq, hkv, d)).astype(np.float32)
    seg = np.ones((batch, seq), np.int32)
    seg[:, seq // 3:] = 2
    seg[:, 3 * seq // 4:] = 3
    seg[:, -5:] = 0
    sinks = rng.standard_normal(hq).astype(np.float32)
    cot = rng.standard_normal(q.shape).astype(np.float32)
    return dict(q=q, k=k, v=v, seg=seg, sinks=sinks, cot=cot)


def _jax_ring(data, n, kw):
    """JAX's ring shard_mapped over n devices: (o, dq, dk, dv, dsinks)."""
    mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(1, 1, 1, 1, n),
                ("data", "fsdp", "expert", "tensor", "sequence"))
    spec, seg_spec = P(None, "sequence", None, None), P(None, "sequence")
    kw = dict(kw)
    with_sinks = kw.pop("sinks", False)

    def run(q, k, v, seg, sinks):
        return jax_ring(q, k, v, seg, axis_name="sequence", impl="xla",
                        sinks=sinks if with_sinks else None, **kw)

    ring = jax.shard_map(run, mesh=mesh, in_specs=(spec, spec, spec, seg_spec, P(None)),
                         out_specs=spec, check_vma=False)
    @jax.jit
    def forward_backward(q, k, v, seg, sinks, cot):
        o, vjp = jax.vjp(lambda q, k, v, s: ring(q, k, v, seg, s), q, k, v, sinks)
        return (o, *vjp(cot))

    args = [jnp.asarray(data[x]) for x in ("q", "k", "v", "seg", "sinks", "cot")]
    return [np.asarray(x) for x in forward_backward(*args)]


def _port_virtual(data, n, kw):
    """The port's virtual ring of plain chunk functions: (o, dq, dk, dv,
    dsinks)."""
    kw = dict(kw)
    q, k, v = (torch.from_numpy(data[x]).requires_grad_() for x in "qkv")
    sinks = torch.from_numpy(data["sinks"]).requires_grad_() if kw.pop("sinks", False) else None
    o = ra.virtual_ring_attention(q, k, v, torch.from_numpy(data["seg"]), p=n, sinks=sinks,
                                  impl="torch", **kw)
    (o * torch.from_numpy(data["cot"])).sum().backward()
    d_sinks = None if sinks is None else sinks.grad.numpy()
    return [o.detach().numpy(), q.grad.numpy(), k.grad.numpy(), v.grad.numpy(), d_sinks]


@pytest.fixture(scope="module")
def jax_results(devices):
    return {name: _jax_ring(_data(i, seq), n, kw) for i, (name, n, seq, kw) in enumerate(CASES)}


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_virtual_ring_matches_jax_ring(jax_results, case):
    """Output and dq/dk/dv (and d_sinks) within 1e-5 of JAX's ring."""
    name, n, seq, kw = case
    got = _port_virtual(_data(CASES.index(case), seq), n, kw)
    for label, a, b in zip(("o", "dq", "dk", "dv", "dsinks"), got, jax_results[name]):
        if a is None:
            continue
        np.testing.assert_allclose(a, b, **TOL, err_msg=f"{name} {label}")


def test_ring_stops_early_under_a_window():
    """A window within one chunk needs two ring steps of four; none needs
    all of them (JAX's `_num_steps`)."""
    assert ra.num_steps(4, 16, 7) == 2 and ra.num_steps(4, 16, 37) == 4
    assert ra.num_steps(8, 8, None) == 8


def test_wrappers_refuse_dtensors(ring_world):
    """In the world, a DTensor handed to the ring, to the flash wrapper
    (K1-K3) or to the paged-decode wrapper (K4) raised TypeError on every
    rank; none took its plain version."""
    *_, refused = ring_world
    assert refused == [["ring", "flash_attention", "paged_decode_attention"]] * 4


# ---------------------------------------------------------------- the real ring


def _model_weights():
    config = JaxLlamaConfig(**MODEL)
    model = JaxLlama(config)
    ids = np.random.default_rng(6).integers(0, 128, (2, 64)).astype(np.int32)
    params = nn.meta.unbox(model.init(jax.random.key(0), jnp.asarray(ids)))
    return model, params, ids


@pytest.fixture(scope="module")
def ring_world(tmp_path_factory, devices):
    """The 4-process world's gathered outputs, and JAX's model-level ring
    (loss and gradients) on the same weights."""
    root = tmp_path_factory.mktemp("ring-world")
    data = _data(20)
    model, params, ids = _model_weights()
    port_sd = state_dict_from_jax(jax.device_get(params), LlamaConfig(**MODEL))
    np.savez(root / "data.npz", **data, ids=ids,
             **{f"model/{k}": v.numpy() for k, v in port_sd.items()})
    cases = [{"name": "plain", "kw": {}},
             {"name": "window_sinks", "kw": {"sliding_window": 20, "sinks": True}}]
    plan = {"out": str(root / "ranks"), "commands": [{"ring_probe": {
        "data": str(root / "data.npz"), "out": str(root / "ring.npz"), "cases": cases,
        "model": {k: v for k, v in MODEL.items()}}}]}
    (root / "plan.json").write_text(json.dumps(plan))
    env = {k: v for k, v in os.environ.items() if not k.startswith(("XLA_", "JAX_"))}
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT), str(ROOT / "tests")])
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4",
         str(ROOT / "tests" / "torch_mesh_world.py"), str(root / "plan.json")],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    mesh = Mesh(np.asarray(devices[:4]).reshape(1, 1, 1, 1, 4),
                ("data", "fsdp", "expert", "tensor", "sequence"))
    ring_model = JaxLlama(JaxLlamaConfig(**MODEL, ring_attention=True))
    seg = jnp.ones(ids.shape, jnp.int32)

    def loss(p):
        out = ring_model.apply(p, jnp.asarray(ids), segment_ids=seg)
        return (out.logits.astype(jnp.float32) ** 2).mean(), out.logits

    with mesh, nn.logical_axis_rules(LOGICAL_AXIS_RULES):
        (_, logits), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    jax_model = (np.asarray(logits),
                 state_dict_from_jax(jax.device_get(grads), LlamaConfig(**MODEL)))
    try:
        out, _ = proc.communicate(timeout=180)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
    assert proc.returncode == 0, out[-6000:]
    refused = [json.loads((root / "ranks" / f"rank-{r}.json").read_text())["refused"]
               for r in range(4)]
    yield dict(np.load(root / "ring.npz")), data, jax_model, refused


def test_real_ring_gives_the_virtual_rings_numbers(ring_world):
    """batch_isend_irecv over 4 gloo ranks: output and gradients equal the
    virtual ring's (the same sums in the same order) within 1e-6."""
    got, data, _, _ = ring_world
    for name, kw in (("plain", {}), ("window_sinks", {"sliding_window": 20, "sinks": True})):
        want = _port_virtual(data, 4, kw)
        for label, b in zip(("o", "dq", "dk", "dv", "dsinks"), want):
            if b is None:
                continue
            np.testing.assert_allclose(got[f"{name}/{label}"], b, rtol=1e-6, atol=1e-6,
                                       err_msg=f"{name} {label}")


def test_model_level_ring_matches_jax(ring_world):
    """A Llama with `ring_attention` on a 4-way sequence mesh: logits within
    1e-5 of JAX's model-level ring, each parameter's gradient (summed over
    the sequence ranks) within 1e-5 of JAX's."""
    got, _, (logits, grads), _ = ring_world
    np.testing.assert_allclose(got["model/logits"], logits, **TOL)
    for name, g in grads.items():
        np.testing.assert_allclose(got[f"model_grad/{name}"], g.numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)
