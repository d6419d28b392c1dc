"""One multi-process world of the port for `test_torch_mesh_fit.py`, run as

    torchrun --standalone --nproc-per-node 4 tests/torch_mesh_world.py PLAN.json

with `tests/` and the repo root on PYTHONPATH. The plan lists commands of
the port's CLI (each `fit`, `validate`, ...), run one after another in the
same process group; a command may carry overrides for one rank only (the
rank-2 SIGTERM), and one that `expect_error` records its error instead of
an exit code. A `ce_probe` entry runs the vocab-parallel cross-entropy
on a `tensor` mesh and records every chunk's logits' shape. Each rank writes
`rank-<r>.json` (every command's exit code and the probe's readings) into
the plan's `out` directory; a `ring_probe` entry runs the real ring and a
ring-attention Llama on a `sequence 4` mesh and saves what it gathered.
Imports torch and the port only.
"""

from __future__ import annotations

import json
import os
import sys
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch


@dataclass
class NpzBatchesConfig:
    path: str = ""


class NpzBatches:
    """A fixed list of host batches from an .npz (`<i>/<key>` arrays),
    served in order (the DPO world's data)."""

    def __init__(self, config: NpzBatchesConfig):
        self.config = config
        self.batches: list[dict] = []

    def setup(self):
        data = np.load(self.config.path)
        count = 1 + max(int(k.split("/")[0]) for k in data.files)
        self.batches = [{k.split("/")[1]: data[k] for k in data.files if k.startswith(f"{i}/")}
                        for i in range(count)]

    def train_batches(self, start_step=0):
        yield from self.batches[start_step:]

    def val_batches(self):
        return iter(())


def _ce_probe(entry: dict) -> dict:
    """Vocab-parallel CE on (fsdp 2, tensor 2) against the replicated one:
    the loss, every chunk's logits shape on this rank, d hidden, and the
    per-row log-probs; and `shard_pytree`'s placements of two tensors."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from llm_training_tpu_torch.ops import cross_entropy as ce
    from llm_training_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from llm_training_tpu_torch.parallel.sharding import shard_pytree

    mesh = build_mesh(MeshConfig(fsdp_size=2, tensor_parallel_size=2), device="cpu")
    rng = np.random.default_rng(entry["seed"])
    tokens, embed, vocab = entry["tokens"], entry["embed"], entry["vocab"]
    hidden = torch.from_numpy(rng.standard_normal((tokens, embed)).astype(np.float32))
    head = torch.from_numpy((0.3 * rng.standard_normal((vocab, embed))).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, vocab, tokens))
    labels[::5] = -100
    widths = []
    chunk_logits = ce._chunk_logits

    def probed(*args):
        logits = chunk_logits(*args)
        widths.append(list(logits.shape))
        return logits

    ce._chunk_logits = probed
    try:
        sharded = distribute_tensor(head, mesh["tensor"], [Shard(0)])
        h = hidden.clone().requires_grad_()
        total, count = ce.fused_linear_cross_entropy(h, sharded.t(), labels, chunk_size=16)
        (total / count).backward()
    finally:
        ce._chunk_logits = chunk_logits
    h_ref = hidden.clone().requires_grad_()
    ref_total, ref_count = ce.fused_linear_cross_entropy(
        h_ref, distribute_tensor(head, mesh["tensor"], [Replicate()]).to_local().t(), labels,
        chunk_size=16)
    (ref_total / ref_count).backward()
    # DPO's and ORPO's per-row label log-probs over the same sharded head
    rows = hidden.reshape(4, tokens // 4, embed)
    logps, counts = ce.fused_linear_log_probs(rows, sharded.t(), labels.reshape(4, -1),
                                              chunk_size=4)
    ref_logps, ref_counts = ce.fused_linear_log_probs(rows, head.t(), labels.reshape(4, -1),
                                                      chunk_size=4)
    placed = shard_pytree({"w_up": torch.ones(16, 8), "norm": torch.ones(16)}, mesh,
                          {"w_up": ("embed", "mlp"), "norm": ("norm",)})
    return {"loss": float(total / count), "ref_loss": float(ref_total / ref_count),
            "widths": widths, "local_head": list(sharded.to_local().shape),
            "hidden_grad_err": float((h.grad - h_ref.grad).abs().max()),
            "logps_err": float((logps - ref_logps).abs().max()),
            "counts_equal": bool(torch.equal(counts, ref_counts)),
            "placed": {k: [list(v.to_local().shape),
                           [f"S{p.dim}" if p.is_shard() else "R" for p in v.placements]]
                       for k, v in placed.items()}}


def _refusals(mesh) -> list[str]:
    """The wrappers that raised TypeError on a DTensor (all should)."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from llm_training_tpu_torch.ops.kernels.flash_attention import flash_attention
    from llm_training_tpu_torch.ops.kernels.paged_attention import paged_decode_attention
    from llm_training_tpu_torch.parallel.ring_attention import _chunk_fns

    x = distribute_tensor(torch.zeros(1, 8, 2, 16), mesh["sequence"], [Replicate()])
    calls = {
        "ring": lambda: _chunk_fns(x, "torch"),
        "flash_attention": lambda: flash_attention(x, x, x),
        "paged_decode_attention": lambda: paged_decode_attention(
            x[:, 0], x, x, torch.zeros(1, 1, dtype=torch.int32), torch.ones(1, dtype=torch.int32)),
    }
    refused = []
    for name, call in calls.items():
        try:
            call()
        except TypeError:
            refused.append(name)
    return refused


def _ring_probe(entry: dict) -> list[str]:
    """The real ring (batch_isend_irecv over a 4-way `sequence` mesh) on
    this rank's chunk of the cases in `entry["data"]`, forward and
    backward, and a Llama forward/backward with `ring_attention`; rank 0
    writes the gathered outputs and gradients to `entry["out"]`. Returns
    the wrappers that refused a DTensor."""
    import torch.distributed as dist

    from llm_training_tpu_torch.models.llama.config import LlamaConfig
    from llm_training_tpu_torch.models.llama.model import Llama
    from llm_training_tpu_torch.parallel.mesh import MeshConfig, build_mesh, use_mesh
    from llm_training_tpu_torch.parallel.ring_attention import ring_attention

    mesh = build_mesh(MeshConfig(fsdp_size=1, sequence_parallel_size=4), device="cpu")
    group = mesh["sequence"].get_group()
    me, n = dist.get_rank(group), dist.get_world_size(group)
    data = np.load(entry["data"])
    t = {k: torch.from_numpy(data[k]) for k in data.files}
    out = {}

    def gather(x, dim=1):
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    for case in entry["cases"]:
        name, kw = case["name"], dict(case["kw"])
        chunk = lambda x: x.chunk(n, dim=1)[me].clone()  # noqa: E731
        q, k, v = (chunk(t[x]).requires_grad_() for x in "qkv")
        sinks = t["sinks"].clone().requires_grad_() if kw.pop("sinks", False) else None
        o = ring_attention(q, k, v, chunk(t["seg"]), group=group, sinks=sinks, **kw)
        (o * chunk(t["cot"])).sum().backward()
        out[f"{name}/o"] = gather(o.detach())
        for x, g in (("q", q.grad), ("k", k.grad), ("v", v.grad)):
            out[f"{name}/d{x}"] = gather(g)
        if sinks is not None:
            dist.all_reduce(sinks.grad, group=group)
            out[f"{name}/dsinks"] = sinks.grad

    config = LlamaConfig(**entry["model"], ring_attention=True)
    model = Llama(config)
    model.load_state_dict({k.removeprefix("model/"): v for k, v in t.items()
                           if k.startswith("model/")})
    ids, seq = t["ids"], t["ids"].shape[1]
    part = slice(me * seq // n, (me + 1) * seq // n)
    positions = torch.arange(seq)[None].expand_as(ids)
    with use_mesh(mesh):
        logits = model(input_ids=ids[:, part], segment_ids=torch.ones_like(ids[:, part]),
                       position_ids=positions[:, part], rope_length=seq).logits
    loss = (logits.float() ** 2).sum() / ids.numel() / logits.shape[-1]
    loss.backward()
    out["model/logits"] = gather(logits.detach())
    for name, p in model.named_parameters():
        dist.all_reduce(p.grad, group=group)
        out[f"model_grad/{name}"] = p.grad
    if dist.get_rank() == 0:
        np.savez(entry["out"], **{k: v.numpy() for k, v in out.items()})
    return _refusals(mesh)


def main(plan_path: str) -> int:
    import torch.distributed as dist

    from llm_training_tpu_torch.cli.main import main as cli_main
    from llm_training_tpu_torch.parallel.mesh import initialize_distributed

    plan = json.loads(Path(plan_path).read_text())
    initialize_distributed(backend="gloo")
    rank = dist.get_rank()
    torch.use_deterministic_algorithms(True)
    results: dict = {"rcs": []}
    rc = 0
    for entry in plan["commands"]:
        if "ce_probe" in entry:
            results["ce_probe"] = _ce_probe(entry["ce_probe"])
            continue
        if "ring_probe" in entry:
            results["refused"] = _ring_probe(entry["ring_probe"])
            continue
        argv = list(entry["argv"]) + list(entry.get("rank_overrides", {}).get(str(rank), []))
        if entry.get("expect_error"):
            # a refusal: the command's error, by type and message
            try:
                rc = cli_main(argv)
            except Exception as e:  # noqa: BLE001 - recorded for the test
                rc = f"{type(e).__name__}: {e}"
        else:
            rc = cli_main(argv)
        results["rcs"].append(rc)
    out = Path(plan["out"])
    out.mkdir(parents=True, exist_ok=True)
    (out / f"rank-{rank}.json").write_text(json.dumps(results))
    dist.destroy_process_group()
    return rc


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    sys.exit(main(sys.argv[1]))
