"""The port's mesh `fit` in 4-process gloo worlds on the CPU, against JAX's
`Trainer` on the same `MeshConfig` over 4 of the 8 virtual CPU devices.

One world (`tests/torch_mesh_world.py` under `torchrun --standalone`) runs,
through the port's CLI, in one process group:

- 5-step fits of a tiny Llama from one HF directory on `(fsdp 2, tensor
  2)` and on `(fsdp 2, sequence 2)` with `ring_attention: true` and
  NEFTune (each rank draws its block of the global noise), DPO and
  ORPO on `(fsdp 4)`, and Adam, SGD with momentum and Lion on `(fsdp 2,
  tensor 2)`: losses within rtol 1e-4 of JAX's, the final parameters (the
  checkpoint, gathered onto one process by DCP) within 1e-5 of JAX's in
  norm per tensor;
- vocab-parallel cross-entropy on `tensor 2`: every chunk's logits are
  `[chunk, V/2]` and the head `[V/2, hidden]` on every rank, the loss within
  1e-6 of the replicated one;
- a save on `(fsdp 4)` at step 2, resumed on `(fsdp 2, tensor 2)`: the
  uninterrupted run's losses within rtol 1e-4;
- SIGTERM to rank 2 at step 3: all four ranks exit 75 after step 3, with
  the emergency checkpoint of step 3 committed;
- an MoE Llama (4 experts, a gated shared expert, the ragged impl) on
  `(fsdp 4)`, FSDP2 sharding each expert stack's `expert` dim 0: losses
  within rtol 1e-5 of the same fit in this one process; on `(fsdp 2,
  tensor 2)` it raises naming A.9b;
- the same MoE with `moe_impl: bucketed` at capacity factor 1 on `(fsdp
  4)`: losses within rtol 1e-4 of JAX's and every step's dropped rows
  equal (the global batch's capacity and drops); on `(fsdp 2, sequence
  2)` it raises naming A.9b.

Then `validate` and `generate` read the `(fsdp 2, tensor 2)` checkpoint in
this one process: JAX's `val_loss` (rtol 1e-4) and greedy tokens. The
world starts before the JAX fits and runs beside them. fp32 throughout.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import flax.linen as nn
import jax
import numpy as np
import pytest
import torch

from llm_training_tpu.data.dummy import DummyDataModule as JaxDummy
from llm_training_tpu.data.dummy import DummyDataModuleConfig as JaxDummyConfig
from llm_training_tpu.infer import InferenceEngine as JaxEngine
from llm_training_tpu.infer.engine import GenerateConfig as JaxGenerateConfig
from llm_training_tpu.lms import CLM as JaxCLM
from llm_training_tpu.lms import CLMConfig as JaxCLMConfig
from llm_training_tpu.lms import DPO as JaxDPO
from llm_training_tpu.lms import DPOConfig as JaxDPOConfig
from llm_training_tpu.lms import ORPO as JaxORPO
from llm_training_tpu.lms import ORPOConfig as JaxORPOConfig
from llm_training_tpu.lms import ModelProvider as JaxProvider
from llm_training_tpu.models import Llama as JaxLlama
from llm_training_tpu.models import LlamaConfig as JaxLlamaConfig
from llm_training_tpu.models import hf_io as jax_hf_io
from llm_training_tpu.optim import OptimConfig as JaxOptimConfig
from llm_training_tpu.parallel import MeshConfig as JaxMeshConfig
from llm_training_tpu.trainer import Trainer as JaxTrainer
from llm_training_tpu.trainer import TrainerConfig as JaxTrainerConfig
from llm_training_tpu_torch.cli.main import main as cli_main
from llm_training_tpu_torch.models import hf_io
from llm_training_tpu_torch.models.llama.config import LlamaConfig
from llm_training_tpu_torch.models.llama.from_jax import state_dict_from_jax
from llm_training_tpu_torch.models.llama.model import Llama

ROOT = Path(__file__).resolve().parent.parent
TINY = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
            rope_theta=500000.0, compute_dtype="float32", param_dtype="float32",
            attention_impl="xla")
DATA = dict(batch_size=8, max_length=32, num_samples=96, validation_split=16, vocab_size=128)
OPTIM = dict(learning_rate=2e-3, warmup_steps=2)
STEPS = 5
# the other optimizers, and ORPO, on a mesh: held against JAX and against the
# same fit in one process
OTHER_FITS = (
    ("adam", {"fsdp_size": 2, "tensor_parallel_size": 2}, {"optim": {**OPTIM, "optimizer": "adam"}}),
    ("sgd", {"fsdp_size": 2, "tensor_parallel_size": 2},
     {"optim": {**OPTIM, "optimizer": "sgd", "optimizer_kwargs": {"momentum": 0.9}}}),
    ("lion", {"fsdp_size": 2, "tensor_parallel_size": 2},
     {"optim": {**OPTIM, "optimizer": "lion", "learning_rate": 3e-4}}),
    ("orpo", {"fsdp_size": 4}, {"objective": "ORPO", "data": "prefs"}),
)
MESHES = {"tp": dict(fsdp_size=2, tensor_parallel_size=2),
          "sp": dict(fsdp_size=2, sequence_parallel_size=2),
          "dpo": dict(fsdp_size=4)}
NEFTUNE = {"neftune_alpha": 5.0}
PROMPTS = [[3, 17, 42], [5, 9]]
MOE = dict(num_experts=4, num_experts_per_tok=2, moe_intermediate_size=16,
           shared_expert_intermediate_size=24, moe_impl="ragged")
# fixed-capacity buckets at factor 1: the router's own skew overflows some
# experts' capacity of the global batch (JAX drops 33-70 rows a step here)
MOE_BUCKETED = dict(MOE, moe_impl="bucketed", moe_capacity_factor=1.0)
WORLD_TIMEOUT_S = 240


def _port_config(root: Path, name: str, mesh: dict, *, objective="CLM", model_extra=None,
                 steps=STEPS, ckpt=None, data=None, optim=None, objective_extra=None,
                 hf="hf") -> Path:
    """A port config (JSON) of one run: JsonlLogger into root/name, the
    checkpoint (`ckpt`, default root/<name>-ckpt) saved at the end; `data`
    "prefs" is the preference batches' file; weights from root/`hf`."""
    model = {"model_class": "Llama", "model_kwargs": {**TINY, **(model_extra or {})}}
    init = {"model": model, "pre_trained_weights": str(root / hf), "optim": optim or OPTIM,
            **(objective_extra or {})}
    if data == "prefs":
        data = {"class_path": "torch_mesh_world.NpzBatches",
                "init_args": {"path": str(root / "prefs.npz")}}
    config = {
        "seed_everything": 42,
        "trainer": {
            "max_steps": steps, "log_every_n_steps": 1, "limit_val_batches": 2, "mesh": mesh,
            "checkpoint": {"dirpath": str(ckpt or root / f"{name}-ckpt"), "async_save": False},
            "loggers": [{"class_path": "llm_training_tpu.callbacks.JsonlLogger",
                         "init_args": {"save_dir": str(root), "project": "p", "name": name}}],
        },
        "model": {"class_path": f"llm_training_tpu.lms.{objective}", "init_args": init},
        "data": data or {"class_path": "llm_training_tpu.data.DummyDataModule",
                         "init_args": DATA},
    }
    path = root / f"{name}.json"
    path.write_text(json.dumps(config))
    return path


def _losses(root: Path, name: str, key: str = "loss") -> dict[int, float]:
    rows = [json.loads(line) for line in (root / "p" / name / "metrics.jsonl").read_text().splitlines()]
    return {r["step"]: r[key] for r in rows if key in r}


def _preference_batches(steps: int) -> list[dict]:
    """Seeded preference batches of 8 pairs (the collator's layout)."""
    rng = np.random.default_rng(5)
    batches = []
    for _ in range(steps):
        batch = {}
        for side in ("chosen", "rejected"):
            ids = rng.integers(1, TINY["vocab_size"], (8, 16)).astype(np.int64)
            labels = ids.copy()
            labels[:, :5] = -100
            seg = np.ones((8, 16), np.int64)
            seg[:, 12 + (side == "chosen"):] = 0
            labels[seg == 0] = -100
            batch.update({f"{side}_input_ids": ids * seg, f"{side}_labels": labels,
                          f"{side}_segment_ids": seg,
                          f"{side}_position_ids": np.broadcast_to(np.arange(16), (8, 16)).copy()})
        batches.append(batch)
    return batches


class _ListData:
    """JAX's side of the preference data: the same batches in order."""

    def __init__(self, batches):
        self.batches = batches

    def setup(self):
        pass

    def train_batches(self, start_step=0):
        yield from self.batches[start_step:]

    def val_batches(self):
        return iter(())


class _Track:
    def __init__(self):
        self.losses = {}
        self.dropped = {}

    def on_step_end(self, trainer, step, metrics):
        self.losses[step] = float(metrics["loss"])
        if "ep_dropped_rows" in metrics:
            self.dropped[step] = float(metrics["ep_dropped_rows"])


@pytest.fixture(scope="module")
def world(tmp_path_factory, devices):
    """The HF weights, the port's world (started first, in the background)
    and JAX's fits on the same meshes; yields (root, JAX results, the
    world's rank results)."""
    root = tmp_path_factory.mktemp("mesh-fit")
    jax_config = JaxLlamaConfig(**TINY)
    params = jax.device_get(nn.meta.unbox(JaxLlama(jax_config).init(
        jax.random.key(0), np.zeros((1, 4), np.int32))))
    jax_hf_io.save_hf_checkpoint(params, jax_config, root / "hf", dtype="float32")
    # the MoE fits' weights: random, through the port's own export
    moe_config = LlamaConfig(**TINY, **MOE)
    moe_model = Llama(moe_config, device="cpu")
    moe_model.init_weights(torch.Generator().manual_seed(5))
    hf_io.save_hf_checkpoint(moe_model.state_dict(), moe_config, root / "hf-moe", dtype="float32")
    prefs = _preference_batches(STEPS)
    np.savez(root / "prefs.npz", **{f"{i}/{k}": v for i, b in enumerate(prefs) for k, v in b.items()})

    cpu = ["--device", "cpu"]
    resume = root / "resume-ckpt"
    commands = [
        {"argv": ["fit", "--config", str(_port_config(root, "tp", MESHES["tp"])), *cpu]},
        {"argv": ["fit", "--config", str(_port_config(
            root, "sp", MESHES["sp"], model_extra={"ring_attention": True},
            objective_extra=NEFTUNE)), *cpu]},
        {"argv": ["fit", "--config", str(_port_config(
            root, "dpo", MESHES["dpo"], objective="DPO", data="prefs")), *cpu]},
        {"ce_probe": {"seed": 3, "tokens": 40, "embed": 16, "vocab": 64}},
        {"argv": ["fit", "--config", str(_port_config(root, "resume-a", {"fsdp_size": 4},
                                                      steps=2, ckpt=resume)), *cpu]},
        {"argv": ["fit", "--config", str(_port_config(root, "resume-b", MESHES["tp"],
                                                      ckpt=resume)), *cpu]},
        *({"argv": ["fit", "--config", str(_port_config(root, name, mesh, **kw)), *cpu]}
          for name, mesh, kw in OTHER_FITS),
        {"argv": ["fit", "--config", str(_port_config(
            root, "moe", {"fsdp_size": 4}, model_extra=MOE, hf="hf-moe")), *cpu]},
        {"argv": ["fit", "--config", str(_port_config(
            root, "moe-tp", MESHES["tp"], model_extra=MOE, hf="hf-moe", steps=1)), *cpu],
         "expect_error": True},
        {"argv": ["fit", "--config", str(_port_config(
            root, "moe-bucketed", MESHES["dpo"], model_extra=MOE_BUCKETED, hf="hf-moe")), *cpu]},
        {"argv": ["fit", "--config", str(_port_config(
            root, "moe-bucketed-sp", MESHES["sp"], hf="hf-moe", steps=1,
            model_extra={**MOE_BUCKETED, "ring_attention": True})), *cpu], "expect_error": True},
        {"argv": ["fit", "--config", str(_port_config(
            root, "adafactor", MESHES["tp"], steps=1,
            optim={"optimizer": "adafactor", "learning_rate": 1e-3})), *cpu], "expect_error": True},
        {"argv": ["fit", "--config", str(_port_config(root, "sigterm", {"fsdp_size": 4})), *cpu],
         "rank_overrides": {"2": ["trainer.resilience.chaos.sigterm_step=3"]}},
    ]
    plan = root / "plan.json"
    plan.write_text(json.dumps({"commands": commands, "out": str(root / "ranks")}))
    env = {k: v for k, v in os.environ.items() if not k.startswith(("XLA_", "JAX_"))}
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT), str(ROOT / "tests")])
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4",
         str(ROOT / "tests" / "torch_mesh_world.py"), str(plan)],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )

    four = devices[:4]
    jax_objectives = {"CLM": (JaxCLM, JaxCLMConfig), "DPO": (JaxDPO, JaxDPOConfig),
                      "ORPO": (JaxORPO, JaxORPOConfig)}

    def jax_fit(mesh, objective="CLM", model_extra=None, optim=None, data=None,
                objective_extra=None, hf="hf"):
        objective_cls, config_cls = jax_objectives[objective]
        track = _Track()
        jax_objective = objective_cls(config_cls(
            model=JaxProvider(model_class="llm_training_tpu.models.Llama",
                              model_kwargs={**TINY, **(model_extra or {})}),
            pre_trained_weights=str(root / hf), optim=JaxOptimConfig(**(optim or OPTIM)),
            **(objective_extra or {})))
        trainer = JaxTrainer(JaxTrainerConfig(max_steps=STEPS, log_every_n_steps=1,
                                              mesh=JaxMeshConfig(**mesh)),
                             callbacks=[track], devices=four)
        state = trainer.fit(jax_objective, _ListData(prefs) if data == "prefs"
                            else JaxDummy(JaxDummyConfig(**DATA)))
        params = state.params["policy"] if objective == "DPO" else state.params
        if track.dropped:
            return track.losses, jax.device_get(params), track.dropped
        return track.losses, jax.device_get(params), jax_objective

    jax_runs = {"tp": jax_fit(MESHES["tp"]),
                "sp": jax_fit(MESHES["sp"], model_extra={"ring_attention": True},
                              objective_extra=NEFTUNE),
                "dpo": jax_fit(MESHES["dpo"], "DPO", data="prefs")}
    for name, mesh, kw in OTHER_FITS:
        jax_runs[name] = jax_fit(mesh, **kw)
    jax_runs["moe-bucketed"] = jax_fit(MESHES["dpo"], model_extra=MOE_BUCKETED, hf="hf-moe")

    try:
        out, _ = proc.communicate(timeout=WORLD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
        pytest.fail(f"the 4-process world timed out:\n{out[-4000:]}")
    ranks = [json.loads((root / "ranks" / f"rank-{r}.json").read_text())
             if (root / "ranks" / f"rank-{r}.json").exists() else None for r in range(4)]
    assert all(ranks), f"world exited {proc.returncode}:\n{out[-6000:]}"
    yield root, jax_runs, ranks


@pytest.fixture(scope="module")
def one_process(world):
    """OTHER_FITS again in this one process (no process group: one device),
    from the same configs with the mesh node dropped."""
    root = world[0]
    for name, _, kw in OTHER_FITS:
        config = json.loads((root / f"{name}.json").read_text())
        config["trainer"].pop("mesh")
        config["trainer"].pop("checkpoint")
        config["trainer"]["loggers"][0]["init_args"]["name"] = f"{name}-one"
        path = root / f"{name}-one.json"
        path.write_text(json.dumps(config))
        assert cli_main(["fit", "--config", str(path), "--device", "cpu"]) == 0
    return root


def _restored(root: Path, name: str, objective="CLM") -> dict[str, torch.Tensor]:
    """The run's last checkpoint, gathered onto this one process (DCP
    reshards the DTensor shards into whole tensors)."""
    from llm_training_tpu_torch.cli.config import load_config
    from llm_training_tpu_torch.cli.main import build_fit

    trainer, port_objective, _ = build_fit(load_config(root / f"{name}.json"), "cpu")
    state = trainer.restore_for_inference(port_objective)
    model = state.model.policy if objective == "DPO" else state.model
    return {k: v.detach() for k, v in model.state_dict().items()}


def _assert_params_close(got: dict, jax_params) -> None:
    want = state_dict_from_jax({"params": jax_params} if "params" not in jax_params else jax_params,
                               LlamaConfig(**TINY))
    assert set(got) == set(want)
    for name, value in want.items():
        err = float(torch.linalg.vector_norm(got[name] - value) / torch.linalg.vector_norm(value))
        assert err <= 1e-5, (name, err)


def _assert_fit_matches_jax(root: Path, jax_runs: dict, name: str, objective="CLM") -> None:
    """The 5-step fit's losses within rtol 1e-4 of JAX's on the same mesh,
    and the final parameters within 1e-5 in norm per tensor."""
    jax_losses, jax_params, _ = jax_runs[name]
    losses = _losses(root, name)
    assert sorted(losses) == list(range(1, STEPS + 1))
    # rank 0 alone wrote the run's files: one record a step
    assert len((root / "p" / name / "metrics.jsonl").read_text().splitlines()) == STEPS
    np.testing.assert_allclose([losses[s] for s in sorted(losses)],
                               [jax_losses[s] for s in sorted(jax_losses)], rtol=1e-4)
    _assert_params_close(_restored(root, name, objective), jax_params)


@pytest.mark.parametrize("name", ["tp", "sp", "dpo"])
def test_mesh_fit_matches_jax(world, name):
    """The 5-step fit's losses within rtol 1e-4 of JAX's on the same mesh,
    and the final parameters within 1e-5 in norm per tensor."""
    root, jax_runs, ranks = world
    assert all(r["rcs"][:3] == [0, 0, 0] for r in ranks)
    _assert_fit_matches_jax(root, jax_runs, name, "DPO" if name == "dpo" else "CLM")


def test_vocab_parallel_ce_never_holds_the_full_vocab(world):
    """On `tensor 2` every chunk's logits are [chunk, V/2] and the local
    head [V/2, hidden] on every rank; the loss equals the replicated one
    within 1e-6 and so does d hidden; the per-row log-probs of DPO and
    ORPO within 1e-5. `shard_pytree` places by the rules."""
    _, _, ranks = world
    for r in ranks:
        probe = r["ce_probe"]
        assert probe["local_head"] == [32, 16]
        assert probe["widths"] and all(w[1] == 32 for w in probe["widths"])
        assert abs(probe["loss"] - probe["ref_loss"]) <= 1e-6
        assert probe["hidden_grad_err"] <= 1e-6
        assert probe["logps_err"] <= 1e-5 and probe["counts_equal"]
        # shard_pytree: (embed, mlp) -> (fsdp, tensor); a norm replicates
        assert probe["placed"] == {  # over (data, pipe, fsdp, expert, tensor, sequence)
            "w_up": [[8, 4], ["R", "R", "S0", "R", "S1", "R"]], "norm": [[16], ["R"] * 6]}


@pytest.mark.parametrize("name", [f[0] for f in OTHER_FITS])
def test_other_optimizers_and_orpo_on_a_mesh_match_one_process(world, one_process, name):
    """Adam, SGD with momentum and Lion on (fsdp 2, tensor 2), and ORPO on
    (fsdp 4), 5 steps: the losses within rtol 1e-4 of JAX's on the same
    mesh and the final parameters within 1e-5 of JAX's in norm per tensor
    (the optimizers' shard-local update, ORPO's batch sums and means); the
    losses within rtol 1e-5 of the same fit in one process."""
    root, jax_runs, ranks = world
    assert all(r["rcs"][5:9] == [0, 0, 0, 0] for r in ranks)
    _assert_fit_matches_jax(root, jax_runs, name)
    losses, single = _losses(root, name), _losses(one_process, f"{name}-one")
    assert sorted(losses) == sorted(single) == list(range(1, STEPS + 1))
    np.testing.assert_allclose([losses[s] for s in sorted(losses)],
                               [single[s] for s in sorted(single)], rtol=1e-5)


def test_moe_fit_under_fsdp2_matches_one_process(world):
    """The MoE fit on (fsdp 4), its expert stacks sharded on dim 0, gives
    the losses of the same fit in this one process (rtol 1e-5); on (fsdp 2,
    tensor 2) the MoE model raises naming A.9b on every rank."""
    root, _, ranks = world
    assert all(r["rcs"][9] == 0 for r in ranks)
    refusals = [r["rcs"][10] for r in ranks]
    assert all(isinstance(x, str) and "A.9b" in x and "MoE" in x for x in refusals)
    config = json.loads((root / "moe.json").read_text())
    config["trainer"].pop("mesh")
    config["trainer"].pop("checkpoint")
    config["trainer"]["loggers"][0]["init_args"]["name"] = "moe-one"
    (root / "moe-one.json").write_text(json.dumps(config))
    assert cli_main(["fit", "--config", str(root / "moe-one.json"), "--device", "cpu"]) == 0
    losses, single = _losses(root, "moe"), _losses(root, "moe-one")
    assert sorted(losses) == sorted(single) == list(range(1, STEPS + 1))
    np.testing.assert_allclose([losses[s] for s in sorted(losses)],
                               [single[s] for s in sorted(single)], rtol=1e-5)


def test_bucketed_moe_on_a_mesh_keeps_the_global_batch_s_rows(world):
    """`moe_impl: bucketed` on (fsdp 4) with capacity factor 1: each
    expert's capacity is the global batch's and a rank keeps the rows whose
    place in their expert's global queue is under it, as JAX's buckets over
    the global batch do. The 5-step fit's losses within rtol 1e-4 of JAX's
    `Trainer` on the same mesh, and the dropped rows of every step equal
    JAX's (the global count, on every rank). On (fsdp 2, sequence 2), whose
    ranks hold no contiguous run of the global order, it raises naming
    A.9b."""
    root, jax_runs, ranks = world
    assert all(r["rcs"][11] == 0 for r in ranks)
    jax_losses, _, jax_dropped = jax_runs["moe-bucketed"]
    losses, dropped = _losses(root, "moe-bucketed"), _losses(root, "moe-bucketed", "ep_dropped_rows")
    assert sorted(losses) == sorted(dropped) == list(range(1, STEPS + 1))
    np.testing.assert_allclose([losses[s] for s in sorted(losses)],
                               [jax_losses[s] for s in sorted(jax_losses)], rtol=1e-4)
    assert [dropped[s] for s in sorted(dropped)] == [jax_dropped[s] for s in sorted(jax_dropped)]
    assert all(d > 0 for d in dropped.values())
    refusals = [r["rcs"][12] for r in ranks]
    assert all(isinstance(x, str) and "A.9b" in x and "bucketed" in x for x in refusals)


def test_adafactor_on_more_than_one_rank_names_a9b(world):
    _, _, ranks = world
    refusals = [r["rcs"][len(r["rcs"]) - 2] for r in ranks]
    assert all(isinstance(x, str) and "A.9b" in x and "Adafactor" in x for x in refusals)


def test_resume_onto_other_degrees_matches_the_uninterrupted_run(world):
    """Saved on (fsdp 4) at step 2 and resumed on (fsdp 2, tensor 2): steps
    3-5 within rtol 1e-4 of the uninterrupted run's (and of JAX's)."""
    root, jax_runs, ranks = world
    assert all(r["rcs"][3:5] == [0, 0] for r in ranks)
    first, resumed, straight = _losses(root, "resume-a"), _losses(root, "resume-b"), _losses(root, "tp")
    assert sorted(first) == [1, 2] and sorted(resumed) == [3, 4, 5]
    np.testing.assert_allclose([first[1], first[2]], [straight[1], straight[2]], rtol=1e-4)
    np.testing.assert_allclose([resumed[s] for s in (3, 4, 5)],
                               [straight[s] for s in (3, 4, 5)], rtol=1e-4)
    np.testing.assert_allclose([resumed[s] for s in (3, 4, 5)],
                               [jax_runs["tp"][0][s] for s in (3, 4, 5)], rtol=1e-4)
    meta = json.loads((root / "resume-ckpt" / "step_5" / "meta.json").read_text())
    assert meta["topology"] == {"device_count": 4, "mesh": {
        "data": 1, "pipe": 1, "fsdp": 2, "expert": 1, "tensor": 2, "sequence": 1}}


def test_sigterm_to_one_rank_stops_every_rank_after_the_same_step(world):
    """SIGTERM to rank 2 at step 3: every rank's fit returns 75, the
    emergency checkpoint of step 3 is committed, and no step after 3 ran."""
    root, _, ranks = world
    assert [r["rcs"][-1] for r in ranks] == [75, 75, 75, 75]
    assert sorted(_losses(root, "sigterm")) == [1, 2, 3]
    assert (root / "sigterm-ckpt" / "step_3" / "meta.json").exists()
    assert not (root / "sigterm-ckpt" / "step_4").exists()


def test_validate_and_generate_read_the_mesh_checkpoint_on_one_process(world, capsys):
    """`validate` and `generate` restore the (fsdp 2, tensor 2) checkpoint
    onto this one process: JAX's val_loss of its final parameters (rtol
    1e-4) and its greedy tokens."""
    root, jax_runs, _ = world
    _, jax_params, jax_objective = jax_runs["tp"]
    data = JaxDummy(JaxDummyConfig(**DATA))
    data.setup()
    losses, weights = [], []
    for i, batch in enumerate(data.val_batches()):
        if i >= 2:
            break
        _, metrics = jax_objective.loss_and_metrics(
            jax_params, {k: np.asarray(v) for k, v in batch.items()}, train=False)
        losses.append(float(metrics["loss"]))
        weights.append(float(metrics["target_tokens"]))
    expected_val = float(np.average(losses, weights=weights))
    config = str(root / "tp.json")
    assert cli_main(["validate", "--config", config, "--device", "cpu"]) == 0
    val = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["val_loss"]
    np.testing.assert_allclose(val, expected_val, rtol=1e-4)

    variables = jax_params if "params" in jax_params else {"params": jax_params}
    engine = JaxEngine(JaxLlama(JaxLlamaConfig(**TINY)), variables)
    want = engine.generate(PROMPTS, JaxGenerateConfig(max_new_tokens=6))["tokens"]
    args = ["generate", "--config", config, "--device", "cpu", "--max-new-tokens", "6"]
    for prompt in PROMPTS:
        args += ["--prompt-tokens", ",".join(map(str, prompt))]
    assert cli_main(args) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert [line["tokens"] for line in lines if "tokens" in line] == want
