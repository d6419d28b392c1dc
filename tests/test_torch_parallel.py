"""The port's mesh and sharding rules against JAX's `parallel/` package, in
process: `resolve_axis_sizes`, `MeshConfig`, `logical_to_spec` and
`resolve_spec` (drops and strict errors) give JAX's answers on the cases
of `tests/test_parallel.py` (equal); `initialize_distributed`'s intent
rules mirror `tests/test_multihost.py` with torchrun's and SLURM's
variables; the Llama and Phi-3 parameters' logical names equal the names
on JAX's abstract state; every example config's trainer node builds (its
mesh with JAX's degrees) and its model node gets as far as its missing HF
directory."""

from pathlib import Path

import flax.linen as nn
import jax
import numpy as np
import pytest
import yaml
from jax.sharding import PartitionSpec

import llm_training_tpu_torch.parallel.mesh as mesh_mod
from llm_training_tpu.models import Llama as JaxLlama
from llm_training_tpu.models import LlamaConfig as JaxLlamaConfig
from llm_training_tpu.models.phi3 import Phi3 as JaxPhi3
from llm_training_tpu.models.phi3 import Phi3Config as JaxPhi3Config
from llm_training_tpu.parallel import sharding as jax_sharding
from llm_training_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from llm_training_tpu.parallel.mesh import resolve_axis_sizes as jax_resolve
from llm_training_tpu_torch.cli.config import instantiate_from_config
from llm_training_tpu_torch.dataclass_config import build_dataclass
from llm_training_tpu_torch.models.llama.config import LlamaConfig
from llm_training_tpu_torch.models.llama.from_jax import jax_layout, jax_path, parameter_names
from llm_training_tpu_torch.parallel import sharding
from llm_training_tpu_torch.parallel.mesh import (
    MESH_AXIS_NAMES,
    MeshConfig,
    _multi_host_intended,
    initialize_distributed,
    resolve_axis_sizes,
)
from llm_training_tpu_torch.trainer.trainer import Trainer, TrainerConfig

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = sorted((ROOT / "config" / "examples").glob("*/*.yaml"))


def _outcome(fn, *args, **kwargs):
    try:
        return ("ok", fn(*args, **kwargs))
    except (ValueError, NotImplementedError) as e:
        return (type(e).__name__, str(e))


# ---------------------------------------------------------------- the mesh


MESH_CASES = [
    (dict(tensor_parallel_size=2), 8),
    (dict(), 8),
    (dict(tensor_parallel_size=3), 8),
    (dict(data_parallel_size=-1, fsdp_size=-1), 8),
    (dict(data_parallel_size=2, fsdp_size=2, tensor_parallel_size=1), 8),
    (dict(fsdp_size=2, tensor_parallel_size=2, sequence_parallel_size=2), 8),
    (dict(data_parallel_size=-1, fsdp_size=1, tensor_parallel_size=2), 4),
    (dict(fsdp_size=0), 4),
    (dict(pipeline_parallel_size=2, expert_parallel_size=2, fsdp_size=-1), 8),
]


@pytest.mark.parametrize("kwargs,devices", MESH_CASES)
def test_resolve_axis_sizes_gives_jax_answers(kwargs, devices):
    """The same degrees, or the same error message, as JAX's."""
    assert _outcome(resolve_axis_sizes, MeshConfig(**kwargs), devices) == _outcome(
        jax_resolve, JaxMeshConfig(**kwargs), devices)


def test_mesh_config_fields_and_round_trip():
    """JAX's six fields, defaults and axis order; `from_axis_sizes` inverts
    `axis_sizes`; a non-int size raises."""
    assert MeshConfig().axis_sizes() == JaxMeshConfig().axis_sizes()
    assert tuple(MeshConfig().axis_sizes()) == MESH_AXIS_NAMES == mesh_mod.MESH_AXIS_NAMES
    sizes = {"data": 2, "pipe": 1, "fsdp": 2, "expert": 1, "tensor": 2, "sequence": 1}
    assert MeshConfig.from_axis_sizes(sizes).axis_sizes() == sizes == (
        JaxMeshConfig.from_axis_sizes(sizes).axis_sizes())
    with pytest.raises(ValueError, match="must be an int"):
        MeshConfig(fsdp_size="2")


LOGICAL_CASES = [
    ("embed", "mlp"), ("vocab", "embed"), ("norm",), ("batch", "act_seq", "act_embed"),
    ("heads", "mlp"), ("embed", "heads"), ("mlp", "embed"), ("layers", "embed", "kv_heads"),
    ("stages", "layers", "embed", "mlp"), ("expert", "embed", "mlp"), (None, "vocab"),
    ("batch", "embed"), ("act_heads", "heads"),
]


def _jax_spec(spec: PartitionSpec) -> tuple:
    return tuple(tuple(x) if isinstance(x, (list, tuple)) else x for x in spec)


@pytest.mark.parametrize("axes", LOGICAL_CASES, ids=["-".join(map(str, a)) for a in LOGICAL_CASES])
def test_logical_to_spec_and_drops_give_jax_answers(axes):
    """The same spec per dimension and the same AxisDrop warnings (the
    table as the trainer uses it: 'layers' replicated)."""
    rules = tuple(jax_sharding.DEFAULT_LOGICAL_AXIS_RULES) + (("layers", None),)
    spec, drops = sharding.resolve_spec(axes, rules, path="p")
    jspec, jdrops = jax_sharding.resolve_spec(axes, rules, path="p")
    assert spec == _jax_spec(jspec)
    assert [(d.axis, d.mesh_axes, d.position, d.path) for d in drops] == [
        (d.axis, tuple(d.mesh_axes), d.position, d.path) for d in jdrops]
    assert sharding.logical_to_spec(axes, rules) == _jax_spec(jax_sharding.logical_to_spec(axes, rules))


def test_rules_and_registry_equal_jax():
    assert sharding.KNOWN_LOGICAL_AXES == jax_sharding.KNOWN_LOGICAL_AXES
    assert [(n, a if isinstance(a, (str, type(None))) else tuple(a))
            for n, a in sharding.DEFAULT_LOGICAL_AXIS_RULES] == [
        (n, a if isinstance(a, (str, type(None))) else tuple(a))
        for n, a in jax_sharding.DEFAULT_LOGICAL_AXIS_RULES]


def test_strict_resolution_raises_naming_the_leaf():
    """An unknown name raises UnknownLogicalAxisError with the path, as
    JAX's does; without strict it replicates."""
    for module in (sharding, jax_sharding):
        with pytest.raises(module.UnknownLogicalAxisError, match="'embd' on leaf 'w'") as info:
            module.resolve_spec(("embd", "mlp"), strict=True, path="w")
        assert info.value.axis == "embd" and info.value.path == "w"
    assert sharding.logical_to_spec(("embd", "mlp")) == (None, "tensor")
    with pytest.raises(sharding.UnknownLogicalAxisError, match="model.extra.weight"):
        sharding.param_logical_axes("model.extra.weight")


@pytest.mark.parametrize("family", ["llama", "phi3"])
def test_parameter_logical_names_equal_jax(family):
    """The port's table gives, for every parameter of the model, the
    logical names JAX's abstract state carries on its leaf (the scanned
    stack's leading 'layers' aside)."""
    kw = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, compute_dtype="float32",
              param_dtype="float32")
    cls, config = ((JaxLlama, JaxLlamaConfig(**kw)) if family == "llama"
                   else (JaxPhi3, JaxPhi3Config(**kw)))
    abstract = jax.eval_shape(lambda: cls(config).init(jax.random.key(0), np.zeros((1, 4), np.int32)))
    leaves = jax.tree_util.tree_flatten_with_path(
        nn.get_partition_spec(abstract), is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    jax_names = {"/".join(str(getattr(k, "key", k)) for k in path): tuple(spec)
                 for path, spec in leaves}
    names = parameter_names(LlamaConfig(**kw))
    seen = set()
    for name in names:
        _, layer, _ = jax_layout(name)
        path = jax_path(name)
        want = jax_names[path]
        if layer is not None:
            assert want[0] == "layers"
            want = want[1:]
        assert sharding.param_logical_axes(name) == want, name
        seen.add(path)
    assert seen == set(jax_names)


def test_tensor_parallel_plan_from_the_table():
    """Colwise where the output dim is heads/kv_heads/mlp/vocab, rowwise
    where the input dim is heads/mlp, the embedding sharded on vocab."""
    from torch.distributed.tensor.parallel import ColwiseParallel, RowwiseParallel

    from llm_training_tpu_torch.models.llama.model import Llama

    model = Llama(LlamaConfig(vocab_size=64, hidden_size=32, intermediate_size=64,
                              num_hidden_layers=1, num_attention_heads=4, num_key_value_heads=2,
                              compute_dtype="float32", param_dtype="float32"), device="meta")
    plan = sharding.tensor_parallel_plan(model)
    kinds = {k: type(v).__name__ for k, v in plan.items()}
    layer = "model.layers.0."
    assert kinds == {
        "model.embed_tokens": "RowwiseParallel", "lm_head": "ColwiseParallel",
        **{layer + f"self_attn.{p}": "ColwiseParallel" for p in ("q_proj", "k_proj", "v_proj")},
        layer + "self_attn.o_proj": "RowwiseParallel",
        layer + "mlp.gate_proj": "ColwiseParallel", layer + "mlp.up_proj": "ColwiseParallel",
        layer + "mlp.down_proj": "RowwiseParallel",
    }
    assert all(v.use_local_output for v in plan.values()
               if isinstance(v, (ColwiseParallel, RowwiseParallel)))


# ---------------------------------------------------------------- rendezvous


TORCHRUN_AND_SLURM = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
                      "SLURM_NTASKS", "SLURM_PROCID", "SLURM_LOCALID")


@pytest.fixture
def clean_env(monkeypatch):
    for name in TORCHRUN_AND_SLURM:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(mesh_mod.dist, "is_initialized", lambda: False)
    return monkeypatch


class _InitRecorder:
    def __init__(self, fail=False):
        self.calls, self.fail = [], fail

    def __call__(self, backend, **kwargs):
        self.calls.append(dict(backend=backend, **kwargs))
        if self.fail:
            raise RuntimeError("rendezvous failed")


def test_single_process_not_multi_host(clean_env):
    assert not _multi_host_intended(None)


@pytest.mark.parametrize("env,value", [("WORLD_SIZE", "4"), ("SLURM_NTASKS", "16")])
def test_multi_host_intent_from_env(clean_env, env, value):
    clean_env.setenv(env, value)
    assert _multi_host_intended(None)


def test_multi_host_intent_from_arg(clean_env):
    assert _multi_host_intended("10.0.0.1:1234")


@pytest.mark.parametrize("env", ["WORLD_SIZE", "SLURM_NTASKS"])
def test_single_task_not_multi_host(clean_env, env):
    clean_env.setenv(env, "1")
    assert not _multi_host_intended(None)


def test_torchrun_env_composes_coordinates(clean_env):
    for name, value in (("WORLD_SIZE", "4"), ("RANK", "3"), ("LOCAL_RANK", "1"),
                        ("MASTER_ADDR", "head"), ("MASTER_PORT", "29500")):
        clean_env.setenv(name, value)
    rec = _InitRecorder()
    clean_env.setattr(mesh_mod.dist, "init_process_group", rec)
    info = initialize_distributed(backend="gloo")
    assert rec.calls == [dict(backend="gloo", init_method="env://", world_size=4, rank=3)]
    assert (info.rank, info.world_size, info.local_rank) == (3, 4, 1)


def test_slurm_env_composes_coordinates(clean_env):
    for name, value in (("SLURM_NTASKS", "16"), ("SLURM_PROCID", "5"), ("SLURM_LOCALID", "1"),
                        ("MASTER_ADDR", "head"), ("MASTER_PORT", "29500")):
        clean_env.setenv(name, value)
    rec = _InitRecorder()
    clean_env.setattr(mesh_mod.dist, "init_process_group", rec)
    info = initialize_distributed(backend="gloo")
    assert rec.calls == [dict(backend="gloo", init_method="env://", world_size=16, rank=5)]
    assert info.local_rank == 1


def test_explicit_args_override_env(clean_env):
    clean_env.setenv("WORLD_SIZE", "2")
    clean_env.setenv("RANK", "1")
    rec = _InitRecorder()
    clean_env.setattr(mesh_mod.dist, "init_process_group", rec)
    initialize_distributed(coordinator_address="fresh:9", num_processes=4, process_id=0,
                           backend="gloo")
    assert rec.calls == [dict(backend="gloo", init_method="tcp://fresh:9", world_size=4, rank=0)]


def test_single_process_makes_no_group(clean_env):
    rec = _InitRecorder()
    clean_env.setattr(mesh_mod.dist, "init_process_group", rec)
    info = initialize_distributed(backend="gloo")
    assert rec.calls == [] and info.world_size == 1


def test_failure_fatal_when_multi_host_intended(clean_env):
    clean_env.setenv("SLURM_NTASKS", "16")
    clean_env.setattr(mesh_mod.dist, "init_process_group", _InitRecorder(fail=True))
    with pytest.raises(RuntimeError, match="multi-process run detected"):
        initialize_distributed(backend="gloo")  # also: MASTER_ADDR is missing


def test_failure_tolerated_single_process(clean_env):
    clean_env.setattr(mesh_mod.dist, "init_process_group", _InitRecorder(fail=True))
    initialize_distributed(coordinator_address=None, num_processes=1, backend="gloo")


# ---------------------------------------------------------------- the examples


def _trainer_node(config: dict) -> dict:
    node = dict(config.get("trainer", {}))
    for key in ("checkpoint", "callbacks", "loggers"):
        node.pop(key, None)
    return node


@pytest.mark.parametrize("path", EXAMPLES, ids=[p.stem for p in EXAMPLES])
def test_example_trainer_and_model_nodes(path):
    """Every trainer node builds; a `trainer.mesh` node gives JAX's
    `MeshConfig` and JAX's degrees (or JAX's error) at 8 devices. The model
    node gets as far as before: the HF examples read their missing
    `hf_path`, the smoke's MoE model and rl-smoke build."""
    config = yaml.safe_load(path.read_text())
    trainer = build_dataclass(TrainerConfig, _trainer_node(config), "trainer")
    mesh = config["trainer"].get("mesh")
    if mesh is not None:
        assert trainer.mesh.axis_sizes() == JaxMeshConfig(**mesh).axis_sizes()
        assert _outcome(resolve_axis_sizes, trainer.mesh, 8) == _outcome(
            jax_resolve, JaxMeshConfig(**mesh), 8)
    objective = instantiate_from_config(config["model"])
    provider = objective.config.model
    if provider.model_class == "HFCausalLM":
        with pytest.raises(FileNotFoundError, match="/data/models/"):
            provider.model_config()
    elif path.stem == "cpu-smoke":
        assert provider.get_config().num_experts == 4
    else:
        provider.get_config()


def test_pipeline_stages_name_a9b():
    """llama-3-8b_pp_pt's mesh builds; a fit on it raises naming A.9b, and
    so does a model with pipeline stages."""
    config = yaml.safe_load((ROOT / "config/examples/llama-3/llama-3-8b_pp_pt.yaml").read_text())
    trainer_config = build_dataclass(TrainerConfig, _trainer_node(config), "trainer")
    assert trainer_config.mesh.pipeline_parallel_size == 4
    with pytest.raises(NotImplementedError, match="A.9b"):
        Trainer(trainer_config, device="cpu").fit(None, None)
    with pytest.raises(NotImplementedError, match="A.9b"):
        LlamaConfig(pipeline_stages=2)


@pytest.mark.parametrize("command", ["rl-fit", "supervise"])
@pytest.mark.parametrize("env", ["WORLD_SIZE", "SLURM_NTASKS"])
def test_one_process_commands_refuse_a_world(monkeypatch, command, env):
    """`rl-fit` and `supervise` launched as a world of several processes
    raise naming A.9b before they touch anything."""
    from llm_training_tpu_torch.cli.main import main as cli_main

    monkeypatch.setenv(env, "4")
    argv = [command, "--config", str(ROOT / "llm_training_tpu_torch/config/cpu-smoke.json")]
    with pytest.raises(NotImplementedError, match="A.9b"):
        cli_main(argv + (["--device", "cpu"] if command == "rl-fit" else []))
