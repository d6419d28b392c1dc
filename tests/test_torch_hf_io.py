"""Port parity of HF checkpoint I/O: the port's safetensors reader and
writer against JAX's `hf_io` in both directions (single file and shards,
fp32 and bf16; tensors equal, `config.json` equal as JSON), `transformers`
loading the port's export, the `model_type` routing and `config_from_hf`
against JAX's for every type of JAX's table, CLM, ORPO and DPO loading
their weights through `pre_trained_weights` and `HFCausalLM` equal to
JAX's loads, and `convert_to_hf` on a checkpoint of the port read back by
JAX (fp32, CPU)."""

import dataclasses
import json
import re

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import load_file

from llm_training_tpu.models import Llama as JaxLlama
from llm_training_tpu.models import LlamaConfig as JaxLlamaConfig
from llm_training_tpu.models import Phi3 as JaxPhi3
from llm_training_tpu.models import Phi3Config as JaxPhi3Config
from llm_training_tpu.models import hf_io as jax_hf_io
from llm_training_tpu.models.llama import hf_conversion as jax_llama_conv
from llm_training_tpu.models.phi3 import hf_conversion as jax_phi3_conv
from llm_training_tpu_torch.models import hf_io
from llm_training_tpu_torch.models.llama import hf_conversion as llama_conv
from llm_training_tpu_torch.models.llama.config import LlamaConfig
from llm_training_tpu_torch.models.llama.from_jax import state_dict_from_jax
from llm_training_tpu_torch.models.llama.model import Llama
from llm_training_tpu_torch.models.phi3 import Phi3, Phi3Config
from llm_training_tpu_torch.models.phi3 import hf_conversion as phi3_conv
from torch_llama_variant_cases import EXPORTED_TYPES, FP32, hf_config

TOL = dict(rtol=1e-4, atol=1e-4)
WIDTHS = dict(vocab_size=128, hidden_size=64, intermediate_size=112, num_hidden_layers=3,
              num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
              compute_dtype="float32", param_dtype="float32")
FAMILIES = {
    "llama": (JaxLlama, JaxLlamaConfig, Llama, LlamaConfig, dict(rope_theta=500000.0)),
    "phi3": (JaxPhi3, JaxPhi3Config, Phi3, Phi3Config,
             dict(num_key_value_heads=4, sliding_window=16, bos_token_id=1, eos_token_id=2,
                  pad_token_id=0)),
}
SHARD_BYTES = 60_000  # several shards at these widths in fp32 and bf16


@pytest.fixture(scope="module")
def families():
    """Per family: the JAX model config, its variables, the parameter tree
    (numpy) and the port's config."""
    out = {}
    for name, (jax_cls, jax_config_cls, _, config_cls, extra) in FAMILIES.items():
        fields = {**WIDTHS, **extra}
        jax_config = jax_config_cls(**fields, attention_impl="xla")
        variables = jax_cls(jax_config).init(jax.random.key(0), np.zeros((1, 4), np.int32))
        params = jax.device_get(nn.meta.unbox(variables))
        out[name] = (jax_config, variables, params, config_cls(**fields))
    return out


def _state_dict(params, config) -> dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v) for k, v in state_dict_from_jax(params, config).items()}


def _tree_equal(a, b) -> None:
    jax.tree.map(lambda x, y: np.testing.assert_array_equal(np.asarray(x, np.float32),
                                                            np.asarray(y, np.float32)), a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shards", [False, True], ids=["single", "sharded"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_reader_and_writer_match_jax(families, tmp_path, family, shards, dtype):
    """JAX's export read by the port's `LazyStateDict` equals `safetensors`'
    own read, tensor for tensor; the port's export of the same weights has
    JAX's files, index and `config.json`, and JAX's `load_pretrained_params`
    reads it tensor-equal to its own export; the port reads both into its
    parameters equally."""
    jax_config, _, params, config = families[family]
    limit = SHARD_BYTES if shards else 5 * 1024**3
    theirs = jax_hf_io.save_hf_checkpoint(params, jax_config, tmp_path / "jax", dtype=dtype,
                                          max_shard_bytes=limit)
    ours = hf_io.save_hf_checkpoint(_state_dict(params, config), config, tmp_path / "port",
                                    dtype=dtype, max_shard_bytes=limit)
    files = sorted(p.name for p in theirs.iterdir())
    assert files == sorted(p.name for p in ours.iterdir())
    assert (len([f for f in files if f.endswith(".safetensors")]) > 1) == shards
    for name in files:
        if name.endswith(".json"):
            assert json.loads((ours / name).read_text()) == json.loads((theirs / name).read_text())
            continue
        expected = load_file(theirs / name)
        written = load_file(ours / name)
        read = hf_io.SafetensorsFile(theirs / name)
        assert set(read.keys()) == set(expected) == set(written)
        assert read.metadata == {"format": "pt"} == hf_io.SafetensorsFile(ours / name).metadata
        for key, tensor in expected.items():
            assert torch.equal(read.get_tensor(key), tensor), key
            assert written[key].dtype == tensor.dtype and torch.equal(written[key], tensor), key
    _tree_equal(jax_hf_io.load_pretrained_params(jax_config, ours),
                jax_hf_io.load_pretrained_params(jax_config, theirs))
    from_ours = hf_io.load_pretrained_params(config, ours)
    from_theirs = hf_io.load_pretrained_params(config, theirs)
    assert from_ours.keys() == from_theirs.keys() == _state_dict(params, config).keys()
    for key in from_ours:
        assert torch.equal(from_ours[key], from_theirs[key]), key


@pytest.mark.parametrize("where", ["file", "index", "glob"])
def test_lazy_state_dict_finds_files_as_jax(families, tmp_path, where):
    """A single file, a directory with an index, and a directory of loose
    shards (no index): the same keys and tensors as JAX's `LazyStateDict`."""
    jax_config, _, params, _ = families["llama"]
    out = jax_hf_io.save_hf_checkpoint(params, jax_config, tmp_path / "x", dtype="bfloat16",
                                       max_shard_bytes=SHARD_BYTES)
    path = out
    if where == "file":
        path = sorted(out.glob("*.safetensors"))[0]
    elif where == "glob":
        (out / "model.safetensors.index.json").unlink()
    ours, theirs = hf_io.LazyStateDict(path), jax_hf_io.LazyStateDict(path)
    assert sorted(ours) == sorted(theirs) and len(ours) == len(theirs)
    for key in theirs:
        assert torch.equal(ours[key], theirs[key]), key
    with pytest.raises(FileNotFoundError, match="no safetensors"):
        hf_io.LazyStateDict(tmp_path / "empty")


@pytest.mark.parametrize("family", sorted(FAMILIES) + list(EXPORTED_TYPES))
def test_transformers_loads_the_ports_export(families, tmp_path, family):
    """`transformers` loads the port's export of each family, and of each
    Llama-graph type that JAX's own tests load through it (random weights,
    biases and norms included), to logits equal to the port's."""
    transformers = pytest.importorskip("transformers")
    if family in FAMILIES:
        _, _, params, config = families[family]
        model = FAMILIES[family][2](config, device="cpu")
        model.load_state_dict(_state_dict(params, config))
    else:
        config = llama_conv.config_from_hf(hf_config(family), **FP32)
        model = Llama(config, device="cpu")
        gen = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for param in model.parameters():
                param.copy_(0.1 * torch.randn(param.shape, generator=gen))
    out = hf_io.save_hf_checkpoint(model.state_dict(), config, tmp_path / "export",
                                   dtype="float32")
    hf_model = transformers.AutoModelForCausalLM.from_pretrained(
        out, torch_dtype=torch.float32, attn_implementation="eager").eval()
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 128, (2, 20)))
    with torch.no_grad():
        theirs = hf_model(ids).logits
        ours = model.eval()(ids).logits
    np.testing.assert_allclose(ours.numpy(), theirs.numpy(), atol=2e-4, rtol=2e-3)


def test_routing_table_matches_jax():
    """Every model_type of JAX's table routes to JAX's class path, or raises
    naming the family and A.8 where the port lacks it; unknown types and
    `assume_llama_layout` as JAX."""
    assert hf_io._ARCH_TO_FAMILY == jax_hf_io._ARCH_TO_FAMILY
    lacking = set()
    for model_type, family in jax_hf_io._ARCH_TO_FAMILY.items():
        expected = jax_hf_io.model_class_for_hf({"model_type": model_type})
        if family in hf_io.PORTED_FAMILIES:
            assert hf_io.model_class_for_hf({"model_type": model_type}) == expected
            continue
        lacking.add(family.rsplit(".", 1)[1])
        with pytest.raises(NotImplementedError, match=f"{family.rsplit('.', 1)[1]}.*A\\.8"):
            hf_io.model_class_for_hf({"model_type": model_type})
    assert lacking == set()
    for call in (jax_hf_io.model_class_for_hf, hf_io.model_class_for_hf):
        with pytest.raises(ValueError, match="assume_llama_layout"):
            call({"model_type": "somebodys_llama_fork"})
        assert call({"model_type": "somebodys_llama_fork"}, assume_llama_layout=True) == (
            "llm_training_tpu.models.Llama")


# an HF config.json carrying every field any llama-family type reads
HF_FIELDS = dict(
    vocab_size=128, hidden_size=64, intermediate_size=112, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
    n_embd=64, n_inner=128, n_layer=2, n_head=4, n_positions=64, rms_norm_eps=1e-5,
    num_local_experts=4, num_experts=4, num_experts_per_tok=2, moe_intermediate_size=32,
    shared_expert_intermediate_size=48, shared_intermediate_size=48, sliding_window=16,
    rope_theta=500000.0, layer_types=["sliding_attention", "full_attention"],
    no_rope_layers=[1, 0], attention_multiplier=0.2, embedding_multiplier=2.0,
)


@pytest.mark.parametrize("model_type", sorted(
    t for t, f in jax_hf_io._ARCH_TO_FAMILY.items() if f == "llm_training_tpu.models.Llama"))
def test_config_from_hf_matches_jax(model_type, monkeypatch):
    """The fields `config_from_hf` sets equal JAX's (JAX's LlamaConfig
    replaced by a recorder), or both raise JAX's ValueError; the port's
    config then equals JAX's for every type, the 8 MoE types included."""
    hf = {**HF_FIELDS, "model_type": model_type}
    try:
        jax_config = jax_llama_conv.config_from_hf(hf).model_dump()
    except ValueError as e:
        jax_config = e  # the synthetic fields break one of JAX's checks
    monkeypatch.setattr(jax_llama_conv, "LlamaConfig", lambda **fields: fields)
    try:
        expected = jax_llama_conv.config_from_hf(hf)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e)[:40])):
            llama_conv.config_fields_from_hf(hf)
        return
    assert llama_conv.config_fields_from_hf(hf) == expected
    if isinstance(jax_config, ValueError):
        with pytest.raises(ValueError, match=re.escape(str(jax_config)[:40])):
            llama_conv.config_from_hf(hf)
        return
    assert dataclasses.asdict(llama_conv.config_from_hf(hf)) == jax_config


def test_phi3_config_round_trip_matches_jax(families, monkeypatch):
    _, _, _, config = families["phi3"]
    hf = phi3_conv.config_to_hf(config)
    jax_config = families["phi3"][0]
    assert hf == jax_phi3_conv.config_to_hf(jax_config)
    assert dataclasses.asdict(phi3_conv.config_from_hf(hf)) == {
        k: v for k, v in jax_phi3_conv.config_from_hf(hf).model_dump().items()
        if k in {f.name for f in dataclasses.fields(Phi3Config)}}
    monkeypatch.setattr(jax_phi3_conv, "Phi3Config", lambda **fields: fields)
    assert phi3_conv.config_fields_from_hf(hf, num_hidden_layers=1) == \
        jax_phi3_conv.config_from_hf(hf, num_hidden_layers=1)


@pytest.fixture(scope="module")
def hf_dirs(families, tmp_path_factory):
    """JAX exports of the llama family at two seeds, and of Phi-3 (fp32)."""
    root = tmp_path_factory.mktemp("hf")
    jax_config, _, params, _ = families["llama"]
    other = jax.device_get(nn.meta.unbox(JaxLlama(jax_config).init(
        jax.random.key(7), np.zeros((1, 4), np.int32))))
    return {
        "llama": jax_hf_io.save_hf_checkpoint(params, jax_config, root / "llama",
                                              dtype="float32"),
        "other": jax_hf_io.save_hf_checkpoint(other, jax_config, root / "other",
                                              dtype="float32"),
        "phi3": jax_hf_io.save_hf_checkpoint(families["phi3"][2], families["phi3"][0],
                                             root / "phi3", dtype="float32"),
    }


def _equal_to_jax_load(model, jax_config, path) -> None:
    expected = state_dict_from_jax(jax_hf_io.load_pretrained_params(jax_config, path),
                                   model.config)
    state = model.state_dict()
    assert state.keys() == expected.keys()
    for key, value in expected.items():
        assert torch.equal(state[key], torch.as_tensor(np.asarray(value))), key


@pytest.mark.parametrize("kind,where", [("CLM", "objective"), ("ORPO", "model"),
                                        ("CLM", "hf_causal_lm")])
def test_single_model_objectives_load_what_jax_loads(families, hf_dirs, kind, where):
    from llm_training_tpu_torch.cli.config import instantiate_from_config

    jax_config = families["llama"][0]
    kwargs = {k: v for k, v in WIDTHS.items()}
    node = {"model_class": "Llama", "model_kwargs": {**kwargs, "rope_theta": 500000.0}}
    init_args = {"model": node}
    path = str(hf_dirs["llama"])
    if where == "objective":
        init_args["pre_trained_weights"] = path
    elif where == "model":
        node["model_kwargs"]["pre_trained_weights"] = path
    else:
        init_args["model"] = {"model_class": "HFCausalLM", "model_kwargs": {
            "hf_path": path, "compute_dtype": "float32", "param_dtype": "float32"}}
    objective = instantiate_from_config({"class_path": f"llm_training_tpu.lms.{kind}",
                                         "init_args": init_args})
    model = objective.configure_model(torch.device("cpu"), torch.Generator().manual_seed(0))
    _equal_to_jax_load(model, jax_config, path)


def test_hf_causal_lm_reads_phi3_and_its_first_layers(families, hf_dirs):
    """HFCausalLM routes a phi3 config.json to `Phi3`, merges overrides, and
    `num_hidden_layers` reads the first layers of a deeper checkpoint."""
    from llm_training_tpu_torch.lms.base import ModelProvider

    provider = ModelProvider("HFCausalLM", {"hf_path": str(hf_dirs["phi3"]),
                                            "num_hidden_layers": 1,
                                            "param_dtype": "bfloat16"})
    config = provider.model_config()
    assert isinstance(config, Phi3Config) and config.sliding_window == 16
    assert config.pre_trained_weights == str(hf_dirs["phi3"])
    model = provider.get_model("cpu")
    assert isinstance(model, Phi3) and len(model.model.layers) == 1
    hf_io.load_pretrained_params(config, hf_dirs["phi3"], into=model.state_dict())
    full = _state_dict(families["phi3"][2], families["phi3"][3])
    for key, value in model.state_dict().items():
        assert torch.equal(value, full[key].to(torch.bfloat16)), key  # narrowed on the host


@pytest.mark.parametrize("ref", ["copy", "own_source"])
def test_dpo_loads_policy_and_reference_as_jax(families, hf_dirs, ref):
    """JAX's `DPO.pretrained_params`: one model and one source read once and
    placed twice (the reference an exact copy), or a `ref_model` with a
    source of its own read from there."""
    from jax.sharding import SingleDeviceSharding

    from llm_training_tpu.lms import DPO as JaxDPO
    from llm_training_tpu.lms import DPOConfig as JaxDPOConfig
    from llm_training_tpu.lms import ModelProvider as JaxModelProvider
    from llm_training_tpu_torch.lms.base import ModelProvider
    from llm_training_tpu_torch.lms.dpo import DPO, DPOConfig

    kwargs = {**WIDTHS, "rope_theta": 500000.0}
    source = str(hf_dirs["llama"])
    ref_kwargs = None
    if ref == "own_source":
        ref_kwargs = {**kwargs, "pre_trained_weights": str(hf_dirs["other"])}
    objective = DPO(DPOConfig(
        model=ModelProvider("Llama", kwargs), pre_trained_weights=source,
        ref_model=ref_kwargs and ModelProvider("Llama", ref_kwargs)))
    pair = objective.configure_model(torch.device("cpu"), torch.Generator().manual_seed(0))

    jax_objective = JaxDPO(JaxDPOConfig(
        model=JaxModelProvider(model_class="Llama", model_kwargs={**kwargs, "attention_impl": "xla"}),
        pre_trained_weights=source,
        ref_model=ref_kwargs and JaxModelProvider(model_class="Llama", model_kwargs=ref_kwargs)))
    host = jax_hf_io.load_pretrained_params(families["llama"][0], source)
    device = SingleDeviceSharding(jax.devices("cpu")[0])
    shardings = jax.tree.map(lambda _: device, host)
    dtypes = jax.tree.map(lambda _: jnp.float32, host)
    expected = jax_objective.pretrained_params({"policy": shardings, "ref": shardings},
                                               {"policy": dtypes, "ref": dtypes})
    for name, module in (("policy", pair.policy), ("ref", pair.ref)):
        want = state_dict_from_jax(jax.device_get(expected[name]), module.config)
        for key, value in module.state_dict().items():
            assert torch.equal(value, torch.as_tensor(np.asarray(want[key]))), (name, key)
    same = all(torch.equal(p, r) for p, r in zip(pair.policy.parameters(), pair.ref.parameters()))
    assert same == (ref == "copy")
    assert not any(p.requires_grad for p in pair.ref.parameters())


def test_convert_to_hf_round_trip(tmp_path):
    """A checkpoint of the port's `fit` converts; JAX loads the export and
    its logits equal the restored model's within 1e-4 (fp32)."""
    from llm_training_tpu_torch.cli.config import load_config
    from llm_training_tpu_torch.cli.main import build_fit
    from llm_training_tpu_torch.convert_to_hf import main as convert_main

    config = load_config("llm_training_tpu_torch/config/cpu-smoke.json", [
        f"run_root={tmp_path}", "trainer.max_steps=2", "trainer.val_check_interval=null",
        f'trainer.checkpoint={{"dirpath": "{tmp_path / "ckpt"}", "async_save": false}}',
    ])
    trainer, objective, data = build_fit(config, "cpu")
    state = trainer.fit(objective, data)
    assert convert_main([str(tmp_path / "ckpt"), str(tmp_path / "hf"), "--dtype",
                         "float32"]) == 0
    hf_config = jax_hf_io.load_hf_config(tmp_path / "hf")
    jax_config = jax_llama_conv.config_from_hf(hf_config, compute_dtype="float32",
                                               param_dtype="float32", attention_impl="xla")
    params = jax_hf_io.load_pretrained_params(jax_config, tmp_path / "hf")
    ids = np.random.default_rng(1).integers(0, 128, (2, 16)).astype(np.int32)
    expected = JaxLlama(jax_config).apply(params, jnp.asarray(ids)).logits
    with torch.no_grad():
        ours = state.model.eval()(torch.from_numpy(ids).long()).logits
    np.testing.assert_allclose(ours.numpy(), np.asarray(expected), **TOL)
