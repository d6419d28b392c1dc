"""Llama-graph <-> HuggingFace state-dict and config conversion.

Counterpart of `llm_training_tpu/models/llama/hf_conversion.py`. The
port's `Llama` carries JAX's tree in HF's Llama spelling
(`model.layers.{i}.self_attn.q_proj.weight`, torch's `[out, in]`), so most
tensors map one to one; the families that name or fuse them otherwise are
translated as JAX translates them:

- Phi-1/2 (`dense`, `fc1`/`fc2`, `final_layernorm`); GPT-NeoX / Pythia
  (`gpt_neox.` prefix, `embed_in`/`embed_out`, the per-head interleaved
  fused `query_key_value`, old checkpoints' buffers dropped); GPT-2
  (`transformer.`, `Conv1D` `[in, out]` weights, the fused `c_attn`,
  `wpe`); GLM's fused `gate_up_proj`; HunYuan's `query_layernorm` /
  `key_layernorm`; Apertus' `attention_layernorm` /
  `feedforward_layernorm` and its xIELU scalars (`mlp.act_fn.alpha_p`,
  with HF's constant `beta` / `eps` buffers written on export);
- `params_from_hf` reads layers `0..num_hidden_layers-1` (a deeper
  checkpoint gives its first layers, as in JAX) and hands each tensor to
  `leaf_fn` before it reads the next; `params_to_hf` writes JAX's key set
  in JAX's order;
- the MoE types' experts: per-expert matrices (qwen's `mlp.experts.{e}.
  gate_proj`, mixtral's `block_sparse_moe.experts.{e}.w1/w3/w2`) stacked
  into the port's `[E, H, I]` / `[E, I, H]` parameters, granite's
  pre-stacked, gate|up-fused `input_linear` split, and the shared expert
  (qwen2_moe's gated `shared_expert`, granitemoeshared's `shared_mlp`).

`config_from_hf` maps every HF `model_type` to the field values JAX's does
(`config_fields_from_hf`, the whole mapping; the port's `LlamaConfig`
runs all of them). `config_to_hf` refuses what no
HF architecture represents (`_check_exportable`, JAX's refusals) and
writes JAX's overlays: `llama`, `mistral`, `qwen2`, `qwen3`, `olmo`,
`olmo2`, `olmo3`, `exaone4`, `glm`, `glm4`, `ernie4_5`, `cohere`,
`cohere2`, `phi`, `hunyuan_v1_dense`, `nemotron`, `arcee`, `ministral`,
`starcoder2`, `gpt_neox`, `apertus`, `stablelm`, `smollm3`, `granite` and
`gpt2`, and the MoE overlays (`mixtral`, `phimoe`, `granitemoe`,
`granitemoeshared`, `qwen2_moe`, `qwen3_moe`, `olmoe`, `flex_olmo`).
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

import torch

from llm_training_tpu_torch.models.llama.config import LlamaConfig

LeafFn = Callable[[str, torch.Tensor], torch.Tensor]

# (the port's in-layer name, HF's in-layer name), in JAX's export order
_MATMULS = [(f"self_attn.{n}_proj.weight",) * 2 for n in "qkvo"] + [
    (f"mlp.{n}_proj.weight",) * 2 for n in ("gate", "up", "down")]
_GELU_MLP = [("mlp.c_fc.weight",) * 2, ("mlp.c_proj.weight",) * 2]
_NORMS = {
    "pre": ["input_layernorm", "post_attention_layernorm"],
    "post": ["post_attention_layernorm", "post_feedforward_layernorm"],
    "parallel": ["input_layernorm"],
    # NeoX's two parallel norms carry the pre scheme's names
    "parallel2": ["input_layernorm", "post_attention_layernorm"],
    "sandwich": ["input_layernorm", "post_self_attn_layernorm", "post_attention_layernorm",
                 "post_mlp_layernorm"],
}
_QKV_BIAS = [(f"self_attn.{n}_proj.bias",) * 2 for n in "qkv"]
_O_BIAS = [("self_attn.o_proj.bias",) * 2]
_QK_NORMS = [("self_attn.q_norm.weight",) * 2, ("self_attn.k_norm.weight",) * 2]
# HunYuan names its (post-rope) head norms differently
_QK_NORMS_HUNYUAN = [("self_attn.q_norm.weight", "self_attn.query_layernorm.weight"),
                     ("self_attn.k_norm.weight", "self_attn.key_layernorm.weight")]


def _uses_phi_naming(config: LlamaConfig) -> bool:
    """Phi-1/1.5/2: the parallel + biased-LayerNorm + gelu graph."""
    return (config.norm_scheme == "parallel" and config.norm_type == "layernorm"
            and config.mlp_type == "gelu")


def _uses_neox_naming(config: LlamaConfig) -> bool:
    """GPT-NeoX / Pythia: the two-norm parallel graph (or `neox_naming`)."""
    return config.neox_naming or (
        config.norm_scheme == "parallel2" and config.norm_type == "layernorm"
        and config.mlp_type == "gelu")


def _layer_params(config: LlamaConfig) -> list[tuple[str, str]]:
    """(port name, HF name) of one layer's tensors, JAX's `_layer_params`:
    matmuls, norms (with their biases), then biases and qk-norms. The GLM
    fused gate/up and the xIELU buffers are handled apart."""
    matmuls = list(_MATMULS)
    if config.fused_gate_up:
        matmuls = [p for p in matmuls if "gate_proj" not in p[0] and "up_proj" not in p[0]]
    if config.num_experts:
        # MoE layers have no dense MLP: `_moe_from_hf` / `_moe_to_hf_keys`
        matmuls = [p for p in matmuls if not p[0].startswith("mlp.")]
    elif config.mlp_type == "gelu":
        matmuls = [p for p in matmuls if not p[0].startswith("mlp.")] + _GELU_MLP
    elif config.mlp_type == "relu2":
        matmuls = [p for p in matmuls if "gate_proj" not in p[0]]
    elif config.mlp_type == "xielu":
        # Apertus: no gate; the activation's learnable scalars under act_fn
        matmuls = [p for p in matmuls if "gate_proj" not in p[0]] + [
            ("mlp.xielu_alpha_p", "mlp.act_fn.alpha_p"),
            ("mlp.xielu_alpha_n", "mlp.act_fn.alpha_n")]
    norms = [(f"{n}.weight",) * 2 for n in _NORMS[config.norm_scheme]]
    if config.norm_type == "layernorm_nonparam":
        norms = []  # OLMo-1: the norms own no parameters
    if config.mlp_type == "xielu":
        # Apertus names its pre-norms attention_/feedforward_layernorm
        norms = [("input_layernorm.weight", "attention_layernorm.weight"),
                 ("post_attention_layernorm.weight", "feedforward_layernorm.weight")]
    if config.norm_type in ("layernorm", "layernorm1p"):
        norms = norms + [(ours.replace(".weight", ".bias"), hf.replace(".weight", ".bias"))
                         for ours, hf in norms]
    extra = []
    if config.attention_bias:
        extra += _QKV_BIAS
    if config.attention_out_bias:
        extra += _O_BIAS
    if config.qk_norm:
        extra += _QK_NORMS_HUNYUAN if config.qk_norm_position == "post_rope" else _QK_NORMS
    if config.mlp_bias and not config.num_experts:
        # JAX's conversion lists the gelu MLP's only (ROADMAP C.41)
        projections = {"gelu": ("c_fc", "c_proj"),
                       "swiglu": ("gate_proj", "up_proj", "down_proj")}.get(
            config.mlp_type, ("up_proj", "down_proj"))
        extra += [(f"mlp.{name}.bias",) * 2 for name in projections]
    return matmuls + norms + extra


_PHI_RENAMES = [(".self_attn.o_proj.", ".self_attn.dense."), (".mlp.c_fc.", ".mlp.fc1."),
                (".mlp.c_proj.", ".mlp.fc2.")]
_NEOX_RENAMES = [(".self_attn.o_proj.", ".attention.dense."),
                 (".mlp.c_fc.", ".mlp.dense_h_to_4h."), (".mlp.c_proj.", ".mlp.dense_4h_to_h.")]
# buffers old Pythia checkpoints persist that carry no weights
_NEOX_DROPPED = (".attention.bias", ".attention.masked_bias", ".rotary_emb.inv_freq")


def canonical_keys(state_dict: Mapping[str, Any]) -> dict[str, str]:
    """`{name without the "model." prefix: the state dict's key}`: HF
    checkpoints are read with or without the prefix, as JAX reads them."""
    return {key.removeprefix("model."): key for key in state_dict}


def read(state_dict: Mapping[str, Any], keys: Mapping[str, str], name: str) -> torch.Tensor:
    """The tensor of canonical `name`; a missing key names the layout."""
    try:
        return state_dict[keys[name]]
    except KeyError:
        raise KeyError(
            f"HF checkpoint has no {name!r} (the key set of the config's family)"
        ) from None


class _Canonical(Mapping):
    """A lazy view of an HF state dict under the canonical names (HF's Llama
    spelling, no `model.` prefix): Phi's and GPT-NeoX's names translated,
    NeoX's fused `query_key_value` split per head (the last fused tensor
    read is kept for its other two parts)."""

    def __init__(self, state_dict: Mapping[str, Any], config: LlamaConfig):
        self.sd, self.config = state_dict, config
        self._keys = {}
        neox, phi = _uses_neox_naming(config), _uses_phi_naming(config)
        for key in state_dict:
            name = key.removeprefix("model.")
            if neox:
                name = name.removeprefix("gpt_neox.")
                if any(part in name for part in _NEOX_DROPPED):
                    continue
                if ".attention.query_key_value." in name:
                    prefix, kind = name.rsplit(".", 1)
                    base = prefix.replace(".attention.query_key_value", ".self_attn.{}_proj")
                    for j, part in enumerate("qkv"):
                        self._keys[f"{base.format(part)}.{kind}"] = (key, j)
                    continue
                name = {"embed_in.weight": "embed_tokens.weight",
                        "embed_out.weight": "lm_head.weight"}.get(name, name)
                if name.startswith("final_layer_norm."):
                    name = "norm." + name.removeprefix("final_layer_norm.")
                for ours, hf in _NEOX_RENAMES:
                    name = name.replace(hf, ours)
            elif phi:
                if name.startswith("final_layernorm."):
                    name = "norm." + name.removeprefix("final_layernorm.")
                for ours, hf in _PHI_RENAMES:
                    name = name.replace(hf, ours)
            self._keys[name] = (key, None)
        self._fused: tuple[str, torch.Tensor] | None = None

    def __getitem__(self, name: str) -> torch.Tensor:
        try:
            key, part = self._keys[name]
        except KeyError:
            raise KeyError(
                f"HF checkpoint has no {name!r} (the key set of the config's family)"
            ) from None
        if part is None:
            return self.sd[key]
        if self._fused is None or self._fused[0] != key:
            self._fused = (key, self.sd[key])
        fused = self._fused[1]
        heads, hd = self.config.num_attention_heads, self.config.resolved_head_dim
        return fused.reshape(heads, 3, hd, *fused.shape[1:])[:, part].reshape(
            heads * hd, *fused.shape[1:])

    def __iter__(self):
        return iter(self._keys)

    def __len__(self) -> int:
        return len(self._keys)


def _gpt2_from_hf(state_dict: Mapping[str, Any], config: LlamaConfig, put) -> None:
    """GPT-2: `transformer.` prefix, `Conv1D` weights stored `[in, out]`,
    the fused `c_attn` split into q/k/v columns, the `wpe` table."""
    keys = {k.removeprefix("transformer."): k for k in state_dict}

    def get(name: str) -> torch.Tensor:
        return read(state_dict, keys, name)

    put("model.embed_tokens.weight", get("wte.weight"))
    put("model.wpe.weight", get("wpe.weight"))
    put("model.norm.weight", get("ln_f.weight"))
    put("model.norm.bias", get("ln_f.bias"))
    embed = config.hidden_size
    for i in range(config.num_hidden_layers):
        p, h = f"model.layers.{i}.", f"h.{i}."
        w, b = get(h + "attn.c_attn.weight"), get(h + "attn.c_attn.bias")
        for j, proj in enumerate("qkv"):
            put(f"{p}self_attn.{proj}_proj.weight", w[:, j * embed:(j + 1) * embed].t())
            put(f"{p}self_attn.{proj}_proj.bias", b[j * embed:(j + 1) * embed])
        del w, b
        put(p + "self_attn.o_proj.weight", get(h + "attn.c_proj.weight").t())
        put(p + "self_attn.o_proj.bias", get(h + "attn.c_proj.bias"))
        for name in ("c_fc", "c_proj"):
            put(f"{p}mlp.{name}.weight", get(f"{h}mlp.{name}.weight").t())
            put(f"{p}mlp.{name}.bias", get(f"{h}mlp.{name}.bias"))
        for ours, hf in (("input_layernorm", "ln_1"), ("post_attention_layernorm", "ln_2")):
            put(f"{p}{ours}.weight", get(f"{h}{hf}.weight"))
            put(f"{p}{ours}.bias", get(f"{h}{hf}.bias"))


# the port's expert stack -> HF's per-expert module name, by moe_style
_MOE_EXPERT_NAMES = {
    "qwen": ("mlp", {"gate_proj": "gate_proj", "up_proj": "up_proj", "down_proj": "down_proj"}),
    "mixtral": ("block_sparse_moe", {"gate_proj": "w1", "up_proj": "w3", "down_proj": "w2"}),
}
_MOE_SHARED = ("gate_proj", "up_proj", "down_proj")


def _moe_from_hf(sd: Mapping[str, Any], config: LlamaConfig, i: int, put) -> None:
    """Layer i's MoE block from HF's keys (canonical, no `model.`): the
    router, the expert stacks (`[E, in, out]`: each HF `[out, in]` matrix
    transposed and stacked) and the shared expert (JAX's `[in, out]`)."""
    p = f"model.layers.{i}.mlp."
    inter = config.moe_intermediate_size
    si = config.shared_expert_intermediate_size
    if config.moe_style == "granite":
        # granite stacks its experts already and fuses gate|up (gate rows first)
        moe = f"layers.{i}.block_sparse_moe."
        put(p + "gate.weight", sd[moe + "router.layer.weight"])
        fused = sd[moe + "input_linear.weight"]  # [E, 2I, H]
        put(p + "experts_gate_proj", fused[:, :inter].transpose(1, 2).contiguous())
        put(p + "experts_up_proj", fused[:, inter:].transpose(1, 2).contiguous())
        del fused
        put(p + "experts_down_proj",
            sd[moe + "output_linear.weight"].transpose(1, 2).contiguous())  # [E, H, I]
        if si:
            shared = sd[f"layers.{i}.shared_mlp.input_linear.weight"]  # [2si, H]
            put(p + "shared_gate_proj", shared[:si].t().contiguous())
            put(p + "shared_up_proj", shared[si:].t().contiguous())
            put(p + "shared_down_proj",
                sd[f"layers.{i}.shared_mlp.output_linear.weight"].t().contiguous())
        return
    prefix, names = _MOE_EXPERT_NAMES[config.moe_style]
    put(p + "gate.weight", sd[f"layers.{i}.{prefix}.gate.weight"])
    for ours, hf in names.items():
        put(p + f"experts_{ours}", torch.stack([
            sd[f"layers.{i}.{prefix}.experts.{e}.{hf}.weight"].t()
            for e in range(config.num_experts)]))
    if si:
        for ours in _MOE_SHARED:
            put(p + f"shared_{ours}",
                sd[f"layers.{i}.mlp.shared_expert.{ours}.weight"].t().contiguous())
        put(p + "shared_expert_gate", sd[f"layers.{i}.mlp.shared_expert_gate.weight"].t().contiguous())


def _moe_to_hf_keys(params: Mapping[str, torch.Tensor], config: LlamaConfig, i: int,
                    out: dict) -> None:
    """The inverse of `_moe_from_hf` for layer i, in JAX's key order."""
    p, h = f"model.layers.{i}.mlp.", f"model.layers.{i}."
    si = config.shared_expert_intermediate_size
    if config.moe_style == "granite":
        out[h + "block_sparse_moe.router.layer.weight"] = params[p + "gate.weight"]
        out[h + "block_sparse_moe.input_linear.weight"] = torch.cat(
            [params[p + "experts_gate_proj"].transpose(1, 2),
             params[p + "experts_up_proj"].transpose(1, 2)], 1)
        out[h + "block_sparse_moe.output_linear.weight"] = (
            params[p + "experts_down_proj"].transpose(1, 2))
        if si:
            out[h + "shared_mlp.input_linear.weight"] = torch.cat(
                [params[p + "shared_gate_proj"].t(), params[p + "shared_up_proj"].t()])
            out[h + "shared_mlp.output_linear.weight"] = params[p + "shared_down_proj"].t()
        return
    prefix, names = _MOE_EXPERT_NAMES[config.moe_style]
    out[f"{h}{prefix}.gate.weight"] = params[p + "gate.weight"]
    for ours, hf in names.items():
        stacked = params[p + f"experts_{ours}"]
        for e in range(config.num_experts):
            out[f"{h}{prefix}.experts.{e}.{hf}.weight"] = stacked[e].t()
    if si:
        for ours in _MOE_SHARED:
            out[f"{h}mlp.shared_expert.{ours}.weight"] = params[p + f"shared_{ours}"].t()
        out[f"{h}mlp.shared_expert_gate.weight"] = params[p + "shared_expert_gate"].t()


def params_from_hf(
    state_dict: Mapping[str, Any], config: LlamaConfig, leaf_fn: LeafFn | None = None
) -> dict[str, torch.Tensor]:
    """HF state dict (a lazy mapping) -> the port's `Llama` state dict.
    `leaf_fn(name, tensor)` transforms each tensor as soon as it is read
    (`hf_io` places it on the device and drops the host copy)."""
    out: dict[str, torch.Tensor] = {}

    def put(name: str, value: torch.Tensor) -> None:
        out[name] = leaf_fn(name, value) if leaf_fn else value

    if config.position_embedding_type == "learned":
        _gpt2_from_hf(state_dict, config, put)
        return out
    sd = _Canonical(state_dict, config)
    put("model.embed_tokens.weight", sd["embed_tokens.weight"])
    if config.norm_type != "layernorm_nonparam":
        put("model.norm.weight", sd["norm.weight"])
    if config.norm_type in ("layernorm", "layernorm1p"):
        put("model.norm.bias", sd["norm.bias"])
    if not config.tie_word_embeddings:
        put("lm_head.weight", sd["lm_head.weight"])
        if config.lm_head_bias:
            put("lm_head.bias", sd["lm_head.bias"])
    layer_params = _layer_params(config)
    inter = config.intermediate_size
    for i in range(config.num_hidden_layers):
        for ours, hf in layer_params:
            put(f"model.layers.{i}.{ours}", sd[f"layers.{i}.{hf}"])
        if config.num_experts:
            _moe_from_hf(sd, config, i, put)
        if config.fused_gate_up:
            # GLM stores gate|up as one [2I, H] tensor (gate rows first)
            fused = sd[f"layers.{i}.mlp.gate_up_proj.weight"]
            put(f"model.layers.{i}.mlp.gate_proj.weight", fused[:inter])
            put(f"model.layers.{i}.mlp.up_proj.weight", fused[inter:])
            del fused
    return out


def _gpt2_to_hf(params: Mapping[str, torch.Tensor], config: LlamaConfig) -> dict:
    out = {"transformer.wte.weight": params["model.embed_tokens.weight"],
           "transformer.wpe.weight": params["model.wpe.weight"],
           "transformer.ln_f.weight": params["model.norm.weight"],
           "transformer.ln_f.bias": params["model.norm.bias"]}
    for i in range(config.num_hidden_layers):
        p, h = f"model.layers.{i}.", f"transformer.h.{i}."
        out[h + "attn.c_attn.weight"] = torch.cat(
            [params[f"{p}self_attn.{n}_proj.weight"].t() for n in "qkv"], dim=1)
        out[h + "attn.c_attn.bias"] = torch.cat(
            [params[f"{p}self_attn.{n}_proj.bias"] for n in "qkv"])
        out[h + "attn.c_proj.weight"] = params[p + "self_attn.o_proj.weight"].t()
        out[h + "attn.c_proj.bias"] = params[p + "self_attn.o_proj.bias"]
        for name in ("c_fc", "c_proj"):
            out[f"{h}mlp.{name}.weight"] = params[f"{p}mlp.{name}.weight"].t()
            out[f"{h}mlp.{name}.bias"] = params[f"{p}mlp.{name}.bias"]
        for ours, hf in (("input_layernorm", "ln_1"), ("post_attention_layernorm", "ln_2")):
            out[f"{h}{hf}.weight"] = params[f"{p}{ours}.weight"]
            out[f"{h}{hf}.bias"] = params[f"{p}{ours}.bias"]
    return out


def _to_neox(out: dict[str, torch.Tensor], config: LlamaConfig) -> dict[str, torch.Tensor]:
    """JAX's `_canonical_to_neox_state_dict`: NeoX's names, q/k/v fused per
    head into `query_key_value` (appended after the other keys)."""
    heads, hd = config.num_attention_heads, config.resolved_head_dim
    renamed: dict[str, torch.Tensor] = {}
    fused: dict[str, dict[str, torch.Tensor]] = {}
    for key, value in out.items():
        key = key.removeprefix("model.")
        match = None
        for part in "qkv":
            tag = f".self_attn.{part}_proj."
            if tag in key:
                match = (key.replace(tag, ".attention.query_key_value."), part)
        if match is not None:
            fused.setdefault(match[0], {})[match[1]] = value
            continue
        if key == "embed_tokens.weight":
            key = "embed_in.weight"
        elif key == "lm_head.weight":
            key = "embed_out.weight"
        elif key.startswith("norm."):
            key = "final_layer_norm." + key.removeprefix("norm.")
        else:
            for ours, hf in _NEOX_RENAMES:
                key = key.replace(ours, hf)
        renamed[key if key.startswith("embed_out") else "gpt_neox." + key] = value
    for key, parts in fused.items():
        stacked = torch.stack(
            [parts[n].reshape(heads, hd, *parts[n].shape[1:]) for n in "qkv"], dim=1)
        renamed["gpt_neox." + key] = stacked.reshape(heads * 3 * hd, *parts["q"].shape[1:])
    return renamed


def params_to_hf(params: Mapping[str, torch.Tensor], config: LlamaConfig) -> dict[str, torch.Tensor]:
    """The port's `Llama` state dict -> HF's keys of the config's family,
    in JAX's order (embeddings, final norm, head, then each layer parameter
    over depth; the family's fused and renamed keys as JAX places them)."""
    if config.position_embedding_type == "learned":
        return _gpt2_to_hf(params, config)
    names = [("model.embed_tokens.weight",) * 2]
    if config.norm_type != "layernorm_nonparam":
        names.append(("model.norm.weight",) * 2)
    if config.norm_type in ("layernorm", "layernorm1p"):
        names.append(("model.norm.bias",) * 2)
    if not config.tie_word_embeddings:
        names.append(("lm_head.weight",) * 2)
        if config.lm_head_bias:
            names.append(("lm_head.bias",) * 2)
    for ours, hf in _layer_params(config):
        names += [(f"model.layers.{i}.{ours}", f"model.layers.{i}.{hf}")
                  for i in range(config.num_hidden_layers)]
    out = {hf: params[ours] for ours, hf in names}
    if config.mlp_type == "xielu":
        # HF registers beta and eps as persistent (constant) buffers
        for i in range(config.num_hidden_layers):
            out[f"model.layers.{i}.mlp.act_fn.beta"] = torch.tensor([0.5], dtype=torch.bfloat16)
            out[f"model.layers.{i}.mlp.act_fn.eps"] = torch.tensor([-1e-6], dtype=torch.bfloat16)
    if config.num_experts:
        for i in range(config.num_hidden_layers):
            _moe_to_hf_keys(params, config, i, out)
    if config.fused_gate_up:
        for i in range(config.num_hidden_layers):
            p = f"model.layers.{i}.mlp."
            out[p + "gate_up_proj.weight"] = torch.cat(
                [params[p + "gate_proj.weight"], params[p + "up_proj.weight"]])
    if _uses_phi_naming(config):
        renamed = {}
        for key, value in out.items():
            if key.startswith("model.norm."):
                key = "model.final_layernorm." + key.removeprefix("model.norm.")
            for ours, hf in _PHI_RENAMES:
                key = key.replace(ours, hf)
            renamed[key] = value
        out = renamed
    if _uses_neox_naming(config):
        out = _to_neox(out, config)
    return out


def _derived_no_rope(layer_types) -> list[int]:
    """EXAONE-4's and Cohere2's rule: sliding layers rotate (1), full
    layers skip rope (0)."""
    return [1 if lt == "sliding_attention" else 0 for lt in layer_types]


def _check_exportable(config: LlamaConfig) -> None:
    """Refuse feature combinations no HF architecture represents — a silent
    plain-llama fallthrough would reload with random-initialized modules."""
    if config.position_embedding_type == "learned":
        is_gpt2 = (
            config.norm_type == "layernorm" and config.mlp_type == "gelu"
            and config.norm_scheme == "pre" and config.tie_word_embeddings
            and config.attention_bias and config.attention_out_bias
            and config.mlp_bias
            and config.num_key_value_heads == config.num_attention_heads
            and not config.qk_norm and not config.rope_interleaved
            # GPT-2 derives head_dim as n_embd / n_head; a custom value
            # would contradict the exported tensor shapes
            and config.resolved_head_dim
            == config.hidden_size // config.num_attention_heads
            # no feature GPT-2 cannot represent may ride along
            and config.sliding_window is None and config.logit_scale is None
            and config.clip_qkv is None and not config.fused_gate_up
            and config.partial_rotary_factor == 1.0
            and not config.lm_head_bias and config.num_experts is None
            and config.embedding_multiplier == 1.0
            and config.attention_multiplier is None
            and config.residual_multiplier == 1.0
            and config.logits_scaling == 1.0
        )
        if not is_gpt2:
            raise ValueError(
                "position_embedding_type='learned' only exists in HF as GPT-2 "
                "(tied, fully-biased MHA + LayerNorm + gelu under pre-norm); "
                "this combination cannot be exported"
            )
        return  # the gpt2 export path handles everything else
    ln_gelu = config.norm_type == "layernorm" and config.mlp_type == "gelu"
    # biased LayerNorm with a SWIGLU mlp exists as StableLM in HF
    # (pre-norm, bias-free o_proj, optional qkv bias, partial rotary)
    is_stablelm = (
        config.norm_type == "layernorm" and config.mlp_type == "swiglu"
        and config.norm_scheme == "pre" and not config.qk_norm
        and not config.attention_out_bias and not config.mlp_bias
        and not config.rope_interleaved and config.num_experts is None
        # StableLM has no sliding windows, layer patterns, or granite
        # multipliers; any of those riding along would be silently dropped
        and config.sliding_window is None and config.layer_types is None
        and config.embedding_multiplier == 1.0
        and config.attention_multiplier is None
        and config.residual_multiplier == 1.0
        and config.logits_scaling == 1.0
    )
    is_phimoe = (
        config.norm_type == "layernorm" and config.mlp_type == "swiglu"
        and config.norm_scheme == "pre" and not config.qk_norm
        and config.num_experts is not None
        and config.moe_style == "mixtral"
        and config.moe_router_impl == "sparsemixer"
        and config.layer_types is None
        and not config.rope_interleaved
    )
    if config.moe_router_impl == "sparsemixer" and not is_phimoe:
        raise ValueError(
            "sparsemixer routing only exists in HF as Phimoe (biased "
            "LayerNorm pre-norm blocks + mixtral expert naming); exporting "
            "any other combination would silently reload with softmax "
            "routing"
        )
    if (config.mlp_type == "gelu") != ln_gelu or (
        (config.norm_type == "layernorm") != ln_gelu
        and not is_stablelm and not is_phimoe
    ):
        raise ValueError(
            "mlp_type='gelu' and norm_type='layernorm' only exist together "
            "(as Starcoder2 or Phi) in HF — except biased LayerNorm with "
            "swiglu, which is StableLM (dense) or Phimoe (SparseMixer MoE); "
            "this combination cannot be exported"
        )
    is_nemotron = (
        config.norm_type == "layernorm1p" and config.mlp_type == "relu2"
        and config.norm_scheme == "pre"
        and not config.qk_norm  # HF Nemotron has no q/k norms
    )
    # relu2 under plain RMSNorm pre-norm blocks exists as Arcee in HF
    # (which biases all four attention projections with ONE flag)
    is_arcee = (
        config.norm_type == "rmsnorm" and config.mlp_type == "relu2"
        and config.norm_scheme == "pre" and not config.qk_norm
        and not config.rope_interleaved and config.partial_rotary_factor == 1.0
        and config.num_experts is None
        and config.attention_bias == config.attention_out_bias
    )
    if (
        config.mlp_type == "relu2" or config.norm_type == "layernorm1p"
    ) and not (is_nemotron or is_arcee):
        raise ValueError(
            "mlp_type='relu2' exists in HF only as Nemotron (with "
            "norm_type='layernorm1p') or Arcee (with rmsnorm), both under "
            "pre-norm without qk-norm; this combination cannot be exported"
        )
    if (
        config.layer_types is not None and config.norm_scheme == "pre"
        and (config.attention_bias or config.attention_out_bias or config.qk_norm)
    ):
        raise ValueError(
            "a per-layer sliding/full pattern under pre-norm only exists as "
            "Ministral in HF (bias-free, no qk-norm); this combination "
            "cannot be exported"
        )
    if (
        config.rope_interleaved and not config.fused_gate_up
        and config.norm_scheme == "pre"
        and config.attention_bias != config.attention_out_bias
    ):
        raise ValueError(
            "interleaved rope with asymmetric attention bias and plain "
            "(non-fused) weights matches no HF architecture (Helium "
            "hardcodes bias-free o_proj only when attention_bias is off; "
            "Ernie 4.5's use_bias covers o_proj); cannot be exported"
        )
    if ln_gelu and config.norm_scheme == "post":
        raise ValueError(
            "post-norm blocks with layernorm+gelu match no HF architecture"
        )
    is_phi = _uses_phi_naming(config)
    is_starcoder2 = ln_gelu and not is_phi
    if is_starcoder2 and not (
        config.attention_bias == config.attention_out_bias == config.mlp_bias
    ):
        raise ValueError(
            "Starcoder2 has ONE use_bias flag covering q/k/v/o and the MLP; "
            "mismatched attention_bias/attention_out_bias/mlp_bias cannot be "
            "exported"
        )
    if is_phi and not (
        config.attention_bias and config.attention_out_bias
        and config.mlp_bias and config.lm_head_bias
        and not config.tie_word_embeddings
    ):
        raise ValueError(
            "HF Phi always biases q/k/v/dense/fc1/fc2 and the untied "
            "lm_head; this config cannot be exported as phi"
        )
    is_cohere = (
        config.norm_scheme == "parallel"
        and config.norm_type == "layernorm_nobias"
    )
    if config.norm_scheme == "parallel" and not (is_phi or is_cohere):
        raise ValueError(
            "norm_scheme='parallel' only exists in HF as Cohere "
            "(layernorm_nobias + swiglu) or Phi (layernorm + gelu); this "
            "combination cannot be exported"
        )
    is_neox = _uses_neox_naming(config)
    if is_neox and not (
        config.norm_type == "layernorm" and config.mlp_type == "gelu"
        and config.norm_scheme in ("parallel2", "pre")
        and config.attention_bias and config.attention_out_bias
        and config.mlp_bias
        and config.num_experts is None and config.sliding_window is None
        and not config.qk_norm and not config.rope_interleaved
        # the fused query_key_value layout has no GQA and no detached
        # head_dim
        and config.num_key_value_heads == config.num_attention_heads
        and config.resolved_head_dim * config.num_attention_heads
        == config.hidden_size
    ):
        raise ValueError(
            "GPT-NeoX checkpoints are biased LayerNorm + biased non-gated "
            "gelu MLP, dense, no GQA, default head_dim (two-norm parallel "
            "or sequential residual); this combination cannot be exported"
        )
    if config.norm_scheme == "parallel2" and not is_neox:
        raise ValueError(
            "norm_scheme='parallel2' only exists in HF as GPT-NeoX "
            "(layernorm + gelu); this combination cannot be exported"
        )
    if not config.gelu_approximate and not is_neox:
        raise ValueError(
            "exact (erf) gelu only exists in HF as GPT-NeoX's hidden_act="
            "'gelu'; Starcoder2/Phi exports assume the tanh approximation"
        )
    is_glm = (
        config.fused_gate_up
        and config.rope_interleaved
        and config.mlp_type == "swiglu"
        and config.norm_type == "rmsnorm"
        and config.norm_scheme in ("pre", "sandwich")
    )
    is_ernie = (
        config.rope_interleaved and not config.fused_gate_up
        and config.mlp_type == "swiglu" and config.norm_type == "rmsnorm"
        and config.norm_scheme == "pre"
        and config.partial_rotary_factor == 1.0
        and not config.qk_norm  # HF Ernie has no q/k norms
    )
    if is_ernie and config.attention_bias != config.attention_out_bias:
        raise ValueError(
            "Ernie 4.5 has ONE use_bias flag covering q/k/v/o; asymmetric "
            "attention biases cannot be exported"
        )
    if config.fused_gate_up and not is_glm:
        raise ValueError(
            "fused_gate_up only exists in HF on GLM/GLM-4 (interleaved rope "
            "+ swiglu + rmsnorm); this combination cannot be exported"
        )
    if config.rope_interleaved and not (is_cohere or is_glm or is_ernie):
        raise ValueError(
            "rope_interleaved only exists in HF on Cohere, GLM/GLM-4, and "
            "Ernie 4.5; any other export would reload with half-rotation "
            "pairing and wrong logits"
        )
    if config.norm_scheme == "sandwich" and not is_glm:
        raise ValueError(
            "sandwich norms only exist in HF as GLM-4 (interleaved rope + "
            "swiglu + rmsnorm + fused gate_up); this combination cannot be "
            "exported"
        )
    if config.logit_scale is not None and not is_cohere:
        raise ValueError(
            "logit_scale only exists in HF on Cohere; it would be silently "
            "dropped by any other export"
        )
    if config.partial_rotary_factor != 1.0 and not (
        is_phi or is_glm or is_nemotron or is_stablelm or is_neox
    ):
        raise ValueError(
            "partial_rotary_factor only exists in HF on Phi, GLM/GLM-4, "
            "Nemotron, StableLM, and GPT-NeoX (rotary_pct); it would be "
            "silently dropped otherwise"
        )
    if config.lm_head_bias and not (is_phi or is_phimoe):
        raise ValueError(
            "lm_head_bias only exists in HF on Phi and Phimoe; it would be silently "
            "dropped by any other export"
        )
    if config.qk_norm and config.qk_norm_position == "post_rope":
        if not (
            config.qk_norm_scope == "head"
            and config.norm_type == "rmsnorm" and config.norm_scheme == "pre"
            and not config.rope_interleaved  # HunYuan rotates half-style
        ):
            raise ValueError(
                "post-rope qk-norm only exists in HF as HunYuan (per-head "
                "RMS under pre-norm, half-rotation rope); this combination "
                "cannot be exported"
            )
        if config.attention_bias != config.attention_out_bias:
            raise ValueError(
                "HunYuan has ONE attention_bias flag covering q/k/v/o; "
                "asymmetric attention biases cannot be exported"
            )
    is_olmo3_pattern = (
        config.norm_scheme == "post" and config.qk_norm
        and config.qk_norm_scope == "full"
        # HF OLMo-3 rotates sliding layers with the UNSCALED tables; a
        # config trained with one shared scaled table would silently change
        # semantics on reload
        and (not config.rope_scaling or config.dual_local_rope)
    )
    is_exaone4_pattern = (
        config.norm_scheme == "post" and config.qk_norm
        and config.qk_norm_scope == "head" and not config.attention_bias
        and not config.attention_out_bias
        and config.num_experts is None
        # HF EXAONE-4 rotates with ONE table (sliding layers included)
        and (not config.rope_scaling or not config.dual_local_rope)
        # EXAONE-4's hybrid NoPE is DERIVED: full-attention layers skip
        # rope; an arbitrary no_rope pattern cannot ride this export
        and (
            config.no_rope_layers is None
            or (
                config.layer_types is not None
                and config.no_rope_layers
                == _derived_no_rope(config.layer_types)
            )
        )
    )
    if (
        config.norm_scheme == "post" and config.qk_norm
        and config.qk_norm_scope == "head" and not is_exaone4_pattern
    ):
        raise ValueError(
            "post-norm blocks with per-head qk-norm only exist in HF as "
            "EXAONE-4 (bias-free, single rope table, derived NoPE); this "
            "combination cannot be exported"
        )
    # Granite's scalar multipliers only exist in HF on the Granite family,
    # whose graph is plain llama (or the granite-MoE block): any exotic
    # feature riding along would be silently dropped by that export
    if (
        config.embedding_multiplier != 1.0
        or config.attention_multiplier is not None
        or config.residual_multiplier != 1.0
        or config.logits_scaling != 1.0
    ) and not (
        config.norm_type == "rmsnorm"
        and config.mlp_type == "swiglu"
        and config.norm_scheme == "pre"
        and not config.qk_norm and not config.rope_interleaved
        and config.partial_rotary_factor == 1.0
        and config.layer_types is None and config.no_rope_layers is None
        and config.sliding_window is None
        and (config.num_experts is None or config.moe_style == "granite")
    ):
        raise ValueError(
            "granite multipliers only exist in HF on Granite/GraniteMoe "
            "(a plain llama graph); combined with other graph features "
            "they cannot be exported"
        )
    is_apertus = (
        config.norm_type == "rmsnorm" and config.mlp_type == "xielu"
        and config.norm_scheme == "pre" and config.qk_norm
        and config.qk_norm_scope == "head"
        and config.qk_norm_position == "pre_rope"
        and config.attention_bias == config.attention_out_bias
        and not config.mlp_bias and not config.rope_interleaved
        and config.partial_rotary_factor == 1.0
        and config.num_experts is None and config.sliding_window is None
        and config.layer_types is None and config.no_rope_layers is None
    )
    if config.mlp_type == "xielu" and not is_apertus:
        raise ValueError(
            "mlp_type='xielu' only exists in HF as Apertus (RMSNorm "
            "pre-norm, per-head qk-norm, symmetric bias, full rotary); "
            "this combination cannot be exported"
        )
    is_cohere2_pattern = (
        config.norm_scheme == "parallel"
        and config.norm_type == "layernorm_nobias"
        and config.rope_interleaved
        and config.sliding_window is not None
        and config.num_experts is None
        # HF Cohere2 has no qk-norm (only Cohere R+ does) — a qk-normed
        # config exported as cohere2 would silently drop it on reload
        and not config.qk_norm
        # Cohere2's NoPE is DERIVED like EXAONE-4's: sliding layers
        # rotate, full-attention layers skip rope. It MUST be present and
        # exact — rope-on-every-layer cannot ride this export (the HF
        # module would skip rope on full layers, changing the math)
        and config.layer_types is not None
        and config.no_rope_layers == _derived_no_rope(config.layer_types)
        and (not config.rope_scaling or not config.dual_local_rope)
    )
    is_ministral_pattern = (
        config.norm_scheme == "pre" and not config.qk_norm
        and not config.attention_bias and not config.attention_out_bias
        and config.norm_type == "rmsnorm"
        and config.mlp_type == "swiglu" and not config.rope_interleaved
        # HF Ministral rotates every layer with ONE table
        and (not config.rope_scaling or not config.dual_local_rope)
    )
    if (
        config.norm_scheme == "parallel"
        and config.norm_type == "layernorm_nobias"
        and config.sliding_window is not None
        and config.layer_types is None
    ):
        raise ValueError(
            "a cohere-graph config with a uniform sliding_window has no HF "
            "home (Cohere has no windows; Cohere2 needs the sliding/full "
            "layer_types pattern) — exporting as 'cohere' would silently "
            "drop local attention on reload"
        )
    if config.layer_types is not None and not (
        is_olmo3_pattern or is_ministral_pattern or is_exaone4_pattern
        or is_cohere2_pattern
    ):
        raise ValueError(
            "per-layer sliding layer_types only exist in HF as OLMo-3 "
            "(post-norm + full qk-norm), Ministral (bias-free pre-norm), "
            "EXAONE-4 (post-norm + head qk-norm), or Cohere2 (parallel "
            "blocks + weight-only LayerNorm); this combination cannot "
            "be exported"
        )
    if config.no_rope_layers is not None and not (
        (
            config.norm_type == "rmsnorm" and config.mlp_type == "swiglu"
            and config.norm_scheme == "pre" and not config.rope_interleaved
            and not config.qk_norm and config.num_experts is None
        )
        or is_exaone4_pattern
        or is_cohere2_pattern
    ):
        raise ValueError(
            "no_rope_layers only exists in HF as SmolLM3 (a plain llama "
            "graph), as EXAONE-4's derived hybrid-NoPE pattern, or as "
            "Cohere2's (same derivation under parallel blocks); this "
            "combination cannot be exported"
        )
    if config.clip_qkv is not None and not (
        (config.num_experts and config.qk_norm and config.qk_norm_scope == "full")
        or config.norm_type == "layernorm_nonparam"
    ):
        raise ValueError(
            "clip_qkv only exists in HF on OLMoE (full qk-norm + MoE) and "
            "OLMo-1 (non-parametric LayerNorm); it would be silently "
            "dropped by any other export"
        )
    if config.norm_type == "layernorm_nonparam" and not (
        config.norm_scheme == "pre" and config.mlp_type == "swiglu"
        and not config.qk_norm and not config.rope_interleaved
        and config.num_experts is None and config.layer_types is None
        and config.sliding_window is None
        and not config.attention_bias and not config.attention_out_bias
        and not config.mlp_bias
        # OlmoLayerNorm hardcodes F.layer_norm's 1e-5; any other eps
        # would silently change the normalization on reload
        and config.rms_norm_eps == 1e-5
    ):
        raise ValueError(
            "non-parametric LayerNorm only exists in HF as OLMo-1 (a plain "
            "bias-free llama graph); this combination cannot be exported"
        )


def config_to_hf(config: LlamaConfig, torch_dtype: str = "bfloat16") -> dict[str, Any]:
    """The port's LlamaConfig -> HF `config.json` dict, JAX's: the `llama`
    base with the overlay of the one HF architecture the fields select
    (`_check_exportable` refuses the combinations none represents). One
    addition (ROADMAP C.42): a `qwen2` or `qwen3` export with a window also
    writes `use_sliding_window` and `max_window_layers: 0`, without which
    HF's Qwen configs drop the window on reload."""
    hf = _overlays(config, torch_dtype)
    if hf["model_type"] in ("qwen2", "qwen3") and config.sliding_window:
        hf.update(use_sliding_window=True, max_window_layers=0)
    return hf


def _overlays(config: LlamaConfig, torch_dtype: str) -> dict[str, Any]:
    """JAX's `config_to_hf`, overlay for overlay."""
    _check_exportable(config)
    if config.position_embedding_type == "learned":
        return {
            "architectures": ["GPT2LMHeadModel"],
            "model_type": "gpt2",
            "vocab_size": config.vocab_size,
            "n_embd": config.hidden_size,
            "n_inner": config.intermediate_size,
            "n_layer": config.num_hidden_layers,
            "n_head": config.num_attention_heads,
            "n_positions": config.max_position_embeddings,
            "n_ctx": config.max_position_embeddings,
            "activation_function": "gelu_new",
            "initializer_range": config.initializer_range,
            "layer_norm_epsilon": config.rms_norm_eps,
            "bos_token_id": config.bos_token_id,
            "eos_token_id": config.eos_token_id,
            "tie_word_embeddings": True,
            "use_cache": True,
            "torch_dtype": torch_dtype,
        }
    return {
        "architectures": ["LlamaForCausalLM"],
        "model_type": "llama",
        "vocab_size": config.vocab_size,
        "hidden_size": config.hidden_size,
        "intermediate_size": config.intermediate_size,
        "num_hidden_layers": config.num_hidden_layers,
        "num_attention_heads": config.num_attention_heads,
        "num_key_value_heads": config.num_key_value_heads,
        "head_dim": config.resolved_head_dim,
        "hidden_act": "silu",
        "max_position_embeddings": config.max_position_embeddings,
        "initializer_range": config.initializer_range,
        "rms_norm_eps": config.rms_norm_eps,
        "pad_token_id": config.pad_token_id,
        "bos_token_id": config.bos_token_id,
        "eos_token_id": config.eos_token_id,
        "tie_word_embeddings": config.tie_word_embeddings,
        "rope_theta": config.rope_theta,
        "rope_scaling": config.rope_scaling,
        "attention_bias": config.attention_bias,
        "attention_dropout": config.attention_dropout,
        "mlp_bias": config.mlp_bias,
        "use_cache": True,
        "torch_dtype": torch_dtype,
        # emitted as mistral when local attention is on (HF LlamaConfig has
        # no sliding_window; MistralConfig shares the weight layout)
        **(
            {"model_type": "mistral", "architectures": ["MistralForCausalLM"],
             "sliding_window": config.sliding_window}
            if config.sliding_window
            else {}
        ),
        # asymmetric bias (q/k/v yes, o no) only exists as Qwen2 in HF —
        # exporting it as llama+attention_bias would leave o_proj.bias a
        # missing key randomly initialized at from_pretrained time
        **(
            {"model_type": "qwen2", "architectures": ["Qwen2ForCausalLM"],
             "attention_bias": None}
            if config.attention_bias and not config.attention_out_bias
            else {}
        ),
        # per-head qk-norm only exists as Qwen3 in HF
        **(
            {"model_type": "qwen3", "architectures": ["Qwen3ForCausalLM"],
             "head_dim": config.resolved_head_dim}
            if config.qk_norm and config.qk_norm_scope == "head"
            else {}
        ),
        # post-norm blocks + full-width qk-norm only exist as OLMo-2 in HF;
        # with a per-layer sliding pattern they are OLMo-3
        **(
            {"model_type": "olmo2", "architectures": ["Olmo2ForCausalLM"]}
            if config.norm_scheme == "post" and config.layer_types is None
            else {}
        ),
        **(
            {"model_type": "olmo3", "architectures": ["Olmo3ForCausalLM"],
             "layer_types": list(config.layer_types),
             "sliding_window": config.sliding_window}
            if config.norm_scheme == "post" and config.layer_types is not None
            else {}
        ),
        # post-norm + per-head qk-norm (+ hybrid sliding/NoPE pattern)
        # only exists as EXAONE-4 in HF (rope is derived there: sliding
        # layers rotate, full layers are NoPE)
        **(
            {"model_type": "exaone4", "architectures": ["Exaone4ForCausalLM"],
             "head_dim": config.resolved_head_dim,
             # explicit layer_types always: Exaone4Config's derivation
             # divides by sliding_window_pattern (crashes when None), and a
             # uniform sliding_window with no pattern must stay sliding
             "sliding_window": config.sliding_window,
             "layer_types": (
                 list(config.layer_types)
                 if config.layer_types is not None
                 else [
                     "sliding_attention" if config.sliding_window
                     else "full_attention"
                 ] * config.num_hidden_layers
             )}
            if config.norm_scheme == "post" and config.qk_norm
            and config.qk_norm_scope == "head"
            else {}
        ),
        # interleaved rope + fused gate_up under pre/sandwich norms only
        # exist as GLM / GLM-4 in HF (sandwich adds the two output norms)
        **(
            {"model_type": "glm4" if config.norm_scheme == "sandwich" else "glm",
             "architectures": [
                 "Glm4ForCausalLM" if config.norm_scheme == "sandwich"
                 else "GlmForCausalLM"
             ],
             "partial_rotary_factor": config.partial_rotary_factor,
             "head_dim": config.resolved_head_dim,
             # restore the real flag: GLM's q/k/v-but-not-o bias pattern
             # trips the earlier qwen2 overlay, which nulls attention_bias
             # (GLM hardcodes no o bias, so the flag is unambiguous here)
             "attention_bias": config.attention_bias}
            if config.fused_gate_up
            else {}
        ),
        # interleaved rope WITHOUT the fused gate_up tensor (plain llama
        # weights) only exists as Ernie 4.5 in HF
        **(
            {"model_type": "ernie4_5", "architectures": ["Ernie4_5ForCausalLM"],
             "use_bias": config.attention_bias,
             "head_dim": config.resolved_head_dim}
            if config.rope_interleaved and config.norm_scheme == "pre"
            and not config.fused_gate_up and config.norm_type == "rmsnorm"
            and config.mlp_type == "swiglu" and config.partial_rotary_factor == 1.0
            and not config.qk_norm
            # Ernie's single use_bias flag covers o_proj too; asymmetric
            # bias cannot ride this export (refused in _check_exportable)
            and config.attention_bias == config.attention_out_bias
            else {}
        ),
        # parallel blocks + weight-only LayerNorm + interleaved rope +
        # logit_scale only exist as Cohere in HF
        **(
            {"model_type": "cohere", "architectures": ["CohereForCausalLM"],
             "logit_scale": config.logit_scale,
             "layer_norm_eps": config.rms_norm_eps,
             "use_qk_norm": config.qk_norm,
             # honest tie flag: forcing True would re-tie an untied lm_head
             # on reload and silently discard its trained weights
             "tie_word_embeddings": config.tie_word_embeddings,
             # Command R7B: same graph + a sliding/full pattern (NoPE on
             # full layers is derived by the HF module, like EXAONE-4)
             **(
                 {"model_type": "cohere2",
                  "architectures": ["Cohere2ForCausalLM"],
                  "sliding_window": config.sliding_window,
                  "layer_types": list(config.layer_types)}
                 if config.layer_types is not None
                 else {}
             )}
            if config.norm_scheme == "parallel"
            and config.norm_type == "layernorm_nobias"
            else {}
        ),
        # parallel blocks + biased LayerNorm + gelu + partial rotary only
        # exist as Phi in HF
        **(
            {"model_type": "phi", "architectures": ["PhiForCausalLM"],
             "partial_rotary_factor": config.partial_rotary_factor,
             "layer_norm_eps": config.rms_norm_eps,
             "hidden_act": "gelu_new",
             "qk_layernorm": False,
             "resid_pdrop": 0.0,
             "embd_pdrop": 0.0}
            if _uses_phi_naming(config)
            else {}
        ),
        # post-rope per-head qk-norm only exists as HunYuan in HF
        **(
            {"model_type": "hunyuan_v1_dense",
             "architectures": ["HunYuanDenseV1ForCausalLM"],
             "head_dim": config.resolved_head_dim,
             # restore the real flag: asymmetric-bias patterns trip the
             # earlier qwen2 overlay which nulls attention_bias
             "attention_bias": config.attention_bias}
            if config.qk_norm and config.qk_norm_position == "post_rope"
            else {}
        ),
        # zero-centered biased LayerNorm + relu^2 MLP only exist as
        # Nemotron in HF
        **(
            {"model_type": "nemotron", "architectures": ["NemotronForCausalLM"],
             "norm_eps": config.rms_norm_eps,
             "partial_rotary_factor": config.partial_rotary_factor,
             "head_dim": config.resolved_head_dim,
             "hidden_act": "relu2"}
            if config.norm_type == "layernorm1p" and config.mlp_type == "relu2"
            and not config.qk_norm
            else {}
        ),
        # relu^2 MLP under plain RMSNorm pre-norm only exists as Arcee in HF
        # (symmetric bias only — _check_exportable's is_arcee enforces it,
        # so the qwen2 asymmetric-bias overlay can never have fired here)
        **(
            {"model_type": "arcee", "architectures": ["ArceeForCausalLM"],
             "head_dim": config.resolved_head_dim,
             "hidden_act": "relu2"}
            if config.norm_type == "rmsnorm" and config.mlp_type == "relu2"
            else {}
        ),
        # a per-layer sliding/full pattern under PRE-norm (OLMo-3 is the
        # post-norm case above) only exists as Ministral in HF (bias-free —
        # _check_exportable refuses biased variants)
        **(
            {"model_type": "ministral", "architectures": ["MinistralForCausalLM"],
             "layer_types": list(config.layer_types),
             "sliding_window": config.sliding_window,
             "head_dim": config.resolved_head_dim}
            if config.layer_types is not None and config.norm_scheme == "pre"
            and not config.qk_norm
            else {}
        ),
        # biased-LayerNorm + non-gated gelu MLP only exist as Starcoder2 in
        # HF (its use_bias covers attention and MLP together; norm_epsilon is
        # its LayerNorm eps)
        **(
            {"model_type": "starcoder2", "architectures": ["Starcoder2ForCausalLM"],
             "use_bias": config.attention_bias,
             "norm_epsilon": config.rms_norm_eps,
             "sliding_window": config.sliding_window,
             "hidden_act": "gelu_pytorch_tanh"}
            if config.norm_type == "layernorm" and config.mlp_type == "gelu"
            and config.norm_scheme == "pre" and not config.neox_naming
            else {}
        ),
        # the fully non-parametric LayerNorm graph only exists as OLMo-1
        **(
            {"model_type": "olmo", "architectures": ["OlmoForCausalLM"],
             "clip_qkv": config.clip_qkv}
            if config.norm_type == "layernorm_nonparam"
            else {}
        ),
        # the two-norm parallel graph only exists as GPT-NeoX in HF
        **(
            {"model_type": "gpt_neox",
             "architectures": ["GPTNeoXForCausalLM"],
             "rotary_pct": config.partial_rotary_factor,
             "rotary_emb_base": config.rope_theta,
             "layer_norm_eps": config.rms_norm_eps,
             "use_parallel_residual": True,
             "attention_bias": config.attention_bias,
             "hidden_act": (
                 "gelu_new" if config.gelu_approximate else "gelu"
             )}
            if config.norm_scheme == "parallel2"
            else {}
        ),
        **(
            {"model_type": "gpt_neox",
             "architectures": ["GPTNeoXForCausalLM"],
             "rotary_pct": config.partial_rotary_factor,
             "rotary_emb_base": config.rope_theta,
             "layer_norm_eps": config.rms_norm_eps,
             "use_parallel_residual": False,
             "attention_bias": config.attention_bias,
             "hidden_act": (
                 "gelu_new" if config.gelu_approximate else "gelu"
             )}
            if config.neox_naming and config.norm_scheme == "pre"
            else {}
        ),
        # a non-gated xIELU MLP only exists as Apertus in HF
        **(
            {"model_type": "apertus", "architectures": ["ApertusForCausalLM"],
             "hidden_act": "xielu",
             "attention_bias": config.attention_bias}
            if config.mlp_type == "xielu"
            else {}
        ),
        # biased LayerNorm + swiglu only exists as StableLM in HF
        **(
            {"model_type": "stablelm", "architectures": ["StableLmForCausalLM"],
             "layer_norm_eps": config.rms_norm_eps,
             "partial_rotary_factor": config.partial_rotary_factor,
             "use_qkv_bias": config.attention_bias,
             "qk_layernorm": False,
             "use_parallel_residual": False,
             "hidden_act": "silu"}
            if config.norm_type == "layernorm" and config.mlp_type == "swiglu"
            and config.num_experts is None
            else {}
        ),
        # per-layer NoPE only exists as SmolLM3 in HF
        **(
            {"model_type": "smollm3", "architectures": ["SmolLM3ForCausalLM"],
             "no_rope_layers": list(config.no_rope_layers),
             "no_rope_layer_interval": 4,
             "use_sliding_window": config.sliding_window is not None,
             "sliding_window": config.sliding_window}
            # EXAONE-4 (post-norm) derives its NoPE pattern — only the
            # pre-norm SmolLM3 carries an explicit one
            if config.no_rope_layers is not None and config.norm_scheme == "pre"
            else {}
        ),
        # any non-identity multiplier only exists as Granite in HF; our None
        # attention scale exports as the explicit 1/sqrt(head_dim) Granite
        # expects (its config has no "default scale" sentinel)
        **(
            {"model_type": "granite", "architectures": ["GraniteForCausalLM"],
             **_granite_multipliers(config)}
            if (config.embedding_multiplier != 1.0
                or config.attention_multiplier is not None
                or config.residual_multiplier != 1.0
                or config.logits_scaling != 1.0)
            else {}
        ),
        **_moe_to_hf(config),
    }


def _granite_multipliers(config: LlamaConfig) -> dict[str, Any]:
    """Granite-family scalar multipliers, each explicit: HF defaults them
    all to 1.0 (including the attention scale), and our None scale means
    the standard 1/sqrt(head_dim)."""
    return {
        "embedding_multiplier": config.embedding_multiplier,
        "attention_multiplier": (
            config.attention_multiplier
            if config.attention_multiplier is not None
            else config.resolved_head_dim ** -0.5
        ),
        "residual_multiplier": config.residual_multiplier,
        "logits_scaling": config.logits_scaling,
    }


def _moe_to_hf(config: LlamaConfig) -> dict[str, Any]:
    """JAX's MoE overlay: the HF type whose expert layout, routing and
    norms the fields select, with JAX's refusals."""
    if not config.num_experts:
        return {}
    common = {
        "num_experts_per_tok": config.num_experts_per_tok,
        "router_aux_loss_coef": config.router_aux_loss_coef,
        "output_router_logits": False,
    }
    if config.moe_style == "granite":
        if not config.norm_topk_prob:
            raise ValueError(
                "GraniteMoe's softmax-after-topk routing implies "
                "norm_topk_prob=True; an unrenormalized config cannot be "
                "exported as granitemoe"
            )
        shared = config.shared_expert_intermediate_size
        return {
            "model_type": "granitemoeshared" if shared else "granitemoe",
            "architectures": ["GraniteMoeSharedForCausalLM" if shared
                              else "GraniteMoeForCausalLM"],
            "num_local_experts": config.num_experts,
            "intermediate_size": config.moe_intermediate_size,
            **_granite_multipliers(config),
            **({"shared_intermediate_size": shared} if shared else {}),
            **common,
        }
    if config.shared_expert_intermediate_size and not config.shared_expert_gated:
        raise ValueError(
            "an UNGATED shared expert only exists as granitemoeshared in "
            "HF; set moe_style='granite' to export it"
        )
    if config.moe_style == "mixtral":
        if config.moe_router_impl == "sparsemixer":
            # SparseMixer routing + biased LayerNorms = Phi-3.5-MoE
            if config.norm_type != "layernorm":
                raise ValueError(
                    "sparsemixer routing only exists in HF as Phimoe "
                    "(biased LayerNorm blocks); this combination cannot "
                    "be exported"
                )
            return {
                "model_type": "phimoe",
                "architectures": ["PhimoeForCausalLM"],
                "num_local_experts": config.num_experts,
                "intermediate_size": config.moe_intermediate_size,
                "router_jitter_noise": config.router_jitter_eps,
                "input_jitter_noise": 0.0,
                "lm_head_bias": config.lm_head_bias,
                "attention_bias": config.attention_bias,
                "sliding_window": config.sliding_window,
                **common,
            }
        return {
            "model_type": "mixtral",
            "architectures": ["MixtralForCausalLM"],
            "num_local_experts": config.num_experts,
            # HF Mixtral's intermediate_size is the per-expert width
            "intermediate_size": config.moe_intermediate_size,
            **common,
        }
    if config.qk_norm and config.qk_norm_scope == "full":
        # full-width qk-norm + qwen-style experts: OLMoE (pre-norm) or
        # FlexOlmo (post-norm blocks)
        if config.norm_scheme == "post":
            if config.clip_qkv is not None:
                raise ValueError(
                    "HF FlexOlmo has no clip_qkv; exporting would silently "
                    "drop the clamp (OLMoE, the pre-norm variant, has it)"
                )
            if config.layer_types is not None:
                raise ValueError(
                    "HF FlexOlmo has no per-layer sliding pattern; exporting "
                    "would silently drop layer_types"
                )
            return {
                "model_type": "flex_olmo",
                "architectures": ["FlexOlmoForCausalLM"],
                "num_experts": config.num_experts,
                "intermediate_size": config.moe_intermediate_size,
                "norm_topk_prob": config.norm_topk_prob,
                **common,
            }
        return {
            "model_type": "olmoe",
            "architectures": ["OlmoeForCausalLM"],
            "num_experts": config.num_experts,
            "intermediate_size": config.moe_intermediate_size,
            "norm_topk_prob": config.norm_topk_prob,
            "clip_qkv": config.clip_qkv,
            **common,
        }
    qwen3 = config.qk_norm  # qwen3_moe; else qwen2_moe (shared expert)
    return {
        "model_type": "qwen3_moe" if qwen3 else "qwen2_moe",
        "architectures": ["Qwen3MoeForCausalLM" if qwen3 else "Qwen2MoeForCausalLM"],
        "num_experts": config.num_experts,
        "moe_intermediate_size": config.moe_intermediate_size,
        "norm_topk_prob": config.norm_topk_prob,
        "decoder_sparse_step": 1,
        "mlp_only_layers": [],
        **common,
        **(
            {"shared_expert_intermediate_size": config.shared_expert_intermediate_size,
             "attention_bias": None}
            if not qwen3
            else {"head_dim": config.resolved_head_dim}
        ),
    }


def config_fields_from_hf(hf_config: Any, **overrides: Any) -> dict[str, Any]:
    """HF config (object or dict) -> the LlamaConfig fields JAX's
    `config_from_hf` sets, for every model_type it routes to the Llama
    family; `overrides` win. Raises JAX's ValueErrors for what JAX refuses."""
    get = (lambda k, d=None: hf_config.get(k, d)) if isinstance(hf_config, dict) else (
        lambda k, d=None: getattr(hf_config, k, d)
    )
    model_type = get("model_type")
    if model_type == "gpt2":
        for drop in ("embd_pdrop", "attn_pdrop", "resid_pdrop"):
            if get(drop, 0.0):
                raise ValueError(
                    f"gpt2 {drop}={get(drop)} is not supported: dropout is "
                    "not implemented — override it to 0.0"
                )
        if get("scale_attn_by_inverse_layer_idx") or get("reorder_and_upcast_attn"):
            raise ValueError(
                "gpt2 scale_attn_by_inverse_layer_idx / reorder_and_upcast_attn "
                "are not supported"
            )
        if not get("scale_attn_weights", True):
            raise ValueError(
                "gpt2 scale_attn_weights=False is not supported (attention "
                "always scales by 1/sqrt(head_dim) here)"
            )
        if get("activation_function", "gelu_new") not in ("gelu_new", "gelu_pytorch_tanh"):
            raise ValueError(
                f"gpt2 activation_function={get('activation_function')!r} is "
                "not supported; only the tanh-approximate gelu is implemented"
            )
        return {**dict(
            vocab_size=get("vocab_size"),
            hidden_size=get("n_embd"),
            intermediate_size=get("n_inner") or 4 * get("n_embd"),
            num_hidden_layers=get("n_layer"),
            num_attention_heads=get("n_head"),
            num_key_value_heads=get("n_head"),
            max_position_embeddings=get("n_positions", 1024),
            initializer_range=get("initializer_range", 0.02),
            rms_norm_eps=get("layer_norm_epsilon", 1e-5),
            bos_token_id=get("bos_token_id", 50256),
            eos_token_id=get("eos_token_id", 50256),
            tie_word_embeddings=True,
            position_embedding_type="learned",
            norm_type="layernorm",
            mlp_type="gelu",
            attention_bias=True,
            attention_out_bias=True,
            mlp_bias=True,
        ), **overrides}
    if model_type == "phi":
        if get("qk_layernorm", False):
            raise ValueError("phi qk_layernorm=True is not supported")
        for drop in ("resid_pdrop", "embd_pdrop"):
            if get(drop, 0.0):
                raise ValueError(
                    f"phi {drop}={get(drop)} is not supported: dropout is not "
                    "implemented — override it to 0.0 to fine-tune without it"
                )
    if model_type == "stablelm":
        if get("qk_layernorm", False):
            raise ValueError("stablelm qk_layernorm=True is not supported")
        if get("use_parallel_residual", False):
            raise ValueError(
                "stablelm use_parallel_residual=True (gpt-neox style) is "
                "not supported; sequential StableLM-2 checkpoints are"
            )
        if get("hidden_dropout", 0.0):
            raise ValueError(
                f"stablelm hidden_dropout={get('hidden_dropout')} is not "
                "supported: dropout is not implemented"
            )
    if model_type == "seed_oss" and get("residual_dropout", 0.0):
        raise ValueError(
            f"seed_oss residual_dropout={get('residual_dropout')} is not "
            "supported: dropout is not implemented — override it to 0.0 to "
            "fine-tune without it"
        )
    if model_type == "arcee" and get("hidden_act", "relu2") != "relu2":
        raise ValueError(
            f"arcee hidden_act={get('hidden_act')!r} is not supported; the "
            "Arcee graph is modeled as the non-gated relu2 MLP"
        )
    moe: dict[str, Any] = {}
    if model_type == "phimoe":
        # Phi-3.5-MoE: mixtral expert naming, SparseMixer routing, biased LayerNorms
        moe = dict(
            num_experts=get("num_local_experts"),
            num_experts_per_tok=get("num_experts_per_tok", 2),
            moe_intermediate_size=get("intermediate_size"),
            norm_topk_prob=False,
            moe_style="mixtral",
            moe_router_impl="sparsemixer",
            router_jitter_eps=get("router_jitter_noise", 0.01),
            router_aux_loss_coef=get("router_aux_loss_coef", 0.001),
        )
    elif model_type == "mixtral":
        moe = dict(
            num_experts=get("num_local_experts"),
            num_experts_per_tok=get("num_experts_per_tok", 2),
            moe_intermediate_size=get("intermediate_size"),
            norm_topk_prob=True,  # Mixtral always renormalizes top-k
            moe_style="mixtral",
            router_aux_loss_coef=get("router_aux_loss_coef", 0.001),
        )
    elif model_type in ("olmoe", "flex_olmo"):
        # qwen-style expert naming, no shared expert; HF's intermediate_size
        # is the per-expert width
        moe = dict(
            num_experts=get("num_experts"),
            num_experts_per_tok=get("num_experts_per_tok", 8),
            moe_intermediate_size=get("intermediate_size"),
            norm_topk_prob=get("norm_topk_prob", False),
            router_aux_loss_coef=get("router_aux_loss_coef", 0.01),
        )
    elif model_type in ("granitemoe", "granitemoeshared"):
        # softmax after top-k equals softmax -> top-k -> renormalize; the
        # shared MLP is always on (no gate)
        moe = dict(
            num_experts=get("num_local_experts"),
            num_experts_per_tok=get("num_experts_per_tok", 2),
            moe_intermediate_size=get("intermediate_size"),
            norm_topk_prob=True,
            moe_style="granite",
            router_aux_loss_coef=get("router_aux_loss_coef", 0.001),
            shared_expert_intermediate_size=get("shared_intermediate_size"),
            shared_expert_gated=False,
        )
    elif model_type in ("qwen2_moe", "qwen3_moe"):
        if get("decoder_sparse_step", 1) != 1 or get("mlp_only_layers"):
            raise ValueError(
                "mixed dense/sparse layer schedules (decoder_sparse_step != 1 "
                "or mlp_only_layers) are not supported"
            )
        moe = dict(
            num_experts=get("num_experts"),
            num_experts_per_tok=get("num_experts_per_tok", 4),
            moe_intermediate_size=get("moe_intermediate_size"),
            norm_topk_prob=get("norm_topk_prob", False),
            router_aux_loss_coef=get("router_aux_loss_coef", 0.001),
            shared_expert_intermediate_size=(
                get("shared_expert_intermediate_size") if model_type == "qwen2_moe" else None
            ),
        )
    # the per-layer sliding/full pattern, resolved once (layer_types and the
    # derived NoPE list must agree): explicit, or Command R7B's fallback
    resolved_layer_types = None
    if model_type in ("olmo3", "ministral", "exaone4", "cohere2"):
        resolved_layer_types = list(get("layer_types") or []) or None
        if (resolved_layer_types is None and model_type == "cohere2"
                and get("sliding_window") is not None):
            pattern = get("sliding_window_pattern", 4)
            resolved_layer_types = [
                "full_attention" if (i + 1) % pattern == 0 else "sliding_attention"
                for i in range(get("num_hidden_layers"))
            ]

    return {**dict(
        vocab_size=get("vocab_size"),
        hidden_size=get("hidden_size"),
        intermediate_size=get("intermediate_size"),
        num_hidden_layers=get("num_hidden_layers"),
        num_attention_heads=get("num_attention_heads"),
        num_key_value_heads=get("num_key_value_heads") or get("num_attention_heads"),
        head_dim=get("head_dim"),
        max_position_embeddings=get("max_position_embeddings"),
        initializer_range=get("initializer_range", 0.02),
        rms_norm_eps=(
            1e-5 if model_type == "olmo"  # OlmoLayerNorm's F.layer_norm default
            else get("norm_epsilon", 1e-5) if model_type == "starcoder2"
            else get("layer_norm_eps", 1e-5)
            if model_type in ("cohere", "cohere2", "phi", "stablelm", "gpt_neox")
            else get("norm_eps", 1e-5) if model_type == "nemotron"
            else get("rms_norm_eps", 1e-6)
        ),
        pad_token_id=get("pad_token_id"),
        bos_token_id=get("bos_token_id", 1),
        eos_token_id=get("eos_token_id", 2),
        tie_word_embeddings=get("tie_word_embeddings", False),
        # raw Pythia config.json stores the base as rotary_emb_base
        rope_theta=(
            get("rope_theta") or get("rotary_emb_base", 10000.0)
            if model_type == "gpt_neox"
            else get("rope_theta", 10000.0)
        ),
        # Qwen2 / Qwen2-MoE hardcode q/k/v biases without an o_proj bias;
        # an explicit attention_bias wins, present-but-None counts as absent
        attention_bias=(
            get("use_bias", True) if model_type == "starcoder2"
            else get("attention_bias", True) if model_type == "gpt_neox"
            else True if model_type == "phi"
            else get("use_bias", False) if model_type == "ernie4_5"
            else get("use_qkv_bias", False) if model_type == "stablelm"
            else get("attention_bias")
            if get("attention_bias") is not None
            else model_type in ("qwen2", "qwen2_moe")
        ),
        attention_out_bias=(
            get("use_bias", True) if model_type == "starcoder2"
            else get("attention_bias", True) if model_type == "gpt_neox"
            else True if model_type == "phi"
            else get("use_bias", False) if model_type == "ernie4_5"
            else get("attention_out_bias", False) if model_type == "seed_oss"
            else False if model_type in ("glm", "glm4", "helium", "stablelm")
            else False
            if model_type in ("qwen2", "qwen2_moe") and get("attention_bias") is None
            else (get("attention_bias") or False)
        ),
        attention_dropout=get("attention_dropout", 0.0),
        mlp_bias=(
            get("use_bias", True) if model_type == "starcoder2"
            else True if model_type in ("phi", "gpt_neox")
            else get("mlp_bias", False)
        ),
        rope_scaling=get("rope_scaling"),
        layer_types=resolved_layer_types,
        dual_local_rope=model_type == "olmo3",
        # Mistral sets sliding_window unconditionally; the Qwen families
        # gate it behind use_sliding_window (default False)
        sliding_window=(
            get("sliding_window")
            if get("use_sliding_window",
                   model_type not in ("qwen2", "qwen3", "qwen2_moe", "qwen3_moe", "smollm3"))
            else None
        ),
        no_rope_layers=(
            list(get("no_rope_layers") or []) or None
            if model_type == "smollm3"
            else _derived_no_rope(resolved_layer_types)
            if model_type in ("exaone4", "cohere2")
            and resolved_layer_types is not None
            and get("sliding_window") is not None
            else None
        ),
        qk_norm=(
            get("use_qk_norm", False) if model_type in ("cohere", "cohere2")
            else model_type in ("qwen3", "olmo2", "olmo3", "qwen3_moe", "olmoe", "flex_olmo",
                                "hunyuan_v1_dense", "exaone4", "apertus")
        ),
        qk_norm_position="post_rope" if model_type == "hunyuan_v1_dense" else "pre_rope",
        qk_norm_scope=(
            "full" if model_type in ("olmo2", "olmo3", "olmoe", "flex_olmo") else "head"
        ),
        norm_scheme=(
            "post" if model_type in ("olmo2", "olmo3", "flex_olmo", "exaone4")
            else "parallel" if model_type in ("cohere", "cohere2", "phi")
            else ("parallel2" if get("use_parallel_residual", True) else "pre")
            if model_type == "gpt_neox"
            else "sandwich" if model_type == "glm4"
            else "pre"
        ),
        clip_qkv=get("clip_qkv"),
        norm_type=(
            "layernorm" if model_type in ("starcoder2", "phi", "stablelm", "phimoe", "gpt_neox")
            else "layernorm_nonparam" if model_type == "olmo"
            else "layernorm_nobias" if model_type in ("cohere", "cohere2")
            else "layernorm1p" if model_type == "nemotron"
            else "rmsnorm"
        ),
        gelu_approximate=(
            get("hidden_act", "gelu") in ("gelu_new", "gelu_fast", "gelu_pytorch_tanh")
            if model_type == "gpt_neox"
            else True
        ),
        neox_naming=(model_type == "gpt_neox"),
        mlp_type=(
            "gelu" if model_type in ("starcoder2", "phi", "gpt_neox")
            else "relu2" if model_type in ("nemotron", "arcee")
            else "xielu" if model_type == "apertus"
            else "swiglu"
        ),
        partial_rotary_factor=(
            get("rotary_pct", 0.25) if model_type == "gpt_neox"
            else get("partial_rotary_factor", 0.5)
            if model_type in ("phi", "glm", "glm4", "nemotron")
            else get("partial_rotary_factor", 0.25) if model_type == "stablelm"
            else 1.0
        ),
        lm_head_bias=(
            get("lm_head_bias", False) if model_type == "phimoe" else model_type == "phi"
        ),
        rope_interleaved=model_type in ("cohere", "cohere2", "glm", "glm4", "ernie4_5", "helium"),
        fused_gate_up=model_type in ("glm", "glm4"),
        logit_scale=(
            get("logit_scale", 0.0625) if model_type in ("cohere", "cohere2") else None
        ),
        # Granite's scalar multipliers (the identity elsewhere)
        embedding_multiplier=get("embedding_multiplier", 1.0),
        attention_multiplier=(
            get("attention_multiplier")
            if model_type in ("granite", "granitemoe", "granitemoeshared")
            else None
        ),
        residual_multiplier=get("residual_multiplier", 1.0),
        logits_scaling=get("logits_scaling", 1.0),
        **moe,
    ), **overrides}


def config_from_hf(hf_config: Any, **overrides: Any) -> LlamaConfig:
    """HF config (object or dict) -> the port's LlamaConfig."""
    return LlamaConfig(**config_fields_from_hf(hf_config, **overrides))
