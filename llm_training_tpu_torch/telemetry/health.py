"""Model-health metrics: per-layer-group gradient, parameter and update
norms.

Counterpart of `llm_training_tpu/telemetry/health.py`. Every
`HealthConfig.every_n_steps`-th optimizer step the trainer computes, on the
parameters' device, the squared L2 norm of each parameter tensor (before
the update), of its gradient (before the clip: a single non-finite tensor
must not smear over every group through the global rescale) and of the
optimizer's update (what the step added to the parameter, collected inside
`optim/builder.py`'s update loop, offloaded or not, so no copy of the
parameters is ever taken), then sums them by layer group on the device
and copies one small tensor to the host. Under gradient accumulation the
health step is the boundary micro-step: its gradient norms are that
micro-batch's (the headline `grad_norm`'s semantics), its update norms
the whole accumulated update, as JAX's.

Key schema, equal to JAX's for the same model (both of its layouts,
`scan_layers` on and off):

- ``health/grad_norm/<group>``, ``health/param_norm/<group>``,
  ``health/update_norm/<group>`` -- L2 norms over the group's tensors;
- ``health/update_ratio/<group>`` -- update_norm / (param_norm + 1e-12).

Groups: a decoder layer's parameters form `layers_<i:02d>` (JAX's scanned
stack emits one key per index along the stack, its looped layout one per
`layers_<i>` module, both zero-padded); everything else groups under its
top-level module (`embed_tokens`, `norm`, `lm_head`); a policy and
reference pair prefixes `policy/` and `ref/`. A parameter that is not one
of the Llama's groups by the JAX rule on its dotted path (`<stem>.<i>`
components are blocks).

An MoE model's router health (`moe_router_health`, JAX's), from the
objective on the same health steps (its `with_health` flag), per MoE layer
`health/moe/{router_entropy,max_expert_share,min_expert_share,aux_loss}/
layer_<i:02d>`, per expert `health/moe/load_frac/expert_<e:02d>` (at most
MAX_EXPERT_KEYS experts), and `health/moe/dropped_rows` /
`health/moe/dropped_frac`.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass

import torch

from llm_training_tpu_torch.models.llama.from_jax import PAIR, jax_leaf

_BLOCK = re.compile(r"^\d+$")
METRICS = ("param_norm", "grad_norm", "update_norm", "update_ratio")
MAX_EXPERT_KEYS = 32  # per-expert load keys only up to this many experts


@dataclass
class HealthConfig:
    """Trainer-level cadence of the health metrics. `every_n_steps` None
    (the default) computes none: the step is the plain one."""

    every_n_steps: int | None = None

    def __post_init__(self):
        if self.every_n_steps is not None and self.every_n_steps < 1:
            raise ValueError(f"health.every_n_steps must be >= 1, got {self.every_n_steps}")


def group_of(name: str) -> str:
    """The layer group of the port's parameter `name`, named as JAX's
    `build_param_groups` names the same parameter's group."""
    part, _, rest = name.partition(".")
    if part in PAIR:
        return f"{part}/{group_of(rest)}"
    try:
        layer, keys = jax_leaf(name)
    except KeyError:
        comps = name.split(".")[:-1] or name.split(".")
        for i in range(1, len(comps)):
            if _BLOCK.match(comps[i]):
                return "/".join(comps[: i - 1] + [f"{comps[i - 1]}_{int(comps[i]):02d}"])
        return "/".join(comps[:2])
    if layer is not None:
        return f"layers_{layer:02d}"
    return keys[0]


class ParamGroups:
    """The static plan: each parameter's group index (the order of
    `named_parameters`), and the groups' names in JAX's emission order of
    the scanned layout (sorted: zero-padded layers sort by index)."""

    def __init__(self, names: list[str]):
        groups = [group_of(n) for n in names]
        self.names = sorted(set(groups))
        index = {g: i for i, g in enumerate(self.names)}
        self.member = [index[g] for g in groups]
        self._index: dict[torch.device, torch.Tensor] = {}

    def __len__(self) -> int:
        return len(self.member)

    def index(self, device: torch.device) -> torch.Tensor:
        if device not in self._index:
            self._index[device] = torch.tensor(self.member, dtype=torch.long, device=device)
        return self._index[device]


def build_param_groups(named_params) -> ParamGroups:
    """The group plan of a module's `named_parameters()`."""
    return ParamGroups([n for n, _ in named_params])


def sq_norm(t: torch.Tensor | None, device: torch.device) -> torch.Tensor:
    """Sum of squares of `t`'s elements in float32 (0 for None), on the
    device."""
    if t is None:
        return torch.zeros((), dtype=torch.float32, device=device)
    return torch.linalg.vector_norm(t, dtype=torch.float32).square()


def layer_health_tensor(groups: ParamGroups, param_sq: list, grad_sq: list,
                        update_sq: list) -> torch.Tensor:
    """[4, G] on the device: param, grad and update norms and the update
    ratio per group, from per-parameter squared norms (index-aligned with
    the plan; an update missing from `update_sq` counts 0)."""
    device = param_sq[0].device
    sq = torch.stack([torch.stack(param_sq), torch.stack(grad_sq), torch.stack(update_sq)])
    sums = torch.zeros((3, len(groups.names)), dtype=torch.float32, device=device)
    sums.index_add_(1, groups.index(device), sq)
    norms = sums.sqrt()
    ratio = norms[2] / (norms[0] + 1e-12)
    return torch.cat([norms, ratio[None]])


def layer_health_metrics(groups: ParamGroups, values, prefix: str = "health") -> dict[str, float]:
    """The `health/<metric>/<group>` dict of a host copy of
    `layer_health_tensor`'s [4, G] result."""
    out: dict[str, float] = {}
    for g, name in enumerate(groups.names):
        for m, metric in enumerate(METRICS):
            out[f"{prefix}/{metric}/{name}"] = float(values[m][g])
    return out


def moe_router_health(router_stats, n_tokens: int) -> dict[str, torch.Tensor]:
    """Per-MoE-layer router health from `CausalLMOutput.router_stats`
    (sel_frac [L, E], mean_prob [L, E], dropped, layer_ids), on the device.
    A layer's load is its sel_frac row normalised to 1; its entropy is
    normalised by log(E) (1.0 when balanced); dropped_frac takes the token
    count as `n_tokens`."""
    sel = router_stats.sel_frac.float()
    prob = router_stats.mean_prob.float()
    n_layers, n_experts = sel.shape
    ids = router_stats.layer_ids or tuple(range(n_layers))
    load = sel / sel.sum(-1, keepdim=True).clamp_min(1e-9)
    entropy = -(load * torch.log(load + 1e-9)).sum(-1) / math.log(max(n_experts, 2))
    aux = n_experts * (sel * prob).sum(-1)
    out: dict[str, torch.Tensor] = {}
    for j, layer_id in enumerate(ids):
        key = f"layer_{int(layer_id):02d}"
        out[f"health/moe/router_entropy/{key}"] = entropy[j]
        out[f"health/moe/max_expert_share/{key}"] = load[j].max()
        out[f"health/moe/min_expert_share/{key}"] = load[j].min()
        out[f"health/moe/aux_loss/{key}"] = aux[j]
    if n_experts <= MAX_EXPERT_KEYS:
        mean_load = load.mean(0)
        for e in range(n_experts):
            out[f"health/moe/load_frac/expert_{e:02d}"] = mean_load[e]
    dropped = router_stats.dropped.float()
    total_rows = (sel.sum() * float(n_tokens)).clamp_min(1.0)
    out["health/moe/dropped_rows"] = dropped
    out["health/moe/dropped_frac"] = dropped / total_rows
    return out
