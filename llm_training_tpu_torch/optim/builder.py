"""Optimizer and learning-rate schedule construction from config.

Counterpart of `llm_training_tpu/optim/builder.py`, which builds an optax
chain: clip by global norm -> adamw / adam / sgd under a warmup-composed
schedule [-> freeze mask], wrapped by the trainer in `optax.MultiSteps`
for gradient accumulation. The port implements those semantics itself on
the model's parameters, because torch's optimizers differ from optax's:

- `optax.adamw` decays by 1e-4 when `optimizer_kwargs` is empty
  (`torch.optim.AdamW` by 1e-2), scales the decay by the learning rate,
  and decays every trainable parameter, norms and embeddings included;
- optax puts eps outside the square root (`eps_root` inside) and
  bias-corrects mu and nu;
- the schedule is read at the optimizer's count BEFORE it increments, so
  the first update after warmup starts uses schedule(0) (0 with warmup);
- clipping rescales `g / norm * max_norm` when norm >= max_norm, over the
  trainable parameters only (the freeze mask wraps the clip too);
- accumulation keeps the running mean of k micro-batch gradients
  (`acc + (g - acc) / (n + 1)`) and runs the inner update on every k-th
  call; the schedule's count advances once per k micro-steps;
- the freeze mask is structural, as `optax.masked` makes it: a frozen
  parameter has no `mu`, `nu` or `trace`, while the accumulator covers
  every parameter, as `MultiSteps` wraps the whole tree. A parameter with
  no gradient (one that does not require it, as DPO's reference) counts
  as a zero gradient without one being allocated.

`lion` and `adafactor` are not ported yet (ROADMAP A.2).
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from llm_training_tpu_torch.models.llama.from_jax import jax_paths

_OPTIMIZERS = ("adamw", "adam", "sgd")
_NOT_PORTED = ("adafactor", "lion")
_SCHEDULES = ("constant", "cosine", "linear")
_KWARGS = {
    "adamw": {"b1": 0.9, "b2": 0.999, "eps": 1e-8, "eps_root": 0.0, "weight_decay": 1e-4},
    "adam": {"b1": 0.9, "b2": 0.999, "eps": 1e-8, "eps_root": 0.0},
    "sgd": {"momentum": None, "nesterov": False},
}


@dataclass
class OptimConfig:
    """Mirrors the JAX `OptimConfig`: which optimizer and its kwargs, which
    warmup schedule and its kwargs, plus grad clipping."""

    optimizer: str = "adamw"
    learning_rate: float = 1e-4
    optimizer_kwargs: dict[str, Any] = field(default_factory=dict)
    lr_scheduler: str | None = "cosine"
    warmup_steps: int = 0
    min_lr_ratio: float = 0.0  # cosine/linear floor as a fraction of peak lr
    lr_scheduler_kwargs: dict[str, Any] = field(default_factory=dict)
    grad_clip_norm: float | None = 1.0


def _linear(init: float, end: float, steps: int, transition_begin: int = 0) -> Callable[[int], float]:
    """optax.linear_schedule (a polynomial schedule of power 1)."""

    def schedule(count: int) -> float:
        c = min(max(count - transition_begin, 0), steps)
        return (init - end) * (1 - c / steps) + end

    return schedule


def _cosine(peak: float, steps: int, alpha: float, exponent: float = 1.0) -> Callable[[int], float]:
    """optax.cosine_decay_schedule(peak, steps, alpha=alpha)."""

    def schedule(count: int) -> float:
        c = min(count, steps)
        decay = 0.5 * (1 + math.cos(math.pi * c / steps))
        return peak * ((1 - alpha) * decay**exponent + alpha)

    return schedule


def build_lr_schedule(config: OptimConfig, num_total_steps: int) -> Callable[[int], float]:
    """Warmup (linear from 0 to the peak over `warmup_steps`) joined with
    the inner schedule over the remaining `num_total_steps - warmup_steps`."""
    peak = config.learning_rate
    decay_steps = max(num_total_steps - config.warmup_steps, 1)
    name = config.lr_scheduler or "constant"
    if name == "constant":
        inner = lambda count: peak  # noqa: E731
    elif name == "cosine":
        inner = _cosine(peak, decay_steps, config.min_lr_ratio, **config.lr_scheduler_kwargs)
    elif name == "linear":
        inner = _linear(peak, peak * config.min_lr_ratio, decay_steps,
                        **config.lr_scheduler_kwargs)
    else:
        raise ValueError(f"unknown lr_scheduler {name!r}; expected one of {_SCHEDULES}")
    if config.warmup_steps <= 0:
        return inner
    warmup = _linear(0.0, peak, config.warmup_steps)
    boundary = config.warmup_steps
    return lambda count: warmup(count) if count < boundary else inner(count - boundary)


def _frozen(name: str, patterns: list[re.Pattern]) -> bool:
    """A parameter is frozen when a pattern matches its name, dotted
    (`model.embed_tokens.weight`) or joined by '/', or its path in the JAX
    package's parameter tree (`params/layers/layer/mlp/up_proj/kernel`,
    `params/layers_0/...`), which is what `_freeze_mask` matches there: a
    config written for the JAX package freezes the same parameters."""
    forms = [name, name.replace(".", "/"), *jax_paths(name)]
    return any(p.search(form) for p in patterns for form in forms)


class Optimizer:
    """The optax chain of `build_optimizer` over named parameters, updated
    in place. Call `update()` once per micro-step after the backward; it
    applies the inner update on every `accumulate`-th call."""

    def __init__(
        self,
        named_params: list[tuple[str, torch.nn.Parameter]],
        config: OptimConfig,
        schedule: Callable[[int], float],
        frozen_modules: list[str] | None = None,
        accumulate: int = 1,
    ):
        if config.optimizer in _NOT_PORTED:
            raise NotImplementedError(
                f"optimizer {config.optimizer!r} is not ported yet (ROADMAP A.2); "
                f"use one of {_OPTIMIZERS}"
            )
        if config.optimizer not in _OPTIMIZERS:
            raise ValueError(
                f"unknown optimizer {config.optimizer!r}; expected one of "
                f"{sorted(_OPTIMIZERS + _NOT_PORTED)}"
            )
        unknown = set(config.optimizer_kwargs) - set(_KWARGS[config.optimizer])
        if unknown:
            raise TypeError(f"{config.optimizer} got unexpected kwargs {sorted(unknown)}")
        self.kind = config.optimizer
        self.hyper = {**_KWARGS[self.kind], **config.optimizer_kwargs}
        self.clip = config.grad_clip_norm
        self.schedule = schedule
        self.accumulate = accumulate
        patterns = [re.compile(p) for p in frozen_modules or []]
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        self.trainable = [not _frozen(n, patterns) for n, _ in named_params]
        self.count = 0  # inner updates done
        self.mini_step = 0
        # the moments of trainable parameters only (index-aligned with
        # `self.live`), as optax.masked allocates them
        self.live = [i for i, t in enumerate(self.trainable) if t]
        zeros = lambda idx: [torch.zeros_like(self.params[i]) for i in idx]  # noqa: E731
        self.acc = zeros(range(len(self.params))) if accumulate > 1 else None
        if self.kind in ("adamw", "adam"):
            self.mu, self.nu = zeros(self.live), zeros(self.live)
        elif self.hyper["momentum"] is not None:
            self.trace = zeros(self.live)

    def _buffers(self) -> dict[str, tuple[list[str], list[torch.Tensor]]]:
        """The per-parameter state lists this optimizer holds, by optax's
        names, each with the names of the parameters it covers: `mu`/`nu`
        (adam, adamw) and `trace` (sgd with momentum) over the trainable
        parameters, `acc` (MultiSteps' running mean, with accumulation)
        over all of them."""
        live_names = [self.names[i] for i in self.live]
        out = {}
        for name in ("mu", "nu", "trace", "acc"):
            buffers = getattr(self, name, None)
            if buffers is not None:
                out[name] = (self.names if name == "acc" else live_names, buffers)
        return out

    def layout(self) -> dict:
        """What the state's shape depends on: the optimizer, the
        accumulation factor, and each parameter's shape, dtype and
        trainability (the freeze mask). A checkpoint restores only into
        the same layout."""
        return {
            "kind": self.kind,
            "accumulate": self.accumulate,
            "state": sorted(self._buffers()),
            "params": {
                name: {"shape": list(p.shape), "dtype": str(p.dtype).removeprefix("torch."),
                       "trainable": trainable}
                for name, p, trainable in zip(self.names, self.params, self.trainable)
            },
        }

    def check_layout(self, saved: dict) -> None:
        """Raise ValueError naming the first difference between a
        checkpoint's `layout()` and this optimizer's."""
        live = self.layout()
        for key in ("kind", "accumulate", "state"):
            if saved.get(key) != live[key]:
                raise ValueError(
                    f"optimizer {key}: checkpoint has {saved.get(key)!r}, this run {live[key]!r}"
                )
        saved_params = saved.get("params", {})
        if list(saved_params) != list(live["params"]):
            missing = sorted(set(live["params"]) - set(saved_params))
            extra = sorted(set(saved_params) - set(live["params"]))
            raise ValueError(
                f"optimizer parameters differ: missing from the checkpoint {missing}, "
                f"not in this run {extra}"
            )
        for name, entry in live["params"].items():
            if saved_params[name] != entry:
                raise ValueError(
                    f"optimizer parameter {name}: checkpoint has {saved_params[name]}, "
                    f"this run {entry}"
                )

    def state_dict(self) -> dict[str, torch.Tensor]:
        """The optax state as named tensors: `count` (inner updates),
        `mini_step` (MultiSteps), and `{mu,nu,trace,acc}.<parameter>`. The
        per-parameter tensors are the live buffers, not copies."""
        out = {
            "count": torch.tensor(self.count, dtype=torch.int64),
            "mini_step": torch.tensor(self.mini_step, dtype=torch.int64),
        }
        for kind, (names, buffers) in self._buffers().items():
            out.update({f"{kind}.{name}": t for name, t in zip(names, buffers)})
        return out

    @torch.no_grad()
    def load_state_dict(self, state: dict[str, torch.Tensor]) -> None:
        """Take `state_dict()`'s tensors back (copied into the live
        buffers unless they are those buffers). Raises KeyError on a
        missing or unexpected key."""
        expected = set(self.state_dict())
        if set(state) != expected:
            raise KeyError(
                f"optimizer state keys differ: missing {sorted(expected - set(state))}, "
                f"unexpected {sorted(set(state) - expected)}"
            )
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])
        for kind, (names, buffers) in self._buffers().items():
            for name, buffer in zip(names, buffers):
                source = state[f"{kind}.{name}"]
                if source.data_ptr() != buffer.data_ptr():
                    buffer.copy_(source)

    @torch.no_grad()
    def update(self) -> bool:
        """Consume the parameters' `.grad` (clipped in place, or folded into
        the running mean and released); returns whether the parameters
        changed (every `accumulate`-th call)."""
        grads = [p.grad for p in self.params]
        if self.acc is not None:
            for acc, g in zip(self.acc, grads):
                if g is None:  # a zero gradient: acc + (0 - acc) / (n + 1)
                    acc.sub_(acc / (self.mini_step + 1))
                else:
                    acc.add_((g - acc) / (self.mini_step + 1))
            for p in self.params:
                p.grad = None
            self.mini_step += 1
            if self.mini_step < self.accumulate:
                return False
            self.mini_step = 0
            grads = self.acc  # zeroed below, after the inner update
        self._inner_update(grads)
        if self.acc is not None:
            for acc in self.acc:
                acc.zero_()
        return True

    def _inner_update(self, grads: list[torch.Tensor | None]) -> None:
        # a trainable parameter without a gradient takes a zero one, as the
        # unmasked optax chain sees it
        live = [(j, i, grads[i] if grads[i] is not None else torch.zeros_like(self.params[i]))
                for j, i in enumerate(self.live)]
        if self.clip is not None and live:
            norm = global_norm([g for _, _, g in live])
            if not bool(norm < self.clip):
                for _, _, g in live:
                    g.div_(norm).mul_(self.clip)
        lr = self.schedule(self.count)
        self.count += 1
        h = self.hyper
        for j, i, g in live:
            p = self.params[i]
            if self.kind == "sgd":
                u = g
                if h["momentum"] is not None:
                    self.trace[j].mul_(h["momentum"]).add_(g)
                    u = (g + h["momentum"] * self.trace[j]) if h["nesterov"] else self.trace[j]
                p.add_(u, alpha=-lr)
                continue
            mu, nu = self.mu[j], self.nu[j]
            mu.mul_(h["b1"]).add_(g, alpha=1 - h["b1"])
            nu.mul_(h["b2"]).add_(g * g, alpha=1 - h["b2"])
            u = mu / (1 - h["b1"] ** self.count)
            u.div_((nu / (1 - h["b2"] ** self.count) + h["eps_root"]).sqrt_().add_(h["eps"]))
            if self.kind == "adamw":
                u.add_(p, alpha=h["weight_decay"])
            p.add_(u, alpha=-lr)


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.stack([t.float().pow(2).sum() for t in tensors]).sum().sqrt()


def build_optimizer(
    config: OptimConfig,
    num_total_steps: int,
    named_params: list[tuple[str, torch.nn.Parameter]],
    frozen_modules: list[str] | None = None,
    accumulate: int = 1,
) -> tuple[Optimizer, Callable[[int], float]]:
    """The full chain (clip -> optimizer(schedule) [-> freeze mask]) over
    `named_params`, and its schedule."""
    schedule = build_lr_schedule(config, num_total_steps)
    return Optimizer(named_params, config, schedule, frozen_modules, accumulate), schedule
