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
  as a zero gradient without one being allocated;
- `lion` is `optax.lion` (b1 0.9, b2 0.99, weight decay 1e-3): u =
  sign((1 - b1) g + b1 mu) with sign(0) = 0, then mu <- (1 - b2) g +
  b2 mu, u += wd p, p -= lr u; its state is `mu`;
- `adafactor` is `optax.adafactor` over the JAX layout of each parameter
  (`adafactor.py`).

The offloaded state (`offload_optimizer_state`, `offload_state_dtype`,
`offload_quant_block` of the trainer) is a placement of this same state
(`offload.py`, `quantized_state.py`): the update is the same math, the
global-norm clip first, then one parameter (or JAX leaf) at a time.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from llm_training_tpu_torch.models.llama.from_jax import jax_layout, jax_path
from llm_training_tpu_torch.optim import adafactor
from llm_training_tpu_torch.optim.offload import StateStore
from llm_training_tpu_torch.optim.quantized_state import DEFAULT_BLOCK

_SCHEDULES = ("constant", "cosine", "linear")
# each optimizer's kwargs and their optax defaults
_KWARGS = {
    "adamw": {"b1": 0.9, "b2": 0.999, "eps": 1e-8, "eps_root": 0.0, "weight_decay": 1e-4},
    "adam": {"b1": 0.9, "b2": 0.999, "eps": 1e-8, "eps_root": 0.0},
    "sgd": {"momentum": None, "nesterov": False},
    "lion": {"b1": 0.9, "b2": 0.99, "weight_decay": 1e-3},
    "adafactor": adafactor.KWARGS,
}
_OFFLOAD_DEFAULTS = {"offload_optimizer_state": False, "offload_state_dtype": "float32",
                     "offload_quant_block": DEFAULT_BLOCK}
# elements of one unit of the elementwise update: bounds its temporaries
_CHUNK = 1 << 26


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


def _frozen(name: str, patterns: list[re.Pattern], scan_layers: bool = True) -> bool:
    """A parameter is frozen when a pattern matches the path `_freeze_mask`
    sees in the JAX package: the parameter's path in the JAX tree of the
    model's layout (`params/layers/layer/mlp/up_proj/kernel` when
    `scan_layers`, else `params/layers_0/mlp/up_proj/kernel`; a pair's
    `policy/` or `ref/` before it), never the port's dotted name. A name
    with no JAX counterpart (not a `Llama` parameter) matches as the tree
    of the same nesting would name it, joined by '/'."""
    path = jax_path(name, scan_layers)
    if path is None:
        path = name.replace(".", "/")
    return any(p.search(path) for p in patterns)


class Optimizer:
    """The optax chain of `build_optimizer` over named parameters, updated
    in place. Call `update()` once per micro-step after the backward; it
    applies the inner update on every `accumulate`-th call.

    The state lives in a `StateStore` (`offload.py`): on the parameters'
    device, or offloaded to pinned host memory through a storage codec. The
    update walks it unit by unit -- a row chunk of one parameter for the
    elementwise optimizers, one JAX leaf (`adafactor.Group`) for Adafactor
    -- after the global-norm clip, and frees each gradient once its
    parameter is updated. Per-parameter state keys are `<field>.<name>`;
    Adafactor's are `<field>.<JAX leaf>` in the JAX leaf's orientation
    (`from_jax.jax_layout`)."""

    def __init__(
        self,
        named_params: list[tuple[str, torch.nn.Parameter]],
        config: OptimConfig,
        schedule: Callable[[int], float],
        frozen_modules: list[str] | None = None,
        accumulate: int = 1,
        offload: bool = False,
        state_dtype: str = "float32",
        quant_block: int = DEFAULT_BLOCK,
        scan_layers: bool = True,
    ):
        if config.optimizer not in _KWARGS:
            raise ValueError(
                f"unknown optimizer {config.optimizer!r}; expected one of {sorted(_KWARGS)}"
            )
        unknown = set(config.optimizer_kwargs) - set(_KWARGS[config.optimizer])
        if unknown:
            raise TypeError(f"{config.optimizer} got unexpected kwargs {sorted(unknown)}")
        self.kind = config.optimizer
        self.hyper = {**_KWARGS[self.kind], **config.optimizer_kwargs}
        self.clip = config.grad_clip_norm
        self.schedule = schedule
        self.accumulate = accumulate
        self.offload = {"offload_optimizer_state": offload, "offload_state_dtype": state_dtype,
                        "offload_quant_block": quant_block}
        patterns = [re.compile(p) for p in frozen_modules or []]
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        self.trainable = [not _frozen(n, patterns, scan_layers) for n, _ in named_params]
        self.count = 0  # inner updates done
        self.mini_step = 0
        # set to {} before an update to collect, per parameter index, the
        # squared L2 norms (float32, on the device) of what the update adds
        # to it: the health metrics' update norms (telemetry/health.py)
        self.update_sq: dict[int, list[torch.Tensor]] | None = None
        # the state covers the trainable parameters only, as optax.masked
        # allocates it; the accumulator covers all of them
        self.live = [i for i, t in enumerate(self.trainable) if t]
        device = self.params[0].device if self.params else torch.device("cpu")
        self.store = StateStore(device, offload, state_dtype, quant_block)
        layouts = [jax_layout(n) for n in self.names]
        # the JAX array's last axis, where the codec's blocks run
        self._axis = [0 if transposed and p.ndim == 2 else -1
                      for p, (_, _, transposed) in zip(self.params, layouts)]
        zeros = lambda i: torch.zeros_like(self.params[i])  # noqa: E731
        if accumulate > 1:
            for i, name in enumerate(self.names):
                self.store.add(f"acc.{name}", zeros(i))
        if self.kind == "adafactor":
            self.groups = _groups(self.live, self.names, layouts)
            for group in self.groups:
                state = adafactor.init_state(group.shape(self.params), self.hyper, device)
                for field, value in state.items():
                    self.store.add(f"{field}.{group.name}", value)
                self.fields = tuple(state)
        else:
            momentum = self.kind == "sgd" and self.hyper["momentum"] is not None
            self.fields = {"adamw": ("mu", "nu"), "adam": ("mu", "nu"), "lion": ("mu",),
                           "sgd": ("trace",) if momentum else ()}[self.kind]
            for i in self.live:
                for field in self.fields:
                    self.store.add(f"{field}.{self.names[i]}", zeros(i), self._axis[i])

    # ------------------------------------------------------------ layout

    def layout(self) -> dict:
        """What the state's shape depends on: the optimizer, the
        accumulation factor, the offload placement and codec, and each
        parameter's shape, dtype and trainability (the freeze mask). A
        checkpoint restores only into the same layout."""
        return {
            "kind": self.kind,
            "accumulate": self.accumulate,
            **self.offload,
            "state": sorted({key.split(".", 1)[0] for key in self.store.entries}),
            "params": {
                name: {"shape": list(p.shape), "dtype": str(p.dtype).removeprefix("torch."),
                       "trainable": trainable}
                for name, p, trainable in zip(self.names, self.params, self.trainable)
            },
        }

    def check_layout(self, saved: dict) -> None:
        """Raise ValueError naming the first difference between a
        checkpoint's `layout()` and this optimizer's (a checkpoint written
        before the offload keys existed holds their defaults)."""
        live = self.layout()
        saved = {**_OFFLOAD_DEFAULTS, **saved}
        for key in ("kind", "accumulate", *_OFFLOAD_DEFAULTS, "state"):
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
        `mini_step` (MultiSteps), and the stored state by key (`<key>.q`
        and `<key>.scale` where the int8 codec encoded it). The
        per-parameter tensors are the live storage, not copies."""
        if self.mini_step == 0:  # between optimizer steps the accumulator is zero
            self.store.synchronize()
            for key, entry in self.store.entries.items():
                if key.startswith("acc."):
                    entry.parts[""].zero_()
        out = {
            "count": torch.tensor(self.count, dtype=torch.int64),
            "mini_step": torch.tensor(self.mini_step, dtype=torch.int64),
        }
        out.update(self.store.state_dict())
        return out

    @torch.no_grad()
    def load_state_dict(self, state: dict[str, torch.Tensor]) -> None:
        """Take `state_dict()`'s tensors back (copied into the live
        storage unless they are that storage). Raises KeyError on a
        missing or unexpected key."""
        live = self.state_dict()
        if set(state) != set(live):
            raise KeyError(
                f"optimizer state keys differ: missing {sorted(set(live) - set(state))}, "
                f"unexpected {sorted(set(state) - set(live))}"
            )
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])
        for key, buffer in live.items():
            if key not in ("count", "mini_step") and state[key].data_ptr() != buffer.data_ptr():
                buffer.copy_(state[key])

    # ------------------------------------------------------------ the update

    def _chunks(self, indices) -> list[tuple[int, tuple[int, int] | None]]:
        """(parameter, row range) units of at most `_CHUNK` elements; a
        range along a blocked dim 0 covers whole blocks."""
        out = []
        for i in indices:
            p = self.params[i]
            if p.ndim < 2 or p.numel() <= _CHUNK:
                out.append((i, None))
                continue
            step = max(1, _CHUNK // (p.numel() // p.shape[0]))
            if self._axis[i] == 0:
                block = self.offload["offload_quant_block"]
                step = max(block, step // block * block)
            out += [(i, (r, min(r + step, p.shape[0]))) for r in range(0, p.shape[0], step)]
        return out

    @torch.no_grad()
    def update(self) -> bool:
        """Consume the parameters' `.grad` (folded into the running mean,
        or clipped in place, and released); returns whether the parameters
        changed (every `accumulate`-th call)."""
        grads = [p.grad for p in self.params]
        for p in self.params:
            p.grad = None
        if self.accumulate > 1:
            n = self.mini_step
            final = n + 1 == self.accumulate
            # the final micro-step folds the mean into the trainable
            # parameters' gradients; a frozen one's is never read
            units = self._chunks(self.live if final else range(len(self.params)))
            keys = [([f"acc.{self.names[i]}"], rows) for i, rows in units]
            # the first micro-step's mean is its gradient: nothing to fetch
            stream = self.store.stream(keys, fetch=n > 0, write=not final)
            # iterate the stream itself: its write-back runs on each next()
            for u, work in enumerate(stream):
                i, rows = units[u]
                acc = work[f"acc.{self.names[i]}"]
                if final and grads[i] is None:
                    grads[i] = torch.zeros_like(self.params[i])
                g = grads[i] if rows is None or grads[i] is None else grads[i][rows[0]:rows[1]]
                if final:  # acc + (g - acc) / k, in the gradient's own memory
                    g.sub_(acc).div_(n + 1).add_(acc)
                elif n == 0:
                    acc.copy_(g) if g is not None else acc.zero_()
                elif g is None:  # a zero gradient: acc + (0 - acc) / (n + 1)
                    acc.sub_(acc / (n + 1))
                else:
                    acc.add_((g - acc) / (n + 1))
            if not final:
                self.mini_step += 1
                return False
            self.mini_step = 0
        self._inner_update(grads)
        return True

    def _inner_update(self, grads: list[torch.Tensor | None]) -> None:
        # a trainable parameter without a gradient takes a zero one, as the
        # unmasked optax chain sees it
        for i in self.live:
            if grads[i] is None:
                grads[i] = torch.zeros_like(self.params[i])
        if self.clip is not None and self.live:
            norm = global_norm([grads[i] for i in self.live])
            if not bool(norm < self.clip):
                for i in self.live:
                    grads[i].div_(norm).mul_(self.clip)
        lr = self.schedule(self.count)
        count = self.count
        self.count += 1
        if self.kind == "adafactor":
            units = [([f"{f}.{g.name}" for f in self.fields], None) for g in self.groups]
            for g, work in enumerate(self.store.stream(units)):
                group = self.groups[g]
                state = {k.split(".", 1)[0]: t for k, t in work.items()}
                adafactor.update(group, self.params, grads, state, count, lr, self.hyper,
                                 record=self._record if self.update_sq is not None else None)
                for i in group.members:
                    grads[i] = None
            return
        units = self._chunks(self.live)
        keys = [([f"{f}.{self.names[i]}" for f in self.fields], rows) for i, rows in units]
        for u, work in enumerate(self.store.stream(keys)):
            i, rows = units[u]
            p, g = self.params[i], grads[i]
            if rows is not None:
                p, g = p[rows[0]:rows[1]], g[rows[0]:rows[1]]
            state = [work[f"{f}.{self.names[i]}"] for f in self.fields]
            self._step(p, g, state, lr, i)
            if rows is None or rows[1] == self.params[i].shape[0]:
                grads[i] = None

    def _record(self, i: int, update: torch.Tensor, scale: float = 1.0) -> None:
        """Collect the squared norm of `scale * update` for parameter i."""
        sq = torch.linalg.vector_norm(update, dtype=torch.float32).square()
        self.update_sq.setdefault(i, []).append(sq * (scale * scale) if scale != 1.0 else sq)

    def _step(self, p: torch.Tensor, g: torch.Tensor, state: list[torch.Tensor],
              lr: float, i: int) -> None:
        """The elementwise optimizers' update of one parameter (or chunk of
        parameter i): p -= lr * u."""
        h = self.hyper
        if self.kind == "sgd":
            u = g
            if h["momentum"] is not None:
                (trace,) = state
                trace.mul_(h["momentum"]).add_(g)
                u = (g + h["momentum"] * trace) if h["nesterov"] else trace
        elif self.kind == "lion":
            (mu,) = state
            # sign((1 - b1) g + b1 mu), then mu <- (1 - b2) g + b2 mu
            u = torch.sign((1 - h["b1"]) * g + h["b1"] * mu)
            mu.copy_((1 - h["b2"]) * g + h["b2"] * mu)
            u.add_(p, alpha=h["weight_decay"])
        else:
            mu, nu = state
            mu.mul_(h["b1"]).add_(g, alpha=1 - h["b1"])
            nu.mul_(h["b2"]).add_(g * g, alpha=1 - h["b2"])
            u = mu / bias_correction(h["b1"], self.count)
            u.div_((nu / bias_correction(h["b2"], self.count) + h["eps_root"]).sqrt_()
                   .add_(h["eps"]))
            if self.kind == "adamw":
                u.add_(p, alpha=h["weight_decay"])
        if self.update_sq is not None:
            self._record(i, u, lr)
        p.add_(u, alpha=-lr)


def _groups(live: list[int], names: list[str], layouts) -> list[adafactor.Group]:
    """The JAX leaves of the trainable parameters, in first-seen order;
    a scanned stack's members in layer order."""
    by_leaf: dict[str, list[tuple[int, int]]] = {}
    info = {}
    for i in live:
        leaf, layer, transposed = layouts[i]
        by_leaf.setdefault(leaf, []).append((-1 if layer is None else layer, i))
        info[leaf] = (layer is not None, transposed)
    return [adafactor.Group(leaf, [i for _, i in sorted(members)], *info[leaf])
            for leaf, members in by_leaf.items()]


def bias_correction(decay: float, count: int) -> float:
    """`1 - decay**count` as optax's `scale_by_adam` computes it: in
    float32, `decay` rounded to float32 first (0.999 by 1.3e-8). The float32
    power is taken in float64 and rounded once; XLA's float32 `pow` differs
    from that in the last bit for some counts, but `1 -` the power equals
    JAX's factor for every count 1..2000 at 0.9 and 0.999."""
    power = np.float32(float(np.float32(decay)) ** int(count))
    return float(np.float32(1.0) - power)


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.stack([t.float().pow(2).sum() for t in tensors]).sum().sqrt()


def build_optimizer(
    config: OptimConfig,
    num_total_steps: int,
    named_params: list[tuple[str, torch.nn.Parameter]],
    frozen_modules: list[str] | None = None,
    accumulate: int = 1,
    **offload,
) -> tuple[Optimizer, Callable[[int], float]]:
    """The full chain (clip -> optimizer(schedule) [-> freeze mask]) over
    `named_params`, and its schedule. `offload` takes `Optimizer`'s
    `offload`, `state_dtype`, `quant_block` and `scan_layers` (the JAX
    layout `frozen_modules` match against)."""
    schedule = build_lr_schedule(config, num_total_steps)
    return Optimizer(named_params, config, schedule, frozen_modules, accumulate, **offload), schedule
