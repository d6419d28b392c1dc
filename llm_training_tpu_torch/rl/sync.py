"""Trainer -> engine weight sync.

Counterpart of `llm_training_tpu/rl/sync.py`. After every GRPO update the
serving engine must decode the next round under the new policy.
`ServingEngine.reload_weights` owns the hard half (evicting every request
in flight, the generation bump, the name/shape/dtype checks); sync hands
it the policy's tensors in one of two modes:

- `fused` (default): the tensors themselves. An engine built over the
  trainer's policy already holds them, so nothing is copied; any other
  engine binds them in place of its own.
- `host`: a round trip through host memory into the engine's own tensors
  (the correctness oracle): each tensor is copied to the host, then into
  the engine's tensor of that name.

Both hand `reload_weights` the same values, so the two modes continue a
request in flight token for token alike.
"""

from __future__ import annotations

import time
from typing import Any, Mapping

import torch

from llm_training_tpu_torch.telemetry.registry import get_registry
from llm_training_tpu_torch.telemetry.trace import get_tracer

_MODES = ("fused", "host")


@torch.no_grad()
def sync_weights(engine: Any, weights: Mapping[str, torch.Tensor], mode: str = "fused") -> dict:
    """Push `weights` (the policy's `state_dict(keep_vars=True)`) into
    `engine` and bump its weights generation. Returns a summary (mode,
    generation, sync_time_s, leaves)."""
    if mode not in _MODES:
        raise ValueError(f"sync mode must be one of {_MODES}, got {mode!r}")
    t0 = time.perf_counter()
    with get_tracer().measure("rl", "weight_sync", mode=mode):
        if mode == "host":
            held = engine.model.state_dict(keep_vars=True)
            host = {name: tensor.detach().to("cpu", copy=True)
                    for name, tensor in weights.items()}
            fits = set(host) == set(held) and all(
                (held[n].shape, held[n].dtype) == (t.shape, t.dtype) for n, t in host.items())
            # a tree that does not fit is handed on as it is: reload_weights
            # names the mismatch before the engine's tensors change
            placed = host
            if fits:
                for name, tensor in host.items():
                    held[name].detach().copy_(tensor)
                placed = held
                if any(t.device.type == "cuda" for t in held.values()):
                    torch.cuda.synchronize()
        else:
            placed = dict(weights)
        generation = engine.reload_weights(placed)
    dt = time.perf_counter() - t0
    registry = get_registry()
    registry.gauge("rl/weight_syncs").set(float(generation))
    registry.gauge("rl/sync_time_s").set(dt)
    return {"mode": mode, "generation": int(generation), "sync_time_s": dt,
            "leaves": len(placed)}
