"""The training loop.

Counterpart of the core of `llm_training_tpu/trainer/trainer.py`: the
train step of `_make_step` (forward, backward, global grad norm, the
optimizer chain) and the micro-step loop of `_fit_inner`, with gradient
accumulation as `optax.MultiSteps` does it, metrics on log steps and the
validation loss. `max_steps` counts optimizer steps: the loop runs
`max_steps * accumulate_grad_batches` micro-steps, and the schedule
advances once per optimizer step.

Mesh, offload, health, resilience, checkpointing and telemetry are not
ported yet (ROADMAP A.2).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from llm_training_tpu_torch import resolve_device
from llm_training_tpu_torch.optim.builder import build_optimizer, global_norm
from llm_training_tpu_torch.trainer.state import TrainState

logger = logging.getLogger(__name__)


@dataclass
class TrainerConfig:
    max_steps: int = 1000
    seed: int = 42
    accumulate_grad_batches: int = 1
    log_every_n_steps: int = 10
    val_check_interval: int | None = None
    limit_val_batches: int | None = None


def _to_device(batch: dict[str, np.ndarray], device: torch.device) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


def _batch_counts(batch: dict[str, np.ndarray]) -> tuple[int, int]:
    """(samples, tokens) of a host batch: tokens are the non-padding ones."""
    seg = batch.get("segment_ids")
    tokens = int((seg > 0).sum()) if seg is not None else int(batch["input_ids"].size)
    return int(batch["input_ids"].shape[0]), tokens


class Trainer:
    """Drives an objective over a datamodule: `Trainer(config).fit(objective,
    datamodule)`. Callbacks may define `on_fit_start`, `on_train_step`
    (every optimizer step), `on_step_end` (log steps, with host metrics),
    `on_validation_end` and `on_fit_end`."""

    def __init__(
        self,
        config: TrainerConfig,
        callbacks: list[Any] | None = None,
        device: torch.device | str | None = None,
        run_config: dict | None = None,
    ):
        self.config = config
        self.callbacks = callbacks or []
        self.device = resolve_device(device)
        self.run_config = run_config
        self.counters = {"consumed_samples": 0, "consumed_tokens": 0}

    def _callbacks(self, hook: str, *args) -> None:
        for cb in self.callbacks:
            if hasattr(cb, hook):
                getattr(cb, hook)(self, *args)

    def fit(self, objective, datamodule) -> TrainState:
        cfg = self.config
        datamodule.setup()
        device = self.device
        init = torch.Generator(device=device).manual_seed(cfg.seed)
        model = objective.configure_model(device, init)
        model.train()
        optimizer, schedule = build_optimizer(
            objective.config.optim, cfg.max_steps, list(model.named_parameters()),
            frozen_modules=objective.config.frozen_modules,
            accumulate=cfg.accumulate_grad_batches,
        )
        state = TrainState(
            step=0, model=model, optimizer=optimizer,
            generator=torch.Generator(device=device).manual_seed(cfg.seed + 1),
        )
        self._callbacks("on_fit_start", objective, datamodule, 0)

        batches = datamodule.train_batches(start_step=0)
        micro_steps = cfg.max_steps * cfg.accumulate_grad_batches
        window_time, window_step = time.perf_counter(), 0
        for micro in range(micro_steps):
            host_batch = next(batches)
            metrics = self.train_micro_step(objective, state, host_batch)
            samples, tokens = _batch_counts(host_batch)
            self.counters["consumed_samples"] += samples
            self.counters["consumed_tokens"] += tokens

            if (micro + 1) % cfg.accumulate_grad_batches:
                continue
            step = (micro + 1) // cfg.accumulate_grad_batches
            self._callbacks("on_train_step", step)
            if step % cfg.log_every_n_steps == 0 or step == cfg.max_steps:
                host = {k: float(v) for k, v in metrics.items()}
                now = time.perf_counter()
                host["lr"] = float(schedule(step))
                host["steps_per_sec"] = (step - window_step) / max(now - window_time, 1e-9)
                host.update(self.counters)
                window_time, window_step = now, step
                logger.info("step %d | loss %.4f | grad_norm %.3f | %.2f steps/s",
                            step, host["loss"], host["grad_norm"], host["steps_per_sec"])
                self._callbacks("on_step_end", step, host)
            if step == 1:
                # the first step's warm-up stays out of the throughput window
                window_time, window_step = time.perf_counter(), step
            if cfg.val_check_interval and step % cfg.val_check_interval == 0:
                self._run_validation(objective, datamodule, step)
        self._callbacks("on_fit_end")
        return state

    def train_micro_step(self, objective, state: TrainState, host_batch) -> dict:
        """One train-step call (`_make_step` in JAX): forward and backward on
        one micro-batch, the gradients' global norm, and the optimizer chain
        (which updates the parameters on every k-th call). Returns the
        micro-batch's metrics, on the device."""
        params = [p for p in state.model.parameters() if p.requires_grad]
        for p in params:
            p.grad = None
        batch = _to_device(host_batch, self.device)
        loss, metrics = objective.loss_and_metrics(batch, generator=state.generator, train=True)
        loss.backward()
        metrics["grad_norm"] = global_norm([p.grad for p in params if p.grad is not None])
        state.optimizer.update()
        state.step += 1
        return metrics

    @torch.no_grad()
    def _run_validation(self, objective, datamodule, step: int) -> float | None:
        losses, weights = [], []
        for i, host_batch in enumerate(datamodule.val_batches()):
            if self.config.limit_val_batches and i >= self.config.limit_val_batches:
                break
            _, metrics = objective.loss_and_metrics(_to_device(host_batch, self.device), train=False)
            losses.append(float(metrics["loss"]))
            weights.append(float(metrics["target_tokens"]))
        if not losses:
            return None
        val_loss = float(np.average(losses, weights=weights))
        logger.info("step %d | val_loss %.4f", step, val_loss)
        self._callbacks("on_validation_end", step, {"val_loss": val_loss})
        return val_loss
