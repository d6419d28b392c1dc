"""The training loop.

Counterpart of the core of `llm_training_tpu/trainer/trainer.py`: the
train step of `_make_step` (forward, backward, global grad norm, the
optimizer chain) and the micro-step loop of `_fit_inner`, with gradient
accumulation as `optax.MultiSteps` does it, metrics on log steps and the
validation loss. `max_steps` counts optimizer steps: the loop runs
`max_steps * accumulate_grad_batches` micro-steps, and the schedule
advances once per optimizer step.

The run lifecycle: with a `Checkpointer`, `fit` restores the newest (or a
given) step before its loop -- state, consumed counters, callback state --
and restarts the data stream at the restored micro-step, saves every
`checkpoint_every_n_steps` optimizer steps (never a state whose loss is
not finite) and once at the end, then waits for the write.
`restore_for_inference` is the read-only restore of the inference and
validation commands.

`prefetch_batches` (default 2, as JAX's) places batches on the device a
few steps ahead on a worker thread (`data/prefetch.py`); 0 places each
batch when the step takes it. `offload_optimizer_state` keeps the
optimizer's state in pinned host memory between updates, stored through
`offload_state_dtype` (float32, bfloat16, or int8 blocks of
`offload_quant_block` elements; `optim/offload.py`), with JAX's defaults
and validation errors.

Mesh, health, resilience and telemetry are not ported yet (ROADMAP A.3,
A.4, A.9).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from llm_training_tpu_torch import prng, resolve_device
from llm_training_tpu_torch.data.prefetch import DevicePrefetcher, to_device
from llm_training_tpu_torch.optim.builder import build_optimizer, global_norm
from llm_training_tpu_torch.optim.offload import check_offload_keys
from llm_training_tpu_torch.trainer.checkpoint import Checkpointer
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
    checkpoint_every_n_steps: int | None = None
    # batches placed on the device ahead of the step by a worker thread; 0
    # places each batch when the step takes it
    prefetch_batches: int = 2
    # keep the optimizer state in pinned host memory between updates,
    # copied through the device around each update
    offload_optimizer_state: bool = False
    # its storage: float32 (exact), bfloat16 (cast), or int8 (block codec:
    # optim/quantized_state.py)
    offload_state_dtype: str = "float32"
    # the int8 codec's block (elements of the JAX array's last axis that
    # share one scale)
    offload_quant_block: int = 256

    def __post_init__(self):
        check_offload_keys(self.offload_optimizer_state, self.offload_state_dtype,
                           self.offload_quant_block)


def _batch_counts(batch: dict[str, np.ndarray]) -> tuple[int, int]:
    """(samples, tokens) of a host batch, CLM (`input_ids`) or preference
    (`chosen_input_ids`, `rejected_input_ids`): tokens are the non-padding
    ones of every `*input_ids` key, by its `*segment_ids`."""
    id_keys = [k for k in batch if k == "input_ids" or k.endswith("_input_ids")]
    tokens = 0
    for key in id_keys:
        seg = batch.get(key[: -len("input_ids")] + "segment_ids")
        tokens += int((seg > 0).sum()) if seg is not None else int(batch[key].size)
    return int(batch[id_keys[0]].shape[0]), tokens


class Trainer:
    """Drives an objective over a datamodule: `Trainer(config).fit(objective,
    datamodule)`. Callbacks may define `on_fit_start`, `on_train_step`
    (every optimizer step), `on_step_end` (log steps, with host metrics),
    `on_validation_end` and `on_fit_end`, and `state_dict` /
    `load_state_dict` for state that a checkpoint carries. A callback stops
    the loop early by setting `trainer.should_stop`; `trainer.state` is the
    live `TrainState` from the fit's start (after any restore)."""

    def __init__(
        self,
        config: TrainerConfig,
        callbacks: list[Any] | None = None,
        device: torch.device | str | None = None,
        run_config: dict | None = None,
        checkpointer: Checkpointer | None = None,
    ):
        self.config = config
        self.callbacks = callbacks or []
        self.device = resolve_device(device)
        self.run_config = run_config
        self.checkpointer = checkpointer
        self.counters = {"consumed_samples": 0, "consumed_tokens": 0}
        self.state: TrainState | None = None
        self.should_stop = False
        # the last optimizer step of a fit, its metrics, and its interval save
        self.last_step: int | None = None
        self.last_metrics: dict | None = None
        self._last_interval_save: int | None = None
        self._global_batch_size: int | None = None

    def _callbacks(self, hook: str, *args) -> None:
        for cb in self.callbacks:
            if hasattr(cb, hook):
                getattr(cb, hook)(self, *args)

    def init_state(self, objective, with_optimizer: bool = True):
        """The model on the device (random from the seed, or the objective's
        own) and, for training, its optimizer chain: the state a fresh fit
        starts from and a restore loads into (and what a state carried from
        the JAX package loads into: `models/llama/from_jax.py`). Returns
        (state, schedule); both optimizer and schedule are None without the
        optimizer."""
        cfg = self.config
        init = torch.Generator(device=self.device).manual_seed(cfg.seed)
        model = objective.configure_model(self.device, init)
        optimizer = schedule = None
        if with_optimizer:
            optimizer, schedule = build_optimizer(
                objective.config.optim, cfg.max_steps, list(model.named_parameters()),
                frozen_modules=objective.config.frozen_modules,
                accumulate=cfg.accumulate_grad_batches,
                offload=cfg.offload_optimizer_state, state_dtype=cfg.offload_state_dtype,
                quant_block=cfg.offload_quant_block,
            )
        state = TrainState(step=0, model=model, optimizer=optimizer, rng=prng.key(cfg.seed + 1))
        return state, schedule

    def _restore(self, state: TrainState, resume_step: int | None) -> dict | None:
        try:
            meta = self.checkpointer.maybe_restore(state, resume_step)
        except Exception as e:
            # the optimizer state's layout depends on run settings, so
            # changing them across a resume cannot restore
            raise RuntimeError(
                "checkpoint restore failed — note the optimizer-state layout depends on "
                "the optimizer, offload_optimizer_state, offload_state_dtype, "
                "offload_quant_block, accumulate_grad_batches and frozen_modules; resume "
                "with the same settings the checkpoint was written with"
            ) from e
        return meta

    def fit(self, objective, datamodule, resume_step: int | None = None) -> TrainState:
        """Train to `max_steps` optimizer steps: from the newest checkpoint
        (or `resume_step`) when the checkpointer has one, else from the seed."""
        cfg = self.config
        datamodule.setup()
        state, schedule = self.init_state(objective, with_optimizer=True)
        state.model.train()
        saved_data_state = None
        if self.checkpointer is not None:
            meta = self._restore(state, resume_step)
            if meta is not None:
                self.counters.update(meta.get("counters", {}))
                saved_data_state = meta.get("data_state")
                self._load_callback_state(meta)
        self.state = state
        start_micro = state.step
        self._callbacks("on_fit_start", objective, datamodule,
                        start_micro // cfg.accumulate_grad_batches)

        self.should_stop = False
        self.last_step = self.last_metrics = self._last_interval_save = None
        self._global_batch_size = None
        batches = self.train_stream(datamodule, start_micro)
        try:
            self._loop(objective, datamodule, state, batches, start_micro, schedule,
                       saved_data_state)
        finally:
            if isinstance(batches, DevicePrefetcher):
                batches.close()

        if self.checkpointer is not None:
            last = self.last_step
            if (last is not None and last != self._last_interval_save
                    and self._loss_finite(self.last_metrics, last)):
                # the step reached, early stop or not; force: the step may
                # collide with a stale entry of a previous run of the directory
                self.checkpointer.save(last, state, counters=dict(self.counters), force=True,
                                       extra=self._save_extra(last))
            # the barrier: after this the newest save is durable
            self.checkpointer.wait()
        self._callbacks("on_fit_end")
        return state

    def train_stream(self, datamodule, start_micro: int):
        """The fit's batches from micro-step `start_micro` as `(batch,
        (samples, tokens))` pairs: a `DevicePrefetcher` (close it) with
        `prefetch_batches` > 0, else host batches placed as they are taken.
        The stream is a pure function of (seed, micro-step): a resume
        continues it where the checkpoint stopped."""
        depth = self.config.prefetch_batches
        if depth > 0:
            return DevicePrefetcher(
                lambda produced: datamodule.train_batches(start_step=start_micro + produced),
                self.device, depth=depth, host_aux_fn=_batch_counts,
            )
        return ((to_device(b, self.device), _batch_counts(b))
                for b in datamodule.train_batches(start_step=start_micro))

    def _loop(self, objective, datamodule, state, batches, start_micro, schedule,
              saved_data_state):
        cfg = self.config
        micro_steps = cfg.max_steps * cfg.accumulate_grad_batches
        first_step = start_micro // cfg.accumulate_grad_batches + 1
        window_time, window_step = time.perf_counter(), first_step - 1
        for micro in range(start_micro, micro_steps):
            batch, (samples, tokens) = next(batches)
            if self._global_batch_size is None:
                self._global_batch_size = samples
                self._check_data_continuity(saved_data_state)
            metrics = self.train_micro_step(objective, state, batch)
            self.counters["consumed_samples"] += samples
            self.counters["consumed_tokens"] += tokens

            if (micro + 1) % cfg.accumulate_grad_batches:
                continue
            step = (micro + 1) // cfg.accumulate_grad_batches
            self.last_step, self.last_metrics = step, metrics
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
            if step == first_step:
                # the first step's warm-up stays out of the throughput window
                window_time, window_step = time.perf_counter(), step
            if cfg.val_check_interval and step % cfg.val_check_interval == 0:
                self._run_validation(objective, datamodule, step)
            if (
                self.checkpointer is not None
                and cfg.checkpoint_every_n_steps
                and step % cfg.checkpoint_every_n_steps == 0
                and self._loss_finite(metrics, step)
            ):
                self.checkpointer.save(step, state, counters=dict(self.counters),
                                       extra=self._save_extra(step))
                self._last_interval_save = step
            if self.should_stop:
                logger.info("stopping at step %d (callback request)", step)
                break

    def train_micro_step(self, objective, state: TrainState, batch) -> dict:
        """One train-step call (`_make_step` in JAX): forward and backward on
        one micro-batch (host arrays, or tensors already on the device), the
        gradients' global norm, and the optimizer chain (which updates the
        parameters on every k-th call). Returns the micro-batch's metrics,
        on the device."""
        params = [p for p in state.model.parameters() if p.requires_grad]
        for p in params:
            p.grad = None
        batch = to_device(batch, self.device)
        # micro-step n's key, as JAX's fold_in(state.rng, state.step)
        step_rng = prng.fold_in(state.rng, state.step)
        loss, metrics = objective.loss_and_metrics(batch, rng=step_rng, train=True)
        loss.backward()
        # over the gradients there are: a parameter that requires none (DPO's
        # reference) adds the zero that JAX's stop_gradient gives it
        metrics["grad_norm"] = global_norm([p.grad for p in params if p.grad is not None])
        state.optimizer.update()
        state.step += 1
        return metrics

    @torch.no_grad()
    def _val_loss(self, objective, datamodule, limit: int | None) -> float | None:
        """The validation batches' losses averaged by their target tokens;
        None when there are none."""
        losses, weights = [], []
        for i, host_batch in enumerate(datamodule.val_batches()):
            if limit and i >= limit:
                break
            _, metrics = objective.loss_and_metrics(to_device(host_batch, self.device), train=False)
            losses.append(float(metrics["loss"]))
            weights.append(float(metrics["target_tokens"]))
        if not losses:
            return None
        return float(np.average(losses, weights=weights))

    def _run_validation(self, objective, datamodule, step: int) -> float | None:
        val_loss = self._val_loss(objective, datamodule, self.config.limit_val_batches)
        if val_loss is None:
            return None
        logger.info("step %d | val_loss %.4f", step, val_loss)
        self._callbacks("on_validation_end", step, {"val_loss": val_loss})
        return val_loss

    @staticmethod
    def _loss_finite(metrics, step) -> bool:
        """True when this step's loss can be persisted. Syncs with the
        device, so it runs on checkpoint steps only: a diverged state never
        becomes the newest checkpoint."""
        if metrics is None or "loss" not in metrics:
            return True
        loss = float(metrics["loss"])
        if np.isfinite(loss):
            return True
        logger.warning("skipping checkpoint at step %d: non-finite loss %s", step, loss)
        return False

    def _save_extra(self, step: int) -> dict:
        """JSON riders of a checkpoint: the data-stream cursor (samples
        drawn so far and the global batch it is keyed to) and every
        callback's `state_dict`."""
        extra: dict = {}
        if self._global_batch_size:
            micro = step * self.config.accumulate_grad_batches
            extra["data_state"] = {
                "global_batch_size": self._global_batch_size,
                "sample_cursor": micro * self._global_batch_size,
                # one process serves the whole global batch
                "replica_stride": self._global_batch_size,
            }
        cb_state: dict = {}
        for cb in self.callbacks:
            fn = getattr(cb, "state_dict", None)
            if callable(fn):
                try:
                    cb_state[type(cb).__name__] = fn()
                except Exception:
                    logger.exception("callback %s state_dict failed (not persisted)",
                                     type(cb).__name__)
        if cb_state:
            extra["callbacks"] = cb_state
        return extra

    def _check_data_continuity(self, data_state: dict | None) -> None:
        """Warn when a resume changes the global batch: the stream's cursor
        is keyed to it, so the restored micro-step would address other
        samples (the reference's legacy, non-elastic path warns too)."""
        saved = int((data_state or {}).get("global_batch_size", 0) or 0)
        current = self._global_batch_size
        if saved and saved != current:
            logger.warning(
                "resume changes the GLOBAL batch size %d -> %d: the checkpoint's sample "
                "cursor (%s samples) no longer addresses the same data", saved, current,
                data_state.get("sample_cursor", "?"),
            )

    def _load_callback_state(self, meta: dict | None) -> None:
        """Callback state from checkpoint metadata, by class name; absent
        entries and failures leave the callback as constructed."""
        states = (meta or {}).get("callbacks") or {}
        for cb in self.callbacks:
            data = states.get(type(cb).__name__)
            if data is not None and hasattr(cb, "load_state_dict"):
                try:
                    cb.load_state_dict(data)
                except Exception:
                    logger.exception("callback %s load_state_dict failed (starting fresh)",
                                     type(cb).__name__)

    # ------------------------------------------------------------ validate

    def restore_for_inference(self, objective, resume_step: int | None = None) -> TrainState:
        """Read-only restore for `validate`, `generate`, `evaluate` and
        `serve`: builds the objective's model on the device and loads the
        newest (or given) step's parameters, step and key into it. Never
        deletes, prunes or rewrites anything in the directory; raises when
        it holds no step."""
        if self.checkpointer is None:
            raise ValueError("restore_for_inference requires a checkpointer")
        state, _ = self.init_state(objective, with_optimizer=False)
        if self.checkpointer.maybe_restore(state, resume_step) is None:
            raise ValueError(f"no checkpoint found in {self.checkpointer.directory}")
        state.model.eval()
        self.state = state
        return state

    def validate_from_checkpoint(
        self, objective, datamodule, resume_step: int | None = None
    ) -> dict[str, float]:
        """Restore the newest (or given) checkpoint and run validation over
        `limit_val_batches` batches (the `validate` command)."""
        datamodule.setup()
        self.restore_for_inference(objective, resume_step)
        val_loss = self._val_loss(objective, datamodule, self.config.limit_val_batches)
        if val_loss is None:
            raise ValueError("datamodule produced no validation batches")
        result = {"val_loss": val_loss}
        logger.info("validate: %s", result)
        return result

    def validate(self, objective, datamodule, state: TrainState) -> dict[str, float]:
        """Validation of `state`'s model over every validation batch."""
        datamodule.setup()
        objective.bind(state.model)
        val_loss = self._val_loss(objective, datamodule, None)
        if val_loss is None:
            raise ValueError(
                "datamodule produced no validation batches "
                "(set validation_split or provide a val dataset)"
            )
        return {"val_loss": val_loss}
