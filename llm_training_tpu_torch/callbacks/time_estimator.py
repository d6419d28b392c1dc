"""Training time + MFU estimator.

Counterpart of `llm_training_tpu/callbacks/time_estimator.py`: an N-step
timed window (after `skip_first_n_steps` of warm-up) extrapolated to the
run's total time, tokens/s(/device) and MFU against the card's peak dense
bf16 FLOP/s, with JAX's FLOP model unchanged (`transformer_step_flops`:
6·N·T, N every parameter, plus 12·L·H·S·T for attention over the full
sequence S).

That model and `chip_smoke.py`'s MFU count different work, so their MFUs
differ on the same run: the smoke leaves the input embedding table out of
N (a lookup, no product) and counts attention by the (q, k) pairs a packed
row's masks leave visible (12·D per pair per head per layer), where
`12·L·H·S` per token counts every pair of the full row.

The peak comes from a table of NVIDIA cards keyed by
`torch.cuda.get_device_name`; a card not in it (or a fit on the CPU) gives
no MFU, as JAX's gives none for an unknown TPU. JAX's `mfu_xla`
cross-check reads XLA's FLOP count of the compiled step, which eager
PyTorch does not have.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass

import torch

logger = logging.getLogger(__name__)

# peak dense bf16 tensor-core FLOP/s per card by name substring (lowercase),
# from NVIDIA's datasheets; the first match wins
_PEAK_FLOPS = (
    ("h100 pcie", 756e12),
    ("h100 nvl", 835e12),
    ("h100", 989e12),  # H100 SXM5 ("NVIDIA H100 80GB HBM3" by its device name)
    ("h200", 989e12),
    ("a100", 312e12),
)


def peak_flops_per_device(device: torch.device | str | None = None) -> float | None:
    """The peak of `device`'s card (the current CUDA card by default); None
    off CUDA or for a card not in the table."""
    if device is not None and torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(device).lower()
    for key, flops in _PEAK_FLOPS:
        if key in name:
            return flops
    return None


def transformer_step_flops(
    num_params: int,
    tokens_per_step: int,
    num_layers: int | None = None,
    hidden_size: int | None = None,
    seq_len: int | None = None,
) -> float:
    """FLOPs for one fwd+bwd step: 6·N·T plus the attention quadratic term
    12·L·S·H·T when the shape is known (PaLM appendix B convention)."""
    flops = 6.0 * num_params * tokens_per_step
    if num_layers and hidden_size and seq_len:
        flops += 12.0 * num_layers * hidden_size * seq_len * tokens_per_step
    return flops


@dataclass
class TrainingTimeEstimatorConfig:
    # measure steps [skip_first_n_steps, skip_first_n_steps + num_steps)
    num_steps: int = 20
    skip_first_n_steps: int = 2  # warm-up (the kernels' build, the first step) excluded
    stop_after_steps: int | None = None  # dry run: end the fit afterwards

    def __post_init__(self):
        if self.num_steps < 1 or self.skip_first_n_steps < 0:
            raise ValueError(f"num_steps must be >= 1 and skip_first_n_steps >= 0: {self}")
        if self.stop_after_steps is not None and self.stop_after_steps < 1:
            raise ValueError(f"stop_after_steps must be >= 1, got {self.stop_after_steps}")


class TrainingTimeEstimator:
    """Reports steps/sec, tokens/sec(/device), MFU, and extrapolated total
    training time once the measurement window closes (`result`, and the
    `perf/*` gauges of the trainer's registry)."""

    def __init__(self, config: TrainingTimeEstimatorConfig | None = None):
        self.config = config or TrainingTimeEstimatorConfig()
        self._t0 = None
        self._start_step = None
        self._start_tokens = 0
        self._num_params = None
        self._flops_hint: dict = {}
        self.result: dict | None = None

    def on_fit_start(self, trainer, objective, datamodule, start_step) -> None:
        self._fit_start_step = start_step
        model_cfg = getattr(getattr(objective, "model", None), "config", None)
        if model_cfg is not None:
            self._flops_hint = dict(
                num_layers=getattr(model_cfg, "num_hidden_layers", None),
                hidden_size=getattr(model_cfg, "hidden_size", None),
            )

    def _maybe_count_params(self, trainer) -> None:
        state = getattr(trainer, "state", None)
        if self._num_params is None and state is not None:
            self._num_params = sum(p.numel() for p in state.model.parameters())

    def on_train_step(self, trainer, step) -> None:
        cfg = self.config
        begin = self._fit_start_step + cfg.skip_first_n_steps
        if step >= begin and self._t0 is None:
            # drain the launch queue: without this, perf_counter timestamps
            # measure launch rate, not device step time
            self._sync(trainer)
            self._t0 = time.perf_counter()
            self._start_step = step
            self._start_tokens = trainer.counters["consumed_tokens"]
        if self._t0 is not None and self.result is None and step - self._start_step >= cfg.num_steps:
            self._finish(trainer, step)
        if cfg.stop_after_steps and step - self._fit_start_step >= cfg.stop_after_steps:
            trainer.should_stop = True

    @staticmethod
    def _sync(trainer) -> None:
        device = getattr(trainer, "device", None)
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)

    def _finish(self, trainer, step) -> None:
        self._maybe_count_params(trainer)
        self._sync(trainer)
        elapsed = time.perf_counter() - self._t0
        steps = step - self._start_step
        tokens = trainer.counters["consumed_tokens"] - self._start_tokens
        n_dev = 1  # the port's fit runs on one card
        steps_per_sec = steps / elapsed
        tokens_per_sec = tokens / elapsed
        result = {
            "measured_steps": steps,
            "steps_per_sec": steps_per_sec,
            "tokens_per_sec": tokens_per_sec,
            "tokens_per_sec_per_device": tokens_per_sec / n_dev,
            "estimated_total_hours": trainer.config.max_steps / steps_per_sec / 3600.0,
        }
        peak = peak_flops_per_device(getattr(trainer, "device", None))
        if self._num_params and peak:
            step_flops = transformer_step_flops(
                self._num_params,
                int(tokens / steps),
                seq_len=getattr(trainer, "last_seq_len", None),
                **self._flops_hint,
            )
            result["model_flops_per_step"] = step_flops
            result["mfu"] = step_flops * steps_per_sec / (peak * n_dev)
        telemetry = getattr(trainer, "telemetry", None)
        if telemetry is not None:
            # the log-step metrics merge carries them to telemetry.jsonl
            for key, value in result.items():
                if isinstance(value, (int, float)):
                    telemetry.gauge(f"perf/{key}").set(float(value))
        self.result = result
        logger.info(
            "training time estimate: %s",
            {k: (round(v, 4) if isinstance(v, float) else v) for k, v in result.items()},
        )

    def on_fit_end(self, trainer, state) -> None:
        # short runs: close the window with whatever was measured
        if (
            self.result is None
            and self._t0 is not None
            and trainer.last_step is not None
            and trainer.last_step > self._start_step
        ):
            self._finish(trainer, trainer.last_step)
