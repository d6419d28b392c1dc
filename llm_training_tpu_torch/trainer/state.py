"""Training state.

Counterpart of `llm_training_tpu/trainer/state.py` (`TrainState`): the JAX
pytree of step, params, optimizer state and rng becomes the live model,
the optimizer that owns its state, the micro-step count and the generator
that objectives draw training noise from (NEFTune).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from llm_training_tpu_torch.optim.builder import Optimizer


@dataclass
class TrainState:
    """`step` counts micro-steps (train-step calls); the optimizer's
    `count` counts its updates (optimizer steps)."""

    step: int
    model: torch.nn.Module
    optimizer: Optimizer
    generator: torch.Generator
