"""Training state.

Counterpart of `llm_training_tpu/trainer/state.py` (`TrainState`): the JAX
pytree of step, params, optimizer state and rng becomes the live model,
the optimizer that owns its state, the micro-step count and the key that
objectives draw training noise from (NEFTune; `prng.py`).

`state_dict()` flattens all four into named tensors for the checkpointer:
`step`, `rng` (the key's raw data, two 32-bit words, as the JAX
checkpointer's `_pack` ships `jax.random.key_data`), `model.<parameter>`
and `optimizer.<...>` (`Optimizer.state_dict`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from llm_training_tpu_torch import prng
from llm_training_tpu_torch.optim.builder import Optimizer


@dataclass
class TrainState:
    """`step` counts micro-steps (train-step calls); the optimizer's
    `count` counts its updates (optimizer steps). Micro-step n draws under
    `fold_in(rng, n)`, as the JAX train step does. `optimizer` is None in
    a state restored read-only for inference."""

    step: int
    model: torch.nn.Module
    optimizer: Optimizer | None
    rng: prng.Key

    def state_dict(self) -> dict[str, torch.Tensor]:
        """Named tensors of the whole state. Model and optimizer entries are
        the live tensors (not copies), so loading into this dict in place
        restores them; `step` and `rng` are fresh tensors that
        `load_state_dict` reads back."""
        out = {
            "step": torch.tensor(self.step, dtype=torch.int64),
            "rng": torch.tensor(self.rng, dtype=torch.int64),
        }
        out.update({f"model.{k}": v for k, v in self.model.state_dict().items()})
        if self.optimizer is not None:
            out.update({f"optimizer.{k}": v for k, v in self.optimizer.state_dict().items()})
        return out

    @torch.no_grad()
    def load_state_dict(self, state: dict[str, torch.Tensor]) -> None:
        """Take `state_dict()`'s entries back: the step, the key, the
        model's parameters and (when this state has one) the optimizer's
        state. Raises KeyError on missing or unexpected keys."""
        model = {k.removeprefix("model."): v for k, v in state.items() if k.startswith("model.")}
        optim = {k.removeprefix("optimizer."): v for k, v in state.items()
                 if k.startswith("optimizer.")}
        unexpected = set(state) - {"step", "rng"} - {f"model.{k}" for k in model} - {
            f"optimizer.{k}" for k in optim}
        if unexpected or "step" not in state or "rng" not in state:
            raise KeyError(f"train state keys: unexpected {sorted(unexpected)}; "
                           "'step' and 'rng' are required")
        self.step = int(state["step"])
        self.rng = tuple(int(word) for word in state["rng"])
        self.model.load_state_dict(model, strict=True)
        if self.optimizer is not None:
            self.optimizer.load_state_dict(optim)
