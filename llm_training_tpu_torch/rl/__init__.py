"""On-policy RL post-training: the generate -> score -> update loop over
the serving engine (counterpart of `llm_training_tpu/rl`).

- `rl.rollout` — `RolloutCollector`: prompt groups through the
  `ServingEngine` as a priority class of their own, behavior logprobs
  collected in-stream, every sample tagged with the weights generation it
  was decoded under (stale samples are dropped, never trained on);
- `rl.reward`  — verifiable rewards, selectable by name or environment;
- `rl.sync`    — trainer -> engine weight sync, `fused` (the engine holds
  the policy's own tensors) or `host` (through host memory);
- `rl.loop`    — the GRPO round loop behind the `rl-fit` command
  (`lms/grpo.py` is the objective).
"""

from llm_training_tpu_torch.rl.reward import resolve_reward
from llm_training_tpu_torch.rl.rollout import Rollout, RolloutCollector
from llm_training_tpu_torch.rl.sync import sync_weights

__all__ = [
    "Rollout",
    "RolloutCollector",
    "resolve_reward",
    "sync_weights",
]
