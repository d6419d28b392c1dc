"""Verifiable rewards for on-policy RL.

Counterpart of `llm_training_tpu/rl/reward.py`. A reward function is any
callable `(prompt_tokens, completion_tokens) -> float`: host logic over
token lists, run between engine steps. Built-ins, each computed from the
sample itself:

- `copy_digit`     — the fraction of completion tokens equal to the
  prompt's last token (the copy-the-digit smoke task);
- `regex`          — 1.0 when the completion's text rendering matches
  `LLMT_RL_REWARD_PATTERN` (`re.search`), else 0.0;
- `numeric_answer` — 1.0 when `LLMT_RL_REWARD_ANSWER` appears in the
  completion's text rendering, else 0.0;
- `length`         — 1 - |len(completion) - target| / target, clipped to
  [0, 1], target from `LLMT_RL_REWARD_TARGET_LEN`.

Text rewards render tokens as space-separated decimal ids unless a
`detokenize` is passed. Selection is by name or `LLMT_RL_REWARD` (default
`copy_digit`).
"""

from __future__ import annotations

import os
import re
from typing import Callable, Sequence

RewardFn = Callable[[Sequence[int], Sequence[int]], float]

REWARD_ENV = "LLMT_RL_REWARD"
PATTERN_ENV = "LLMT_RL_REWARD_PATTERN"
ANSWER_ENV = "LLMT_RL_REWARD_ANSWER"
TARGET_LEN_ENV = "LLMT_RL_REWARD_TARGET_LEN"


def _render(tokens: Sequence[int], detokenize) -> str:
    if detokenize is not None:
        return detokenize(list(tokens))
    return " ".join(str(int(t)) for t in tokens)


def copy_digit_reward() -> RewardFn:
    """Fraction of completion tokens equal to the prompt's LAST token —
    dense (every matching token moves the score), so a few policy-gradient
    rounds on a tiny model measurably improve it."""

    def reward(prompt: Sequence[int], completion: Sequence[int]) -> float:
        if not prompt or not completion:
            return 0.0
        target = int(prompt[-1])
        return sum(1 for t in completion if int(t) == target) / len(completion)

    return reward


def regex_reward(pattern: str | None = None, detokenize=None) -> RewardFn:
    """1.0 when the rendered completion matches `pattern` (re.search)."""
    if pattern is None:
        pattern = os.environ.get(PATTERN_ENV)
    if not pattern:
        raise ValueError(
            f"regex reward needs a pattern (arg or {PATTERN_ENV})"
        )
    compiled = re.compile(pattern)

    def reward(prompt: Sequence[int], completion: Sequence[int]) -> float:
        return 1.0 if compiled.search(_render(completion, detokenize)) else 0.0

    return reward


def numeric_answer_reward(answer: str | None = None, detokenize=None) -> RewardFn:
    """1.0 when the expected answer's digit string appears in the rendered
    completion — the exact-match half of a math-style verifiable task."""
    if answer is None:
        answer = os.environ.get(ANSWER_ENV)
    if answer is None or str(answer).strip() == "":
        raise ValueError(
            f"numeric_answer reward needs an answer (arg or {ANSWER_ENV})"
        )
    needle = str(answer).strip()

    def reward(prompt: Sequence[int], completion: Sequence[int]) -> float:
        return 1.0 if needle in _render(completion, detokenize) else 0.0

    return reward


def length_reward(target_len: int | None = None) -> RewardFn:
    """1 - |len - target| / target, clipped to [0, 1]: full marks at the
    target length, linearly less on either side."""
    if target_len is None:
        raw = os.environ.get(TARGET_LEN_ENV)
        if raw is None:
            raise ValueError(
                f"length reward needs a target (arg or {TARGET_LEN_ENV})"
            )
        target_len = int(raw)
    if target_len < 1:
        raise ValueError(f"length reward target must be >= 1, got {target_len}")

    def reward(prompt: Sequence[int], completion: Sequence[int]) -> float:
        return max(0.0, 1.0 - abs(len(completion) - target_len) / target_len)

    return reward


_BUILTIN_FACTORIES = {
    "copy_digit": copy_digit_reward,
    "regex": regex_reward,
    "numeric_answer": numeric_answer_reward,
    "length": length_reward,
}


def resolve_reward(name: str | None = None, **kwargs) -> RewardFn:
    """Reward by name, or by `LLMT_RL_REWARD` (default `copy_digit`).
    kwargs forward to the factory (pattern=/answer=/target_len=/
    detokenize= — env fallbacks apply when omitted)."""
    if name is None:
        name = os.environ.get(REWARD_ENV, "copy_digit")
    factory = _BUILTIN_FACTORIES.get(name)
    if factory is None:
        raise ValueError(
            f"unknown reward {name!r}; built-ins: "
            f"{sorted(_BUILTIN_FACTORIES)}"
        )
    return factory(**kwargs)
