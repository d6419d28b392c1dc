"""Exponential-backoff retry for transient I/O.

Counterpart of `llm_training_tpu/resilience/retry.py` (a dataclass where
JAX's policy is a pydantic model). Remote storage (fuse mounts, NFS
scratch, object stores) throws transient `OSError`s under load; every
durable-I/O call site opts in explicitly via `retry_call` -- in the port
the prefetcher's data-source pulls and the checkpointer's save and
restore. The policy is deliberately conservative: only exception types
listed in `TRANSIENT_EXCEPTIONS` (plus anything the caller adds) are
retried — a programming error must surface on the first throw.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Any, Callable

logger = logging.getLogger(__name__)

# ConnectionError / TimeoutError / InterruptedError are OSError subclasses;
# chaos-injected faults (resilience.chaos.ChaosError) subclass OSError too,
# so the injection exercises exactly the production retry path.
TRANSIENT_EXCEPTIONS: tuple[type[BaseException], ...] = (OSError,)


@dataclass
class RetryPolicy:
    # additional attempts after the first failure; 0 = fail fast
    max_retries: int = 0
    backoff_base_s: float = 0.5
    backoff_factor: float = 2.0
    backoff_max_s: float = 30.0

    def __post_init__(self):
        if self.max_retries < 0 or self.backoff_base_s < 0 or self.backoff_max_s < 0:
            raise ValueError(f"retry policy values must be >= 0: {self}")
        if self.backoff_factor < 1:
            raise ValueError(f"backoff_factor must be >= 1, got {self.backoff_factor}")

    def delay_s(self, attempt: int) -> float:
        """Backoff before retry number `attempt` (0-indexed)."""
        return min(self.backoff_base_s * self.backoff_factor**attempt, self.backoff_max_s)


def is_transient(
    exc: BaseException,
    extra: tuple[type[BaseException], ...] = (),
) -> bool:
    return isinstance(exc, TRANSIENT_EXCEPTIONS + tuple(extra))


def retry_call(
    fn: Callable[[int], Any],
    policy: RetryPolicy,
    *,
    label: str = "operation",
    counter: Any | None = None,
    sleep: Callable[[float], None] = time.sleep,
    transient: Callable[[BaseException], bool] = is_transient,
) -> Any:
    """Call `fn(attempt)` with up to `policy.max_retries` retries on
    transient errors. `fn` receives the attempt index (0 on the first try)
    so call sites can escalate — e.g. the checkpointer forces an overwrite
    on retries in case the failed attempt left a partial step dir. Each
    retry increments `counter` (a telemetry Counter) when given."""
    attempt = 0
    while True:
        try:
            return fn(attempt)
        except Exception as e:
            if attempt >= policy.max_retries or not transient(e):
                raise
            delay = policy.delay_s(attempt)
            logger.warning(
                "transient error in %s (attempt %d/%d): %s — retrying in %.2fs",
                label, attempt + 1, policy.max_retries, e, delay,
            )
            if counter is not None:
                counter.inc()
            if delay > 0:
                sleep(delay)
            attempt += 1
